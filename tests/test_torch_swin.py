"""The port's Swin Transformer against the JAX package's, on JAX weights.

Inputs come from numpy seeds and go to both sides; JAX parameters reach
the port through `weights.load_flax_params`.  The JAX side takes the flash
route (`use_flash_attention=True`), whose Pallas kernel runs in interpret
mode on the CPU; the port's wrapper takes its plain version on CPU tensors.

Tolerance: fp32, atol 1e-4 and rtol 1e-4 over two closed-loop steps.  The
two sides sum in other orders (online versus two-pass softmax), and flax's
LayerNorm takes the variance as E[x^2] - E[x]^2 where torch takes it in
two passes.  Gradients are compared in the JAX layout (`to_flax_tree`),
per tensor, as max|diff| <= GRAD_TOL * max|grad of that tensor| (fp32
backward through two closed-loop steps of four blocks: rounding grows
with depth, and a tensor's small entries carry its largest entry's
absolute error).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_ref as jax_ref
from dlwpbench_tpu.models import swin as jswin
from dlwpbench_tpu_torch import weights
from dlwpbench_tpu_torch.models import swin as tswin

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the models here are small, and
    the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("wh, ww", [(8, 16), (4, 8), (3, 5), (12, 20)])
def test_expand_relative_bias_matches_jax(wh, ww):
    table = np.random.default_rng(wh * ww).standard_normal(
        ((2 * wh - 1) * (2 * ww - 1), 3)
    ).astype(np.float32)
    want = np.asarray(jswin.expand_relative_bias(jnp.asarray(table), wh, ww))
    got = tswin.expand_relative_bias(torch.from_numpy(table), wh, ww).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "geom", [(8, 16, 8, 16, 4, 8), (12, 20, 12, 20, 6, 10), (8, 16, 4, 8, 2, 4),
             (8, 16, 8, 16, 0, 0)],
)
def test_shift_window_groups_matches_jax(geom):
    np.testing.assert_array_equal(
        tswin.shift_window_groups(*geom), jswin.shift_window_groups(*geom)
    )


def test_window_partition_roundtrip_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 5)).astype(np.float32)
    want = np.asarray(jswin.window_partition(jnp.asarray(x), 4, 6))
    got = tswin.window_partition(torch.from_numpy(x), 4, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tswin.window_reverse(got, 4, 6, 8, 12).numpy()
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("shift", [(0, 0), (4, 8)])
def test_swin_block_matches_jax(shift):
    B, H, W, C, nh = 2, 8, 16, 16, 2
    N = H * W
    rng = np.random.default_rng(sum(shift))
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    table = 0.02 * rng.standard_normal(((2 * H - 1) * (2 * W - 1), nh)).astype(np.float32)
    rel = np.array(jswin.expand_relative_bias(jnp.asarray(table), H, W))
    if shift != (0, 0):
        mask = jswin.shift_attn_mask(H, W, H, W, *shift)  # [1, N, N]
        bias = rel[None] + mask[:, None]
    else:
        bias = rel
    jblk = jswin.SwinBlock(C, nh, (H, W), shift, use_flash=True)
    params = jblk.init(jax.random.PRNGKey(1), jnp.asarray(x), H, W, jnp.asarray(bias))
    want = np.asarray(jblk.apply(params, jnp.asarray(x), H, W, jnp.asarray(bias)))

    tblk = tswin.SwinBlock(C, nh, (H, W), shift, use_flash=True)
    weights.load_flax_params(tblk, _np_tree(params))
    with torch.no_grad():
        got = tblk(torch.from_numpy(x), H, W, torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("H, W", [(8, 16), (12, 20)])
def test_swin_rollout_matches_jax(H, W):
    B, T, Cc, Cp, Cq = 2, 3, 2, 1, 3
    cfg = dict(img_height=H, img_width=W, constant_channels=Cc, prescribed_channels=Cp,
               prognostic_channels=Cq, embed_dim=16, depths=(2, 2), num_heads=(2, 2),
               use_flash_attention=True)
    rng = np.random.default_rng(H * W)
    const = rng.standard_normal((B, 1, Cc, H, W)).astype(np.float32)
    pres = rng.standard_normal((B, T, Cp, H, W)).astype(np.float32)
    prog = rng.standard_normal((B, T, Cq, H, W)).astype(np.float32)

    jmodel = jswin.SwinTransformer(**cfg)
    params = jax_ref.init(jmodel, jax.random.PRNGKey(0), const, pres, prog)
    want = np.asarray(jax_ref.apply(jmodel, params, const, pres, prog))

    tmodel = tswin.SwinTransformer(**cfg)
    weights.load_flax_params(tmodel, _np_tree(params))
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, (const, pres, prog))).numpy()
    assert got.shape == want.shape == (B, T - 1, Cq, H, W)
    np.testing.assert_allclose(got, want, **TOL)


def test_weight_loader_is_strict():
    model = tswin.SwinTransformer(img_height=8, img_width=16, embed_dim=8,
                                  depths=(2,), num_heads=(1,))
    with pytest.raises(KeyError, match="no torch module"):
        weights.load_flax_params(model, {"Bogus_0": {"kernel": np.zeros(1)}})
    with pytest.raises(ValueError, match="Conv_1/bias"):
        weights.load_flax_params(model, {"Conv_1": {"bias": np.zeros(5)}})
    with pytest.raises(KeyError, match="without a flax leaf"):
        weights.load_flax_params(model, {"Conv_1": {"bias": np.zeros(1)}})


def test_npz_roundtrip(tmp_path):
    tree = {"A_0": {"Dense_0": {"kernel": np.ones((2, 3), np.float32)}}, "t": np.arange(3.0)}
    weights.save_npz(tmp_path / "w.npz", tree)
    back = weights.load_npz(tmp_path / "w.npz")
    np.testing.assert_array_equal(back["A_0"]["Dense_0"]["kernel"], tree["A_0"]["Dense_0"]["kernel"])
    np.testing.assert_array_equal(back["t"], tree["t"])


SMALL = dict(img_height=8, img_width=16, constant_channels=2, prescribed_channels=1,
             prognostic_channels=3, embed_dim=16, depths=(2, 2), num_heads=(2, 2),
             use_flash_attention=True)


def _small_batch(seed, B=2, T=3):
    rng = np.random.default_rng(seed)
    H, W = SMALL["img_height"], SMALL["img_width"]
    const = rng.standard_normal((B, 1, SMALL["constant_channels"], H, W)).astype(np.float32)
    pres = rng.standard_normal((B, T, SMALL["prescribed_channels"], H, W)).astype(np.float32)
    prog = rng.standard_normal((B, T, SMALL["prognostic_channels"], H, W)).astype(np.float32)
    target = rng.standard_normal((B, T - 1, SMALL["prognostic_channels"], H, W)).astype(np.float32)
    return const, pres, prog, target


def _flat(tree, prefix=""):
    return weights.flatten_tree(tree, prefix)


@pytest.mark.parametrize("remat", [False, True])
def test_swin_loss_and_grads_match_jax(remat):
    """Stage 0 is N 128 (the flash panel route); the loss is the trainer's
    unweighted MSE of the 2-step rollout."""
    const, pres, prog, target = _small_batch(5)
    jmodel = jswin.SwinTransformer(**SMALL, remat=remat)
    params = jax_ref.init(jmodel, jax.random.PRNGKey(3), const, pres, prog)

    def loss_fn(p):
        return jnp.mean((jmodel.apply(p, const, pres, prog) - target) ** 2)

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)

    tmodel = tswin.SwinTransformer(**SMALL, remat=remat)
    assert tmodel.remat is remat
    weights.load_flax_params(tmodel, _np_tree(params))
    out = tmodel(*map(torch.from_numpy, (const, pres, prog)))
    loss = torch.mean((out - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)

    got = _flat(weights.to_flax_tree(
        tmodel, {n: p.grad for n, p in tmodel.named_parameters()}))
    want = _flat(_np_tree(j_grads["params"]))
    assert set(got) == set(want)
    for path, g in got.items():
        w = np.asarray(want[path])
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max())
        assert np.abs(g - w).max() <= GRAD_TOL * max(scale, 1e-6), (
            path, float(np.abs(g - w).max()), scale)


def test_remat_keeps_values_and_grads():
    """Per-step checkpointing recomputes, it does not change the result."""
    const, pres, prog, target = map(torch.from_numpy, _small_batch(6))
    grads = []
    for remat in (False, True):
        model = tswin.SwinTransformer(**SMALL, remat=remat, seed=4)
        loss = torch.mean((model(const, pres, prog) - target) ** 2)
        loss.backward()
        grads.append((loss.item(), [p.grad.clone() for p in model.parameters()]))
    assert grads[0][0] == grads[1][0]
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_registry_keeps_remat():
    from dlwpbench_tpu_torch.models import registry

    cfg = dict(type="SwinTransformer", name="swin", remat=True, **SMALL)
    model = registry.build_model(cfg)
    assert model.remat is True and model.remat_policy == "full"
    assert registry.build_model({**cfg, "remat_policy": "dots"}).remat_policy == "dots"
    with pytest.raises(ValueError, match="remat_policy"):
        registry.build_model({**cfg, "remat_policy": "everything"})


def test_to_flax_tree_inverts_the_loader():
    jmodel = jswin.SwinTransformer(**SMALL)
    const, pres, prog, _ = _small_batch(7)
    params = _np_tree(jax_ref.init(jmodel, jax.random.PRNGKey(1), const, pres, prog))
    tmodel = tswin.SwinTransformer(**SMALL)
    weights.load_flax_params(tmodel, params)
    back = _flat(weights.to_flax_tree(tmodel))
    want = _flat(params["params"])
    assert set(back) == set(want)
    for path, arr in back.items():
        np.testing.assert_array_equal(arr, want[path], err_msg=path)


LOCAL = dict(SMALL, use_flash_attention=None, window_size=(4, 4))


@functools.lru_cache(maxsize=None)
def _local_window_reference():
    """JAX's (params, rollout, loss, gradients) of the LOCAL Swin on batch
    8, once for the three port routes that are held against it."""
    const, pres, prog, target = _small_batch(8)
    jmodel = jswin.SwinTransformer(**LOCAL)
    params = jax_ref.init(jmodel, jax.random.PRNGKey(2), const, pres, prog)

    def loss_fn(p):
        out = jmodel.apply(p, const, pres, prog)
        return jnp.mean((out - target) ** 2), out

    (j_loss, want), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = np.asarray(want)
    return params, want, j_loss, j_grads


@pytest.mark.parametrize("route", [None, "packed", ("packed", None)],
                         ids=["einsum", "token-major", "per-stage"])
def test_local_window_swin_matches_jax(route):
    """Fixed (4, 4) windows at 8x16: 8 windows of N 16 at stage 0 and 2 at
    stage 1, shared bias on unshifted blocks and the folded shift mask on
    shifted ones.  JAX takes its einsum route (its CPU default); the port
    its einsum or token-major route (the kernel's plain version), or one
    per stage."""
    const, pres, prog, target = _small_batch(8)
    params, want, j_loss, j_grads = _local_window_reference()

    tmodel = tswin.SwinTransformer(**{**LOCAL, "use_flash_attention": route})
    assert [(st["wh"], st["ww"]) for st in tmodel.plan] == [(4, 4), (4, 4)]
    weights.load_flax_params(tmodel, _np_tree(params))
    out = tmodel(*map(torch.from_numpy, (const, pres, prog)))
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    loss = torch.mean((out - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    got = _flat(weights.to_flax_tree(tmodel, {n: p.grad for n, p in tmodel.named_parameters()}))
    want_g = _flat(_np_tree(j_grads["params"]))
    assert set(got) == set(want_g)
    for path, g in got.items():
        w = np.asarray(want_g[path])
        scale = float(np.abs(w).max())
        assert np.abs(g - w).max() <= GRAD_TOL * max(scale, 1e-6), (path, scale)


def test_local_windows_clamp_to_the_stage_resolution():
    model = tswin.SwinTransformer(**{**LOCAL, "window_size": (8, 8)})
    assert [(st["wh"], st["ww"], st["shift"]) for st in model.plan] == [
        (8, 8, (4, 4)), (4, 8, (2, 4))]


def test_per_stage_route_reaches_the_token_major_wrapper(monkeypatch):
    calls = []
    real = tswin.window_attention_qkv
    monkeypatch.setattr(tswin, "window_attention_qkv",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    model = tswin.SwinTransformer(**{**LOCAL, "use_flash_attention": (None, "packed")})
    const, pres, prog, _ = _small_batch(9, T=2)
    with torch.no_grad():
        model(*map(torch.from_numpy, (const, pres, prog)))
    # stage 1 only: 2 blocks, [B, 1, nW, N, 3C] with 2 windows of 16 tokens
    assert calls == [torch.Size([2, 1, 2, 16, 96])] * 2


def test_out_of_scope_options_raise():
    with pytest.raises(NotImplementedError, match="not ported"):
        tswin.SwinTransformer(**SMALL, mesh="icosahedral")
    with pytest.raises(ValueError, match="use_flash"):
        tswin.SwinTransformer(**{**SMALL, "use_flash_attention": "ring"})
