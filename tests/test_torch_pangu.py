"""The port's Pangu-Weather against the JAX package's, on JAX weights.

Inputs come from numpy seeds and go to both sides; JAX parameters reach
the port through `weights.load_flax_params`, every leaf used.  The JAX side
takes its einsum route (its CPU default); the port runs each of its four
routes on the CPU: einsum (None), token-major ("packed"), 5D ("packed5d")
and flash (True), the last three through their kernels' plain versions and
autograd Functions.

Tolerances, fp32: rollout atol 1e-4 and rtol 1e-4 over two closed-loop
steps of 16 blocks (other summation orders; flax's LayerNorm takes the
variance as E[x^2] - E[x]^2, torch in two passes); the loss rtol 1e-5;
every gradient, in the JAX layout, max|diff| <= 1e-4 x max|grad| of its
tensor (rounding grows with depth, and a tensor's small entries carry its
largest entry's absolute error).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_ref as jax_ref
from dlwpbench_tpu.models import pangu as jpangu
from dlwpbench_tpu_torch import weights
from dlwpbench_tpu_torch.models import pangu as tpangu

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = 1e-4

SMALL = dict(constant_channels=2, prescribed_channels=1, prognostic_channels=2, embed_dim=16,
             num_heads=(1, 2, 2, 1), patch_size=(1, 1), n_lat=8, n_lon=16)
ODD = dict(SMALL, patch_size=(2, 2), n_lat=7, n_lon=13)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the ops here are small, and the
    suite's workers share the cores (each extra thread only waits on the
    others)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, seed, B=2, T=3):
    rng = np.random.default_rng(seed)
    H, W = cfg["n_lat"], cfg["n_lon"]
    const = rng.standard_normal((B, 1, cfg["constant_channels"], H, W)).astype(np.float32)
    pres = rng.standard_normal((B, T, cfg["prescribed_channels"], H, W)).astype(np.float32)
    prog = rng.standard_normal((B, T, cfg["prognostic_channels"], H, W)).astype(np.float32)
    target = rng.standard_normal((B, T - 1, cfg["prognostic_channels"], H, W)).astype(np.float32)
    return const, pres, prog, target


@functools.lru_cache(maxsize=None)
def _jax_reference(name):
    """(params, batch, rollout, loss, flat grads) of the JAX model."""
    cfg = {"small": SMALL, "odd": ODD}[name]
    const, pres, prog, target = _batch(cfg, seed=len(name))
    model = jpangu.PanguWeather(**cfg)
    params = jax_ref.init(model, jax.random.PRNGKey(7), const, pres, prog)

    def loss_fn(p):
        out = model.apply(p, const, pres, prog)
        return jnp.mean((out - target) ** 2), out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    out = np.asarray(out)
    return (_np_tree(params), (const, pres, prog, target), out, float(loss),
            weights.flatten_tree(_np_tree(grads["params"])))


# ---------------------------------------------------------------- numpy helpers
@pytest.mark.parametrize("win", [(2, 6, 12), (2, 3, 4), (1, 2, 3)])
def test_earth_position_index_matches_jax(win):
    np.testing.assert_array_equal(tpangu.earth_position_index(win),
                                  jpangu.earth_position_index(win))


@pytest.mark.parametrize("res, win", [((1, 32, 64), (2, 6, 12)), ((1, 16, 32), (2, 6, 12)),
                                      ((1, 4, 7), (2, 6, 12)), ((3, 9, 10), (2, 3, 4))])
def test_pad_amounts_and_shift_masks_match_jax(res, win):
    pads = tpangu._pad3d_amounts(res, win)
    assert pads == jpangu._pad3d_amounts(res, win)
    pad_res = tuple(r + lo + hi for r, (lo, hi) in zip(res, pads))
    shift = tuple(w // 2 for w in win)
    np.testing.assert_array_equal(tpangu.shift_window_groups_3d(pad_res, win, shift),
                                  jpangu.shift_window_groups_3d(pad_res, win, shift))
    np.testing.assert_array_equal(tpangu.shift_window_mask(pad_res, win, shift),
                                  jpangu.shift_window_mask(pad_res, win, shift))


def test_window_partition_roundtrip_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 2, 6, 24, 5)).astype(np.float32)
    win = (2, 3, 12)
    want = np.asarray(jpangu.window_partition_3d(jnp.asarray(x), win))
    got = tpangu.window_partition_3d(torch.from_numpy(x), win)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpangu.window_reverse_3d(got, win, 2, 6, 24).numpy(), x)


def test_expand_earth_bias_matches_jax():
    win = (2, 3, 4)
    table = np.random.default_rng(1).standard_normal((4 * 9 * 7, 3, 2)).astype(np.float32)
    want = np.asarray(jpangu.expand_earth_bias(jnp.asarray(table), win))
    got = tpangu.expand_earth_bias(torch.from_numpy(table), win).numpy()
    assert got.shape == (3, 2, 24, 24)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- the model
def _check_grads(model, want):
    got = weights.flatten_tree(weights.to_flax_tree(
        model, {n: p.grad for n, p in model.named_parameters()}))
    assert set(got) == set(want)
    for path, g in got.items():
        w = np.asarray(want[path])
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max())
        assert np.abs(g - w).max() <= GRAD_TOL * max(scale, 1e-6), (
            path, float(np.abs(g - w).max()), scale)


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
@pytest.mark.parametrize("route", [None, "packed", "packed5d", True],
                         ids=["einsum", "token-major", "5d", "flash"])
def test_pangu_matches_jax(route, remat):
    params, (const, pres, prog, target), want, j_loss, j_grads = _jax_reference("small")
    model = tpangu.PanguWeather(**SMALL, use_flash_attention=route, remat=remat)
    weights.load_flax_params(model, params)  # strict: every leaf, every parameter
    args = [torch.from_numpy(a) for a in (const, pres, prog)]
    with torch.no_grad():
        np.testing.assert_allclose(model(*args).numpy(), want, **TOL)
    out = model(*args)
    loss = torch.mean((out - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-5)
    _check_grads(model, j_grads)


@pytest.mark.parametrize("route", [None, "packed5d"], ids=["einsum", "5d"])
def test_pangu_odd_grid_matches_jax(route):
    """7x13 with patch (2, 2): the patch-embed pad, UpSample's crop and the
    center crop after the ConvTranspose all cut something."""
    params, (const, pres, prog, target), want, j_loss, j_grads = _jax_reference("odd")
    model = tpangu.PanguWeather(**ODD, use_flash_attention=route)
    weights.load_flax_params(model, params)
    out = model(*(torch.from_numpy(a) for a in (const, pres, prog)))
    assert out.shape == want.shape == (2, 2, 2, 7, 13)
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    torch.mean((out - torch.from_numpy(target)) ** 2).backward()
    _check_grads(model, j_grads)


def test_block_builds_the_mask_in_the_activation_dtype():
    blk = tpangu.EarthSpecificBlock(16, (1, 8, 16), 2, (2, 3, 4), shift=True,
                                    use_flash="packed5d").to(torch.bfloat16)
    seen = []
    real = blk.EarthAttention3D_0.forward
    blk.EarthAttention3D_0.forward = lambda x, b, m: seen.append(m.dtype) or real(x, b, m)
    bias = torch.zeros(3, 2, 24, 24, dtype=torch.bfloat16)  # padded field (2, 9, 16)
    out = blk(torch.randn(2, 128, 16, dtype=torch.bfloat16), bias)
    assert seen == [torch.bfloat16] and out.dtype == torch.bfloat16


def test_routes_on_the_cpu_under_auto_are_einsum(monkeypatch):
    """Auto never reaches the kernels' wrappers for CPU tensors, as JAX on
    the CPU takes its einsum route."""
    from dlwpbench_tpu_torch.models import pangu as mod

    def boom(*a, **k):
        raise AssertionError("kernel route taken on the CPU under auto")

    monkeypatch.setattr(mod, "window_attention_qkv", boom)
    monkeypatch.setattr(mod, "window_attention_qkv5d", boom)
    monkeypatch.setattr(mod, "flash_window_attention", boom)
    model = tpangu.PanguWeather(**SMALL)
    const, pres, prog, _ = _batch(SMALL, seed=3)
    with torch.no_grad():
        model(*(torch.from_numpy(a) for a in (const, pres, prog)))


def test_registry_builds_the_shipped_config():
    from dlwpbench_tpu_torch import train
    from dlwpbench_tpu_torch.models import registry
    from dlwpbench_tpu_torch.training.config import load_config

    cfg = load_config(train.CONFIG_DIR, overrides=["model=panguweather", "data=synthetic"])
    model = registry.build_model({**cfg.model, "remat": True}, seed=1)
    assert isinstance(model, tpangu.PanguWeather) and model.remat is True
    assert model.embed_dim == 192 and model.window_size == (2, 6, 12)
    assert model.patch_size == (1, 1) and (model.n_lat, model.n_lon) == (32, 64)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes["earth_position_bias_table_0"] == (4 * 36 * 23, 6, 6)
    assert shapes["earth_position_bias_table_2"] == (4 * 36 * 23, 3, 12)
    assert len(shapes) == 219 and sum(p.numel() for p in model.parameters()) > 25e6


def test_out_of_scope_options_raise():
    # a device mesh is in scope (ring attention, `tests/test_torch_ring_attention.py`):
    # every block's attention gets it
    mesh = object()
    model = tpangu.PanguWeather(**SMALL, spmd_mesh=mesh, dist_axis="h")
    for b in range(model.n_blocks):
        attn = getattr(model, f"EarthSpecificBlock_{b}").EarthAttention3D_0
        assert attn.spmd_mesh is mesh and attn.dist_axis == "h"
    with pytest.raises(ValueError, match="use_flash_attention"):
        tpangu.PanguWeather(**SMALL, use_flash_attention="ring")
