"""bf16 compute over fp32 master weights, and the spectral losses, against
the JAX package on the CPU.

The counterpart of `tests/test_trainer.py::TestMixedPrecision` and
`tests/test_bf16_zoo.py` for the port's families (the U-Net, the Swin,
Pangu, the spectral TFNO, FourCastNet and SFNO, and the graph GraphCast
and MeshGraphNet).  From one JAX
init and the same numpy batches, the JAX trainer and the port's take
three steps with `compute_dtype="bfloat16"`.

Tolerances:
- per-step losses, bf16: rtol 2e-3.  bf16 keeps 8 significant bits (a
  rounding is up to 2^-9 = 2e-3 of the value); XLA fuses elementwise
  chains and rounds once per fusion where ATen rounds after every op, so
  the two trainers round at other points.  Measured here: at most 6e-4
  over three steps of the U-Net, the Swin, Pangu and FourCastNet, 1.7e-3
  of TFNO and SFNO, whose chains of Dense layers and GELUs have no
  normalisation between them.  That gap is two independent roundings,
  not a fault of either: JAX's own bf16 losses there leave the fp32
  losses by up to 4.6e-3 (TFNO, step 2) and 4.5e-3 (SFNO, step 3), the
  port's by 3.2e-3 and 3.7e-3 (this file run as a script prints them);
  GraphCast 1.7e-3 and MeshGraphNet 1.8e-3 (JAX's own bf16 leaves fp32
  by 9.8e-3 and 6.4e-3); `test_bf16_layers_err_no_more_than_jax` holds the
  port's bf16 error, layer by layer, to JAX's own (`LAYER_ONLY`: a model
  held that way alone);
- per-layer bf16 error (rms distance from the fp32 forward): the port's
  at most 1.1 x JAX's.  Measured here: at most 1.0014 x on every layer of
  the three spectral families, 1.034 x of GraphCast, 1.0055 x of
  MeshGraphNet.  A spectral transform computed in bf16
  where JAX keeps it in fp32 fails it at the first spectral layer; a
  single extra rounding of a spectrum does not show against the error
  the layer's input already carries;
- the spectral losses, fp32: rtol 1e-5 (an FFT of 16 to 64 points in
  another order).
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlwpbench_tpu.models import build_model as jbuild
from dlwpbench_tpu.training import losses as jlosses
from dlwpbench_tpu.training import trainer as jtr
from dlwpbench_tpu_torch.data.dataset import WindowedWeatherDataset as TDataset
from dlwpbench_tpu_torch import weights
from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.ops import flash_attention as fa
from dlwpbench_tpu_torch.ops import window_attention as wa
from dlwpbench_tpu_torch.training import losses as tlosses
from dlwpbench_tpu_torch.training import trainer as ttr

LOSS_RTOL = 2e-3
LR = 1e-3


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the ops here are small, and the
    suite's workers share the cores (each extra thread only waits on the
    others)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
H, W = 8, 16
BASE = dict(constant_channels=2, prescribed_channels=1, prognostic_channels=2, context_size=1)
FAMILIES = {
    "UNet": dict(type="UNet", hidden_channels=[8, 16]),
    "Swin": dict(type="SwinTransformer", img_height=H, img_width=W, embed_dim=16,
                 depths=[2, 2], num_heads=[2, 2], use_flash_attention=False),
    "Pangu": dict(type="PanguWeather", embed_dim=16, num_heads=[1, 2, 2, 1],
                  window_size=[2, 2, 4], patch_size=[1, 1], n_lat=H, n_lon=W),
    # the spectral families: the transforms in fp32 between bf16 layers
    "TFNO": dict(type="TFNO2DModule", hidden_channels=8, lifting_channels=16,
                 projection_channels=16, n_modes=[3, 4], n_layers=2),
    "FourCastNet": dict(type="FourCastNet", img_height=H, img_width=W, embed_dim=16, depth=2,
                        num_blocks=4),
    "SFNO": dict(type="SFNO2DModule", embed_dim=8, num_layers=2, height=H, width=W),
    # the graph families: gathers and per-node sums in bf16 between bf16
    # MLPs; MeshGraphNet at `meshgraphnet.yaml`'s widths on its Delaunay graph
    "GraphCast": dict(type="GraphCastNet", input_height=H, input_width=W, mesh_level=1,
                      hidden_dim=16, processor_layers=2),
    "MeshGraphNet": dict(type="MeshGraphNet", processor_size=4, hidden_dim_processor=34,
                         hidden_dim_node_encoder=32, hidden_dim_edge_encoder=32,
                         hidden_dim_node_decoder=32, graph_type="delaunay"),
}
# Held layer by layer only: MeshGraphNet's stencil movement (the 8-stencil
# at the shipped widths).  Its three bf16 steps leave JAX's by 3.1e-5,
# 2.6e-3 and 3.9e-3, over LOSS_RTOL, while each side's bf16 loss leaves the
# fp32 one by up to 6.5e-3 (JAX) and 3.0e-3 (the port), and no layer of the
# port's bf16 forward is further from fp32 than JAX's (ratio 1.0055): Adam
# moves every weight by about the learning rate whatever the size of its
# gradient, so a bf16 gradient near 0 that rounds to the other sign on the
# other side moves that weight 2e-3 the other way (measured on a CPU).
LAYER_ONLY = {
    "MeshGraphNet-stencil": dict(FAMILIES["MeshGraphNet"], graph_type="grid_2d_8stencil"),
}


def _arrays(T=40, seed=0):
    rng = np.random.default_rng(seed)
    prog = np.cumsum(0.3 * rng.standard_normal((T, 2, H, W)), axis=0).astype(np.float32)
    return dict(prognostic=prog, prescribed=rng.standard_normal((T, 1, H, W)).astype(np.float32),
                constants=rng.standard_normal((2, H, W)).astype(np.float32),
                sequence_length=3, context_size=1, seed=4)


def _tensors(batch):
    return tuple(None if x is None else torch.as_tensor(x) for x in batch)


def _three_steps(family):
    """Three training steps from one JAX init on the same batches: the
    losses of JAX's bf16 trainer, the port's bf16 one and the port's fp32
    one, and the port's bf16 state."""
    cfg = {**BASE, **FAMILIES[family]}
    batches = list(TDataset(**_arrays()).batches(4))[:3]
    jt = jtr.Trainer(jbuild(dict(cfg)), learning_rate=LR, epochs=5, compute_dtype="bfloat16")
    jstate = jt.init(batches[0])
    init = jax.tree_util.tree_map(np.asarray, jstate.params)
    tt = ttr.Trainer(registry.build_model(dict(cfg), grid_shape=(H, W)), learning_rate=LR,
                     epochs=5, compute_dtype="bfloat16")
    tstate = tt.init(params=init)
    t32 = ttr.Trainer(registry.build_model(dict(cfg), grid_shape=(H, W)), learning_rate=LR,
                      epochs=5)
    s32 = t32.init(params=init)

    params, opt_state = jstate.params, jstate.opt_state
    j_losses, t_losses, f32_losses = [], [], []
    for b in batches:
        params, opt_state, loss = jt._train_step(
            params, opt_state, *(None if x is None else jnp.asarray(x) for x in b),
            jnp.float32(LR), jax.random.PRNGKey(0))
        j_losses.append(float(loss))
        t_losses.append(tt.train_step(tstate, _tensors(b), LR).item())
        f32_losses.append(t32.train_step(s32, _tensors(b), LR).item())
    return j_losses, t_losses, f32_losses, tstate


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_trainer_matches_jax(family):
    j_losses, t_losses, f32_losses, tstate = _three_steps(family)
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    assert t_losses != f32_losses  # the steps ran in bf16
    # the master parameters, their gradients and AdamW's moments stay fp32
    for p in tstate.model.parameters():
        assert isinstance(p, torch.nn.Parameter) and p.dtype == torch.float32
        assert p.grad.dtype == torch.float32
        st = tstate.optimizer.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32


LAYER_ERR_RATIO = 1.1


def _flax_outputs(tree, prefix=""):
    """flax's captured intermediates -> {"A.B": first call's output}."""
    out = {}
    for key, val in tree.items():
        if key == "__call__":
            out[prefix] = np.asarray(val[0], np.float32)
        else:
            out.update(_flax_outputs(val, f"{prefix}.{key}" if prefix else key))
    return out


def _port_outputs(model, x):
    """The port's submodule outputs of one `step`, by module name."""
    outs, hooks = {}, []

    def keep(name):
        def hook(module, args, out):
            if isinstance(out, torch.Tensor):
                outs.setdefault(name, out.detach().float().numpy())
        return hook

    for name, m in model.named_modules():
        if name:
            hooks.append(m.register_forward_hook(keep(name)))
    with torch.no_grad():
        model.step(torch.from_numpy(x).to(next(model.parameters()).dtype), None)
    for h in hooks:
        h.remove()
    return outs


def _layer_errors(family):
    """One bf16 step from the same bf16-exact input on both sides: for each
    submodule output that both capture in one layout, (name, the port's
    rms distance from JAX's fp32 output, JAX's bf16 rms distance)."""
    cfg = {**BASE, **{**FAMILIES, **LAYER_ONLY}[family]}
    const, pres, prog, _ = next(TDataset(**_arrays()).batches(4))
    jm = jbuild(dict(cfg))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in (const, pres, prog)))
    last = lambda a: np.moveaxis(a[:, 0], 1, -1)  # [B, T, C, H, W] -> [B, H, W, C]
    x = np.concatenate([last(const), last(pres), last(prog)], -1)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))

    def jax_outputs(dtype):
        p = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
        _, v = jm.apply(p, jnp.asarray(x, dtype), None, method=type(jm).step,
                        capture_intermediates=True, mutable=["intermediates"])
        return _flax_outputs(v["intermediates"])

    j32, j16 = jax_outputs(jnp.float32), jax_outputs(jnp.bfloat16)
    tmodel = registry.build_model(dict(cfg), grid_shape=(H, W))
    weights.load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    t16 = _port_outputs(tmodel.to(torch.bfloat16), x)
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))
    # skipped: a layout that differs (FourCastNet's patch conv) or no flax module
    return [(name, rms(t - j32[name]), rms(j16[name] - j32[name])) for name, t in t16.items()
            if name in j16 and t.shape == j16[name].shape]


@pytest.mark.parametrize("family", ["TFNO", "FourCastNet", "SFNO", "GraphCast", "MeshGraphNet",
                                    "MeshGraphNet-stencil"])
def test_bf16_layers_err_no_more_than_jax(family):
    """Every submodule's bf16 output lies no further from the fp32 forward
    than JAX's bf16 output of that submodule does (the rms distances,
    within `LAYER_ERR_RATIO`)."""
    errors = _layer_errors(family)
    assert len(errors) >= 8
    for name, port, ref in errors:
        assert port <= LAYER_ERR_RATIO * ref, name


class _DtypeSpy:
    """Wraps a kernel wrapper and records the dtypes of the tensors at the
    given argument positions of every call."""

    def __init__(self, fn, positions):
        self.fn, self.positions, self.calls = fn, positions, []

    def __call__(self, *args):
        self.calls.append({args[i].dtype for i in self.positions if args[i] is not None})
        return self.fn(*args)


SPIED = {  # wrapper -> positions of q / qkv, k, v, bias, mask and dO (not lse or drow)
    (fa, "flash_window_attention_fwd"): (0, 1, 2, 3),
    (fa, "flash_window_attention_bwd"): (0, 1, 2, 3, 4, 6),
    (wa, "window_attention_qkv_fwd"): (0, 1, 2),
    (wa, "window_attention_qkv_bwd"): (0, 1, 2, 3, 5),
    (wa, "window_attention_qkv5d_fwd"): (0, 1, 2),
    (wa, "window_attention_qkv5d_bwd"): (0, 1, 2, 3, 5),
}
ROUTES = [("UNet", None), ("Swin", False), ("Swin", True), ("Swin", "packed"),
          ("Pangu", False), ("Pangu", True), ("Pangu", "packed"), ("Pangu", "packed5d")]


@pytest.mark.parametrize("family, route", ROUTES, ids=[f"{f}-{r}" for f, r in ROUTES])
def test_bf16_paths_stay_bf16(monkeypatch, family, route):
    """On every attention route a bf16 rollout returns bf16, and a bf16
    training step hands every kernel wrapper bf16 tensors only: the
    constants built inside a step (Swin's expanded bias and shift mask,
    Pangu's earth bias and mask) follow the compute dtype."""
    cfg = {**BASE, **FAMILIES[family]}
    if route is not None:
        cfg["use_flash_attention"] = route
    spies = {}
    for (mod, name), pos in SPIED.items():
        spies[name] = _DtypeSpy(getattr(mod, name), pos)
        monkeypatch.setattr(mod, name, spies[name])
    b = _tensors(next(TDataset(**_arrays()).batches(2)))
    with torch.no_grad():
        out = registry.build_model(dict(cfg), seed=1).to(torch.bfloat16)(
            *(x.to(torch.bfloat16) for x in b[:3]))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    tr = ttr.Trainer(registry.build_model({**cfg, "remat": True}, seed=1),
                     compute_dtype="bfloat16")
    loss = tr.train_step(tr.init(), b, LR)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    seen = set().union(*(c for s in spies.values() for c in s.calls))
    assert seen <= {torch.bfloat16}
    if route in (True, "packed", "packed5d"):  # the route's wrappers ran, forward and backward
        assert sum(len(s.calls) for n, s in spies.items() if n.endswith("_bwd")) > 0
        assert sum(len(s.calls) for n, s in spies.items() if n.endswith("_fwd")) > 0


@pytest.mark.parametrize("family", ["UNet", "Pangu"])
def test_bf16_remat_recomputes_from_the_bf16_copies(family):
    """With per-step checkpointing the backward recomputes each step from
    the bf16 parameter copies, so remat changes nothing."""
    cfg = {**BASE, **FAMILIES[family]}
    b = _tensors(next(TDataset(**_arrays()).batches(4)))
    results = []
    for remat in (False, True):
        tr = ttr.Trainer(registry.build_model({**cfg, "remat": remat}, seed=2),
                         compute_dtype="bfloat16")
        state = tr.init()
        loss = tr.train_step(state, b, LR)
        results.append((loss.item(), [p.detach().clone() for p in state.model.parameters()]))
    assert results[0][0] == results[1][0]
    for a, c in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-6)


def test_validation_runs_in_fp32():
    cfg = {**BASE, **FAMILIES["Swin"]}
    ds = TDataset(**{**_arrays(), "sequence_length": 4})
    got = []
    for dtype in (None, "bfloat16"):
        tr = ttr.Trainer(registry.build_model(dict(cfg), seed=3), compute_dtype=dtype)
        got.append(tr.validate(tr.init(), ds, 5))
    assert got[0][0] == got[1][0]
    np.testing.assert_array_equal(got[0][1], got[1][1])


@pytest.mark.parametrize("dtype", ["int8", "bogus"])
def test_unknown_compute_dtype_raises(dtype):
    with pytest.raises(ValueError, match="floating dtype"):
        ttr.Trainer(registry.build_model({**BASE, **FAMILIES["UNet"]}), compute_dtype=dtype)


def _fake_card(monkeypatch, module):
    calls = []
    monkeypatch.setattr(module, "_device_of", lambda tensors: torch.device("cuda"))
    monkeypatch.setattr(module, "_kernel_fn",
                        lambda source, symbol, n_ptr, n_int: calls.append(symbol) or (lambda *a: 0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_count_their_bf16_launches(monkeypatch, dtype):
    """On a (faked) CUDA tensor each wrapper counts a launch of its bf16
    instance in `.bf16_launches` beside `.launches`, and none in fp32."""
    _fake_card(monkeypatch, fa)
    _fake_card(monkeypatch, wa)
    monkeypatch.setattr(wa, "_check_cuda", lambda *a: None)  # CPU tensors are not 16-byte aligned
    counters = [fa.flash_window_attention_fwd, fa.flash_window_attention_bwd,
                wa.window_attention_qkv_fwd, wa.window_attention_qkv5d_fwd]
    for c in counters:
        monkeypatch.setattr(c, "launches", 0)
        monkeypatch.setattr(c, "bf16_launches", 0)
    q = torch.zeros(4, 2, 16, 8, dtype=dtype)
    bias = torch.zeros(2, 16, 16, dtype=dtype)
    lse = torch.zeros(4, 2, 1, 16)
    fa.flash_window_attention_fwd(q, q, q, bias)
    fa.flash_window_attention_bwd(q, q, q, bias, q, lse, q, lse)
    wa.window_attention_qkv_fwd(torch.zeros(2, 1, 2, 16, 48, dtype=dtype),
                                torch.zeros(1, 2, 16, 16, dtype=dtype), None, 2)
    wa.window_attention_qkv5d_fwd(torch.zeros(1, 2, 4, 8, 48, dtype=dtype),
                                  torch.zeros(2, 2, 16, 16, dtype=dtype), None, 2, (2, 2, 4))
    bf16 = int(dtype == torch.bfloat16)
    assert [(c.launches, c.bf16_launches) for c in counters] == [(1, bf16)] * len(counters)


# ---------------------------------------------------------------- spectral losses
@pytest.mark.parametrize("shape", [(3, 8, 16), (2, 4, 6, 33)])
def test_zonal_power_spectrum_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    field = rng.standard_normal(shape).astype(np.float32)
    lats = np.linspace(-80, 80, shape[-2])
    want = np.asarray(jlosses.zonal_power_spectrum(jnp.asarray(field), lats))
    got = tlosses.zonal_power_spectrum(torch.from_numpy(field), lats).numpy()
    assert got.shape == want.shape == (*shape[:-1], shape[-1] // 2 + 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_melr_matches_jax():
    rng = np.random.default_rng(7)
    pred, true = (rng.standard_normal((4, 8, 16)).astype(np.float32) for _ in range(2))
    lats = np.linspace(-78.75, 78.75, 8)
    want, want_k = jlosses.melr(jnp.asarray(pred), jnp.asarray(true), lats)
    got, got_k = tlosses.melr(torch.from_numpy(pred), torch.from_numpy(true), lats)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    assert tlosses.EARTH_RADIUS_M == jlosses.EARTH_RADIUS_M


if __name__ == "__main__":
    # `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bf16.py` from
    # the repo root: the numbers behind the bf16 tolerances for the
    # spectral and graph families, on the host's CPU ("fp32": the port's
    # fp32 trainer).
    for fam in ("TFNO", "FourCastNet", "SFNO", "GraphCast", "MeshGraphNet",
                "MeshGraphNet-stencil"):
        FAMILIES.update(LAYER_ONLY)
        j, t, f32, _ = _three_steps(fam)
        gap = lambda a, b: " ".join(f"{abs(x / y - 1):.2e}" for x, y in zip(a, b))
        print(f"{fam}: per-step loss, |port bf16 / JAX bf16 - 1| {gap(t, j)}; "
              f"|JAX bf16 / fp32 - 1| {gap(j, f32)}; |port bf16 / fp32 - 1| {gap(t, f32)}")
        ratios = [port / ref for _, port, ref in _layer_errors(fam)]
        print(f"{fam}: per-layer rms error, port over JAX: max {max(ratios):.4f} "
              f"over {len(ratios)} layers")
