"""bf16 compute over fp32 master weights, and the spectral losses, against
the JAX package on the CPU.

The counterpart of `tests/test_trainer.py::TestMixedPrecision` and
`tests/test_bf16_zoo.py` for the port's three families.  From one JAX
init and the same numpy batches, the JAX trainer and the port's take
three steps with `compute_dtype="bfloat16"`.

Tolerances:
- per-step losses, bf16: rtol 2e-3.  bf16 keeps 8 significant bits (a
  rounding is up to 2^-9 = 2e-3 of the value); XLA fuses elementwise
  chains and rounds once per fusion where ATen rounds after every op, so
  the two trainers round at other points.  Measured here: at most 6e-4
  over three steps of each family;
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
}


def _arrays(T=40, seed=0):
    rng = np.random.default_rng(seed)
    prog = np.cumsum(0.3 * rng.standard_normal((T, 2, H, W)), axis=0).astype(np.float32)
    return dict(prognostic=prog, prescribed=rng.standard_normal((T, 1, H, W)).astype(np.float32),
                constants=rng.standard_normal((2, H, W)).astype(np.float32),
                sequence_length=3, context_size=1, seed=4)


def _tensors(batch):
    return tuple(None if x is None else torch.as_tensor(x) for x in batch)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_trainer_matches_jax(family):
    cfg = {**BASE, **FAMILIES[family]}
    batches = list(TDataset(**_arrays()).batches(4))[:3]
    jt = jtr.Trainer(jbuild(dict(cfg)), learning_rate=LR, epochs=5, compute_dtype="bfloat16")
    jstate = jt.init(batches[0])
    init = jax.tree_util.tree_map(np.asarray, jstate.params)
    tt = ttr.Trainer(registry.build_model(dict(cfg)), learning_rate=LR, epochs=5,
                     compute_dtype="bfloat16")
    tstate = tt.init(params=init)
    t32 = ttr.Trainer(registry.build_model(dict(cfg)), learning_rate=LR, epochs=5)
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
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    assert t_losses != f32_losses  # the steps ran in bf16
    # the master parameters, their gradients and AdamW's moments stay fp32
    for p in tstate.model.parameters():
        assert isinstance(p, torch.nn.Parameter) and p.dtype == torch.float32
        assert p.grad.dtype == torch.float32
        st = tstate.optimizer.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32


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
