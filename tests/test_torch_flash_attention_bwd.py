"""The port's flash-attention backward against the JAX package's.

On the CPU the port's autograd Function takes the plain backward
(`flash_window_attention_bwd_plain`); it is held against `jax.vjp` of the
JAX `flash_window_attention` / `flash_window_attention_lse`, whose Pallas
backward runs in interpret mode: the panel route (`_flash_bwd_panel`,
N = 128) and the streaming route (`_flash_bwd_impl`, N = 60 and 200), for
a shared [H,N,N] bias, a [1,H,N,N] bias with the Swin shift mask, a
[2,H,N,N] bias at B = 4 (the member sum) and G == B.

Tolerance: fp32, atol 2e-5 on dq, dk, dv and dbias at these sizes (unit
normal inputs, |grad| < 10): the two sides sum over up to 200 keys and
4 members in another order.  The CUDA kernels are tested on the card in
`test_torch_cuda_kernels.py`.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlwpbench_tpu.ops import pallas_attention as pa
from dlwpbench_tpu_torch.models.swin import shift_window_groups
from dlwpbench_tpu_torch.ops import flash_attention as fa


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the suite's workers share the
    cores, and a test's extra threads only wait on the other workers."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = 2e-5
B, H = 4, 2
GRIDS = {128: (8, 16), 60: (6, 10), 200: (10, 20)}  # N -> a (h, w) window


def _bias(kind, N, rng):
    if kind == "3d":
        return rng.standard_normal((H, N, N)).astype(np.float32)
    if kind == "shift":  # the model's own form: table-like bias + -100 mask
        h, w = GRIDS[N]
        groups = shift_window_groups(h, w, h, w, h // 2, w // 2)
        mask = np.where(groups[:, None, :] != groups[:, :, None], -100.0, 0.0)
        rel = 0.02 * rng.standard_normal((H, N, N))
        return (rel[None] + mask[:, None]).astype(np.float32)
    G = {"g2": 2, "gB": B}[kind]
    return rng.standard_normal((G, H, N, N)).astype(np.float32)


def _inputs(N, D, kind, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, N, D)).astype(np.float32) for _ in range(3))
    bias = _bias(kind, N, rng)
    g_out = rng.standard_normal((B, H, N, D)).astype(np.float32)
    g_lse = rng.standard_normal((B, H, 1, N)).astype(np.float32)
    return q, k, v, bias, g_out, g_lse


def _torch_grads(fn, arrays, cots):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    return [t.grad.numpy() for t in ts]


def _assert_grads(got, want):
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert g.shape == np.shape(w), name
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("bias_kind", ["3d", "shift", "g2", "gB"])
@pytest.mark.parametrize(
    "N, D", [(128, 8), (128, 16), (60, 8), (200, 16)],
    ids=["panel-D8", "panel-D16", "stream-N60", "stream-N200"],
)
def test_backward_matches_jax_vjp(N, D, bias_kind):
    q, k, v, bias, g_out, _ = _inputs(N, D, bias_kind, N * 100 + D)
    _, vjp = jax.vjp(
        lambda *a: pa.flash_window_attention(*a, interpret=True),
        *map(jnp.asarray, (q, k, v, bias)),
    )
    want = vjp(jnp.asarray(g_out))
    got = _torch_grads(fa.flash_window_attention, (q, k, v, bias), (g_out,))
    _assert_grads(got, want)


@pytest.mark.parametrize("N, bias_kind", [(128, "g2"), (60, "3d")])
def test_lse_backward_matches_jax_vjp(N, bias_kind):
    q, k, v, bias, g_out, g_lse = _inputs(N, 8, bias_kind, N + 7)
    _, vjp = jax.vjp(
        lambda *a: pa.flash_window_attention_lse(*a, interpret=True),
        *map(jnp.asarray, (q, k, v, bias)),
    )
    want = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
    got = _torch_grads(fa.flash_window_attention_lse, (q, k, v, bias), (g_out, g_lse))
    _assert_grads(got, want)


@pytest.mark.parametrize("bias_kind", ["3d", "g2", "gB"])
def test_function_matches_autograd_through_plain(bias_kind):
    """The Function's gradients equal autograd through the plain forward."""
    q, k, v, bias, g_out, g_lse = _inputs(40, 16, bias_kind, 3)

    def plain(*ts):
        return fa.flash_window_attention_plain(*ts)

    want = _torch_grads(plain, (q, k, v, bias), (g_out, g_lse))
    got = _torch_grads(fa.flash_window_attention_lse, (q, k, v, bias), (g_out, g_lse))
    _assert_grads(got, want)


def test_plain_backward_direct_call():
    """The plain backward called as the kernel's wrapper is (drow given),
    without counting a launch on CPU tensors."""
    q, k, v, bias, g_out, _ = map(torch.from_numpy, _inputs(60, 8, "g2", 11))
    out, lse = fa.flash_window_attention_fwd(q, k, v, bias)
    drow = (g_out * out).sum(-1)[:, :, None, :]
    counter = fa.flash_window_attention_bwd
    before = (counter.launches, counter.wgmma_launches, counter.mma_launches)
    got = fa.flash_window_attention_bwd(q, k, v, bias, out, lse, g_out, drow)
    assert (counter.launches, counter.wgmma_launches, counter.mma_launches) == before
    want = fa.flash_window_attention_bwd_plain(q, k, v, bias, out, lse, g_out, drow)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[3].shape == bias.shape


def test_backward_checks_shapes():
    q = torch.zeros(2, 2, 16, 8)
    bias = torch.zeros(2, 16, 16)
    lse = torch.zeros(2, 2, 1, 16)
    with pytest.raises(ValueError, match="dO"):
        fa.flash_window_attention_bwd(q, q, q, bias, q, lse, torch.zeros(2, 2, 16, 4), lse)
    with pytest.raises(ValueError, match="drow"):
        fa.flash_window_attention_bwd(q, q, q, bias, q, lse, q, torch.zeros(2, 2, 16))


@pytest.mark.parametrize("N, D, route", [
    (2048, 24, "wgmma"),  # Swin stage 0
    (512, 48, "wgmma"),   # Swin stage 1, the largest head dim the wgmma design takes
    (1000, 32, "wgmma"),  # the tail case, G 4
    (2047, 40, "wgmma"),
    (72, 32, "wgmma"),    # Pangu's flash route in the 2D ring
    (1, 8, "wgmma"),
    (2048, 56, "mma"),    # the ladder's swin@8m: past the wgmma design
    (200, 64, "mma"),     # G = B at the largest head dim the mma design takes
    (200, 72, "rows"),    # the first head dim past it
    (65, 128, "rows"),
])
def test_backward_route_is_chosen_by_shape(N, D, route):
    assert fa.bwd_route(N, D) == route


def _fake_card(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors: the device reads "cuda" and
    each C entry is a stub returning 0; returns the symbols called."""
    calls = []
    monkeypatch.setattr(fa, "_device_of", lambda tensors: torch.device("cuda"))
    monkeypatch.setattr(fa, "_kernel_fn",
                        lambda source, symbol, n_ptr, n_int: calls.append(symbol) or (lambda *a: 0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("N, D, G, route", [
    (128, 24, 0, "wgmma"), (60, 48, 2, "wgmma"), (65, 8, 1, "wgmma"), (40, 56, 0, "mma"),
    (40, 64, 4, "mma"), (40, 72, 1, "rows"),
])
def test_wrapper_launches_the_design_bwd_route_names(monkeypatch, N, D, G, route):
    """On a (faked) CUDA tensor the wrapper calls the C entry of the design
    `bwd_route` names, once, and counts it: `.launches` always,
    `.wgmma_launches` and `.mma_launches` on their designs only."""
    calls = _fake_card(monkeypatch)
    counter = fa.flash_window_attention_bwd
    monkeypatch.setattr(counter, "launches", 0)
    monkeypatch.setattr(counter, "wgmma_launches", 0)
    monkeypatch.setattr(counter, "mma_launches", 0)
    q = torch.zeros(4, 2, N, D)
    bias = torch.zeros((2, N, N) if G == 0 else (G, 2, N, N))
    lse = torch.zeros(4, 2, 1, N)
    dq, dk, dv, dbias = fa.flash_window_attention_bwd(q, q, q, bias, q, lse, q, lse)
    symbol = {"wgmma": "flash_window_attention_bwd_wgmma", "mma": "flash_window_attention_bwd_mma",
              "rows": "flash_window_attention_bwd"}[route]
    assert calls == [symbol]
    assert (counter.launches, counter.wgmma_launches, counter.mma_launches) == (
        1, int(route == "wgmma"), int(route == "mma"))
    assert dq.shape == q.shape and dbias.shape == bias.shape
