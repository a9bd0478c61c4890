"""The port's packed window attention (forward and backward) against the
JAX package's Pallas kernel `packed_window_attention` in interpret mode.

Inputs are made with numpy from a seed and go to both sides.  Biases are
random and not symmetric (both sides read them query-major, so a transposed
read fails); masks are the JAX tests' symmetric -100 block masks, plus a
random asymmetric mask, which the packed kernel must apply as given.  The
port's wrappers take their plain versions on CPU tensors.

Tolerance: fp32, atol 2e-5 with rtol 2e-5 on outputs, lse and gradients,
as for the flash and window kernels.  Both sides compute in fp32, but the
plain version is a two-pass softmax over the full [N, N] scores while the
Pallas kernel takes its dots in another order and divides after the
product, which moves results by a few ulps of values up to about 10 (dbias
sums over up to 6 members).
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlwpbench_tpu.ops import pallas_attention as pa
from dlwpbench_tpu_torch.ops import packed_attention as pk
from dlwpbench_tpu_torch.ops import window_attention as wa

TOL = dict(rtol=2e-5, atol=2e-5)


def _block_mask(nLon, nW, N):
    """[nLon, nW, N, N] symmetric {0, -100} masks, a different cut each
    (`tests/test_pallas.py`'s shift-mask-like blocks)."""
    m = np.zeros((nLon, nW, N, N), np.float32)
    for lo in range(nLon):
        for w in range(nW):
            cut = (lo + w + 1) * N // (nLon + nW + 1)
            m[lo, w, :cut, cut:] = -100.0
            m[lo, w, cut:, :cut] = -100.0
    return m


def _inputs(BW, nh, N, D, nW, mask_kind, nLon, seed):
    """q, k, v, bias, mask (or None) and dO as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((BW, nh, N, D)).astype(np.float32) for _ in range(3))
    bias = (0.5 * rng.standard_normal((nW, nh, N, N))).astype(np.float32)
    mask = None
    if mask_kind == "block":
        mask = _block_mask(nLon, nW, N)
    elif mask_kind == "shared":  # one mask per lon group, shared by the windows
        mask = _block_mask(nLon, 1, N)
    elif mask_kind == "asymmetric":  # random, mask[q, k] != mask[k, q]
        mask = (2.0 * rng.standard_normal((nLon, nW, N, N))).astype(np.float32)
        assert not np.allclose(mask, np.swapaxes(mask, -1, -2))
    do = rng.standard_normal((BW, nh, N, D)).astype(np.float32)
    return q, k, v, bias, mask, do


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# (B_ = BW / nW, nh, N, D, nW, mask kind, nLon)
FORWARD = [
    pytest.param(6, 2, 144, 32, 2, "block", 3, id="N144-D32-masked"),
    pytest.param(6, 3, 72, 16, 2, "block", 3, id="N72-D16-masked"),
    pytest.param(2, 2, 48, 8, 3, None, 1, id="N48-D8-no-mask"),
    pytest.param(4, 2, 40, 16, 3, "shared", 2, id="mask-window-axis-1"),
    pytest.param(6, 2, 36, 16, 2, "asymmetric", 3, id="asymmetric-mask"),
    pytest.param(5, 2, 24, 8, 2, "block", 3, id="members-not-a-multiple-of-nLon"),
]


@pytest.mark.parametrize("B_, nh, N, D, nW, mask_kind, nLon", FORWARD)
def test_forward_matches_pallas(B_, nh, N, D, nW, mask_kind, nLon):
    q, k, v, bias, mask, _ = _inputs(B_ * nW, nh, N, D, nW, mask_kind, nLon, seed=N + D)
    want = pa.packed_window_attention(*map(jnp.asarray, (q, k, v, bias)), _j(mask),
                                      interpret=True)
    zero = np.zeros((1, 1, N, N), np.float32)
    tr = lambda a: jnp.swapaxes(jnp.asarray(a), -1, -2)  # noqa: E731  (the kernel's layout)
    want_lse = pa._packed_impl(*map(tr, (q, k, v, bias, zero if mask is None else mask)),
                               interpret=True)[1]

    out, lse = pk.packed_window_attention_fwd(*map(_t, (q, k, v, bias, mask)))
    assert lse.shape == (B_ * nW, nh, 1, N) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


# (B_, nh, N, D, nW, mask kind, nLon): the JAX tests' gradient shapes, and
# the asymmetric mask
BACKWARD = [
    pytest.param(6, 2, 64, 16, 2, "block", 2, id="N64-masked-nLon2"),
    pytest.param(2, 2, 16, 8, 3, None, 1, id="no-mask-grouped-bias"),
    pytest.param(5, 2, 24, 8, 2, "asymmetric", 3, id="asymmetric-mask-5-members-nLon3"),
]


@pytest.mark.parametrize("B_, nh, N, D, nW, mask_kind, nLon", BACKWARD)
def test_backward_matches_pallas_vjp(B_, nh, N, D, nW, mask_kind, nLon):
    q, k, v, bias, mask, do = _inputs(B_ * nW, nh, N, D, nW, mask_kind, nLon, seed=3 * N)

    def f(q, k, v, bias):
        return pa.packed_window_attention(q, k, v, bias, _j(mask), interpret=True)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v, bias)))
    want = vjp(jnp.asarray(do))

    out, lse = pk.packed_window_attention_fwd(*map(_t, (q, k, v, bias, mask)))
    got = pk.packed_window_attention_bwd(*map(_t, (q, k, v, bias, mask)), out, lse, _t(do))
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL, err_msg=name)


@pytest.mark.parametrize("mask_kind", ["block", None], ids=["masked", "unmasked"])
def test_function_gradients_equal_plain_backward(mask_kind):
    """The autograd Function on CPU tensors: its gradients are
    `packed_window_attention_bwd_plain`'s, and the mask gets none."""
    q, k, v, bias, mask, do = _inputs(8, 2, 20, 8, 2, mask_kind, 2, seed=7)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    m = None if mask is None else torch.from_numpy(mask).requires_grad_()
    out = pk.packed_window_attention(*leaves, m)
    out.backward(torch.from_numpy(do))
    want_out, lse = pk.packed_window_attention_plain(*map(_t, (q, k, v, bias, mask)))
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    want = pk.packed_window_attention_bwd_plain(*map(_t, (q, k, v, bias, mask)), want_out, lse,
                                                _t(do))
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
    assert m is None or m.grad is None


def test_gradients_keep_their_dtypes():
    """bf16 inputs on the CPU: computed in fp32, every gradient (dbias
    included) comes back in its input's dtype."""
    arrays = _inputs(4, 2, 16, 8, 2, "block", 2, seed=8)
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in arrays[:4]]
    mask = torch.from_numpy(arrays[4]).to(torch.bfloat16)
    out = pk.packed_window_attention(*leaves, mask)
    assert out.dtype == torch.bfloat16
    out.float().square().sum().backward()
    assert [t.grad.dtype for t in leaves] == [torch.bfloat16] * 4
    assert leaves[3].grad.shape == leaves[3].shape


@pytest.mark.parametrize("masked", [True, False], ids=["shifted", "unshifted"])
def test_plain_equals_5d_plain_on_a_partitioned_field(masked):
    """B5 on the partitioned q, k, v of a 5D field is the 5D window
    attention on the field (bias transposed: B5 takes it query-major),
    forward and backward."""
    from dlwpbench_tpu_torch.models.pangu import shift_window_mask

    win, (B, Pl, Lat, Lon), nh, hd = (2, 3, 4), (2, 2, 6, 8), 2, 8
    nLon, nW, N, C = Lon // win[2], (Pl // win[0]) * (Lat // win[1]), 24, nh * hd
    rng = np.random.default_rng(11 + masked)
    qkv5 = torch.from_numpy(rng.standard_normal((B, Pl, Lat, Lon, 3 * C)).astype(np.float32))
    dout5 = torch.from_numpy(rng.standard_normal((B, Pl, Lat, Lon, C)).astype(np.float32))
    bias_km = torch.from_numpy(rng.standard_normal((nW, nh, N, N)).astype(np.float32))
    mask = torch.from_numpy(shift_window_mask((Pl, Lat, Lon), win, (1, 1, 2))) if masked else None

    out5, lse5 = wa.window_attention_qkv5d_plain(qkv5, bias_km, mask, nh, win)
    dqkv5, dbias5 = wa.window_attention_qkv5d_bwd_plain(qkv5, bias_km, mask, out5, lse5, dout5,
                                                        win)

    def heads(x, parts):  # [B, Pl, Lat, Lon, parts*C] -> parts x [BW, nh, N, hd]
        t = wa.partition_windows_5d(x, win).reshape(B, nLon, nW, N, parts, nh, hd)
        return t.permute(4, 0, 1, 2, 5, 3, 6).reshape(parts, B * nLon * nW, nh, N, hd)

    def field(*ts):  # the inverse of `heads`
        t = torch.stack(ts).reshape(len(ts), B, nLon, nW, nh, N, hd)
        t = t.permute(1, 2, 3, 5, 0, 4, 6).reshape(B, nLon, nW, N, len(ts) * C)
        return wa.reverse_windows_5d(t, win, Pl, Lat, Lon)

    q, k, v = heads(qkv5, 3)
    bias = bias_km.transpose(-1, -2).contiguous()
    out, lse = pk.packed_window_attention_plain(q, k, v, bias, mask)
    torch.testing.assert_close(field(out), out5, **TOL)
    torch.testing.assert_close(lse.reshape(lse5.shape), lse5, **TOL)
    dq, dk, dv, dbias = pk.packed_window_attention_bwd_plain(q, k, v, bias, mask, out, lse,
                                                             heads(dout5, 1)[0])
    torch.testing.assert_close(field(dq, dk, dv), dqkv5, **TOL)
    torch.testing.assert_close(dbias.transpose(-1, -2), dbias5, **TOL)


def test_wrappers_count_no_launch_on_the_cpu():
    arrays = _inputs(2, 2, 8, 8, 2, "block", 1, seed=0)
    counters = (pk.packed_window_attention_fwd, pk.packed_window_attention_bwd)
    before = [(c.launches, c.fused_launches) for c in counters]
    out, lse = pk.packed_window_attention_fwd(*map(_t, arrays[:5]))
    pk.packed_window_attention_bwd(*map(_t, arrays[:5]), out, lse, _t(arrays[5]))
    assert [(c.launches, c.fused_launches) for c in counters] == before


@pytest.mark.parametrize("BW, nh, N, D, nW, route, chunks", [
    (32 * 6 * 6, 6, 144, 32, 6, "fused", 29),   # Pangu stage 1: 36 (w, h) x 192 problems
    (32 * 3 * 3, 12, 144, 32, 3, "fused", 24),  # Pangu stage 2: 36 (w, h) x 96 problems
    (32 * 4 * 4, 4, 100, 24, 4, "fused", 32),   # the asymmetric-mask case: 128 problems
    (32 * 4, 2, 200, 32, 4, "four_pass", 32),   # past the fused region: the four passes
])
def test_backward_plan_is_chosen_by_shape(BW, nh, N, D, nW, route, chunks):
    """B5's backward takes the window backward's route rule and, with it,
    that design's chunk plan over the BW / nW problems of a window type."""
    assert pk._bwd_plan(BW, nh, N, D, nW) == (route, chunks)
    assert wa.bwd_route(N, D) == route


@pytest.mark.parametrize("N, D, route", [
    (144, 32, "fused"),  # Pangu stages 1 and 2
    (72, 16, "fused"),   # the round-2 shape
    (100, 24, "fused"),  # the asymmetric-mask case
    (144, 48, "fused"),  # the largest block the fused route takes
    (200, 32, "row"),    # past the region: the row forward
    (144, 56, "row"),
])
def test_forward_is_routed_by_fwd_route(monkeypatch, N, D, route):
    """On a (faked) CUDA tensor the forward wrapper calls the C entry of the
    design `window_attention.fwd_route` names, once, and counts it:
    `.launches` always, `.fused_launches` on the fused route only."""
    calls = []
    monkeypatch.setattr(pk, "_device_of", lambda tensors: torch.device("cuda"))
    monkeypatch.setattr(pk, "_kernel_fn",
                        lambda source, symbol, n_ptr, n_int: calls.append(symbol) or (lambda *a: 0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    fwd = pk.packed_window_attention_fwd
    monkeypatch.setattr(fwd, "launches", 0)
    monkeypatch.setattr(fwd, "fused_launches", 0)
    q = torch.zeros(4, 2, N, D)
    out, lse = fwd(q, q, q, torch.zeros(2, 2, N, N), torch.zeros(2, 1, N, N))
    assert wa.fwd_route(N, D) == route
    assert calls == ["packed_window_attention_fwd_fused" if route == "fused"
                     else "packed_window_attention_fwd"]
    assert (fwd.launches, fwd.fused_launches) == (1, int(route == "fused"))
    assert out.shape == q.shape and lse.shape == (4, 2, 1, N)


def test_shapes_are_checked():
    q = torch.zeros(6, 2, 8, 8)
    with pytest.raises(ValueError, match="mask window axis 2"):  # nW is 3
        pk.packed_window_attention_fwd(q, q, q, torch.zeros(3, 2, 8, 8), torch.zeros(1, 2, 8, 8))
    with pytest.raises(ValueError, match="BW % nW"):  # 6 problems, 4 window types
        pk.packed_window_attention_fwd(q, q, q, torch.zeros(4, 2, 8, 8), None)
    with pytest.raises(ValueError, match="BW % nW"):
        pk.packed_window_attention_bwd(q, q, q, torch.zeros(4, 2, 8, 8), None, q,
                                       torch.zeros(6, 2, 1, 8), q)
    with pytest.raises(ValueError, match="bias"):
        pk.packed_window_attention(q, q, q, torch.zeros(3, 2, 8, 7))
