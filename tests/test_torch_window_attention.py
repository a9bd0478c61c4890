"""The port's small-window attention (token-major and 5D, forward and
backward) against the JAX package's Pallas kernels in interpret mode.

Inputs are made with numpy from a seed and go to both sides.  Biases are
random and not symmetric (the kernels read them key-major, so a transposed
read fails); masks are symmetric -100 block masks, as the models' group-id
shift masks are.  The port's wrappers take their plain versions on CPU
tensors.

Tolerance: fp32, atol 2e-5 with rtol 2e-5 on outputs, lse and gradients.
Both sides compute in fp32; the Pallas kernel takes its dots in another
order and its softmax in another form (max-subtracted exp over the key
axis, divided after the product), which moves results by a few ulps of
values up to about 10 (dbias sums over up to 12 members).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlwpbench_tpu.models import pangu as jpangu
from dlwpbench_tpu.ops import pallas_attention as pa
from dlwpbench_tpu_torch.ops import window_attention as wa

TOL = dict(rtol=2e-5, atol=2e-5)


def _block_mask(lead, nW, N):
    """[lead, nW, N, N] symmetric {0, -100} masks, a different cut each."""
    m = np.zeros((lead, nW, N, N), np.float32)
    for lo in range(lead):
        for w in range(nW):
            cut = (lo + w + 1) * N // (lead + nW + 1)
            m[lo, w, :cut, cut:] = -100.0
            m[lo, w, cut:, :cut] = -100.0
    return m


def _inputs(shape, bias_shape, mask_shape, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal(shape).astype(np.float32)
    bias = rng.standard_normal(bias_shape).astype(np.float32)
    mask = None if mask_shape is None else _block_mask(*mask_shape)
    dout = rng.standard_normal(shape[:-1] + (shape[-1] // 3,)).astype(np.float32)
    return qkv, bias, mask, dout


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# (B, L, nW, N, nh, hd, bias windows, masked)
TOKEN_MAJOR = [
    pytest.param(2, 3, 2, 144, 2, 16, 2, True, id="L3-nW2-N144-masked"),
    pytest.param(3, 1, 3, 64, 2, 16, 1, False, id="shared-bias-unmasked"),
]


@pytest.mark.parametrize("B, L, nW, N, nh, hd, bW, masked", TOKEN_MAJOR)
def test_token_major_plain_matches_pallas(B, L, nW, N, nh, hd, bW, masked):
    C = nh * hd
    qkv, bias, mask, dout = _inputs((B, L, nW, N, 3 * C), (bW, nh, N, N),
                                    (L, nW, N) if masked else None, seed=N + bW)

    def f(qkv, bias):
        return pa.window_attention_qkv(qkv, bias, _j(mask), nh, interpret=True)

    want, vjp = jax.vjp(f, jnp.asarray(qkv), jnp.asarray(bias))
    want_dqkv, want_dbias = vjp(jnp.asarray(dout))
    want_lse = pa._tm_impl(jnp.asarray(qkv), jnp.asarray(bias),
                           jnp.zeros((1, 1, N, N)) if mask is None else jnp.asarray(mask),
                           nh, interpret=True)[1]

    out, lse = wa.window_attention_qkv_fwd(_t(qkv), _t(bias), _t(mask), nh)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    dqkv, dbias = wa.window_attention_qkv_bwd(_t(qkv), _t(bias), _t(mask), out, lse, _t(dout))
    assert dbias.shape == bias.shape
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(want_dqkv), **TOL)
    np.testing.assert_allclose(dbias.numpy(), np.asarray(want_dbias), **TOL)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_5d_plain_matches_pallas(masked):
    win, (B, Pl, Lat, Lon), nh, hd = (2, 3, 4), (4, 2, 6, 8), 2, 16
    nLon, nW, N, C = Lon // win[2], 2, 24, nh * hd
    qkv, bias, mask, dout = _inputs((B, Pl, Lat, Lon, 3 * C), (nW, nh, N, N),
                                    (nLon, nW, N) if masked else None, seed=5 + masked)

    def f(qkv, bias):
        return pa.window_attention_qkv5d(qkv, bias, _j(mask), nh, win, interpret=True)

    want, vjp = jax.vjp(f, jnp.asarray(qkv), jnp.asarray(bias))
    want_dqkv, want_dbias = vjp(jnp.asarray(dout))

    out, lse = wa.window_attention_qkv5d_fwd(_t(qkv), _t(bias), _t(mask), nh, win)
    assert lse.shape == (B, nLon, nW, nh, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    dqkv, dbias = wa.window_attention_qkv5d_bwd(_t(qkv), _t(bias), _t(mask), out, lse,
                                                _t(dout), win)
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(want_dqkv), **TOL)
    np.testing.assert_allclose(dbias.numpy(), np.asarray(want_dbias), **TOL)


def test_5d_equals_partition_token_major_reverse():
    """The 5D lse and output are the token-major ones on the partitioned
    field (the JAX test's composition)."""
    win, nh = (2, 3, 4), 2
    qkv, bias, mask, _ = _inputs((2, 2, 6, 8, 96), (2, nh, 24, 24), (2, 2, 24), seed=9)
    out5, lse5 = wa.window_attention_qkv5d_fwd(_t(qkv), _t(bias), _t(mask), nh, win)
    tok = wa.partition_windows_5d(_t(qkv), win)
    out, lse = wa.window_attention_qkv_fwd(tok, _t(bias), _t(mask), nh)
    assert torch.equal(lse5, lse)
    assert torch.equal(out5, wa.reverse_windows_5d(out, win, 2, 6, 8))


def test_partition_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 4, 6, 8, 5)).astype(np.float32)
    win = (2, 3, 4)
    want = np.asarray(jpangu.window_partition_3d(jnp.asarray(x), win))
    got = wa.partition_windows_5d(torch.from_numpy(x), win)
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)
    np.testing.assert_array_equal(wa.reverse_windows_5d(got, win, 4, 6, 8).numpy(), x)


@pytest.mark.parametrize("layout", ["token-major", "5d"])
@pytest.mark.parametrize("bW", [1, 2], ids=["shared-bias", "per-window-bias"])
def test_functions_match_autograd_through_plain(layout, bW):
    """The autograd Functions' gradients (plain backward on the CPU) equal
    autograd through the plain forward; the mask gets no gradient."""
    nh, win = 2, (2, 3, 4)
    if layout == "5d":
        shape, N, lead = (2, 2, 6, 8, 96), 24, 2
    else:
        shape, N, lead = (2, 2, 2, 24, 96), 24, 2
    qkv, bias, mask, dout = _inputs(shape, (bW, nh, N, N), (lead, 2, N), seed=bW)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (qkv, bias)]
    ref = [torch.from_numpy(a).requires_grad_() for a in (qkv, bias)]
    m = torch.from_numpy(mask)
    if layout == "5d":
        out = wa.window_attention_qkv5d(*leaves, m, nh, win)
        want = wa.window_attention_qkv5d_plain(*ref, m, nh, win)[0]
    else:
        out = wa.window_attention_qkv(*leaves, m, nh)
        want = wa.window_attention_qkv_plain(*ref, m, nh)[0]
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    out.backward(torch.from_numpy(dout))
    want.backward(torch.from_numpy(dout))
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


def test_wrappers_count_no_launch_on_the_cpu():
    qkv, bias, _, dout = _inputs((1, 1, 2, 8, 48), (2, 2, 8, 8), None, seed=0)
    counters = (wa.window_attention_qkv_fwd, wa.window_attention_qkv5d_fwd,
                wa.window_attention_qkv_bwd, wa.window_attention_qkv5d_bwd)
    before = [(c.launches, c.fused_launches) for c in counters]
    out, lse = wa.window_attention_qkv_fwd(_t(qkv), _t(bias), None, 2)
    wa.window_attention_qkv_bwd(_t(qkv), _t(bias), None, out, lse, _t(dout))
    assert [(c.launches, c.fused_launches) for c in counters] == before


@pytest.mark.parametrize("N, hd, route", [
    (144, 32, "fused"),       # Pangu stages 1 and 2
    (64, 24, "fused"),        # swin_win8 stage 0
    (64, 48, "fused"),        # swin_win8 stage 1
    (72, 16, "fused"),        # the round-2 shape
    (1, 8, "fused"),
    (144, 48, "fused"),       # the largest block the fused route takes
    (145, 48, "four_pass"),   # the first N past it
    (144, 56, "four_pass"),   # the first head dim past it
    (200, 32, "four_pass"),
    (1023, 128, "four_pass"),
])
def test_backward_route_is_chosen_by_shape(N, hd, route):
    assert wa.bwd_route(N, hd) == route


@pytest.mark.parametrize("N, hd, route", [
    (144, 32, "fused"),   # Pangu stages 1 and 2
    (64, 24, "fused"),    # swin_win8 stage 0
    (64, 48, "fused"),    # swin_win8 stage 1
    (72, 16, "fused"),    # the round-2 shape
    (1, 8, "fused"),
    (144, 48, "fused"),   # the largest block the fused route takes
    (145, 48, "row"),     # the first N past it
    (144, 56, "row"),     # the first head dim past it
    (200, 32, "row"),
    (1023, 128, "row"),
])
def test_forward_route_is_chosen_by_shape(N, hd, route):
    """The forward's region is the backward's: the same shapes, the fused
    design or the row kernel."""
    assert wa.fwd_route(N, hd) == route
    assert (route == "fused") == (wa.bwd_route(N, hd) == "fused")


@pytest.mark.parametrize("bW, nh, members, chunks", [
    (6, 6, 192, 29),   # Pangu stage 1: 36 (w, h) pairs x 192 members
    (3, 12, 96, 24),   # Pangu stage 2: 36 pairs x 96 members
    (1, 4, 1024, 256),  # swin_win8 stage 0: shared bias, 4 heads x 1024 members
    (8, 4, 32, 8),     # swin_win8 stage 1: 32 pairs x 32 members
    (2, 2, 3, 1),      # fewer than 4 members: one chunk
])
def test_fused_chunk_plan(bW, nh, members, chunks):
    """About 1024 blocks where the members allow, each summing at least 4
    members (or all of them)."""
    n = wa._fused_chunks(bW, nh, members)
    assert n == chunks
    assert -(-members // n) >= min(4, members)


def test_shapes_are_checked():
    qkv = torch.zeros(2, 1, 3, 8, 48)
    with pytest.raises(ValueError, match="bias"):
        wa.window_attention_qkv_fwd(qkv, torch.zeros(2, 2, 8, 8), None, 2)  # nW is 3
    with pytest.raises(ValueError, match="mask"):
        wa.window_attention_qkv_fwd(qkv, torch.zeros(3, 2, 8, 8), torch.zeros(2, 3, 8, 8), 2)
    with pytest.raises(ValueError, match="tile"):
        wa.window_attention_qkv5d_fwd(torch.zeros(1, 2, 5, 8, 48), torch.zeros(1, 2, 24, 24),
                                      None, 2, (2, 3, 4))
