"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from dlwpbench_tpu_torch.ops import flash_attention as fa
from dlwpbench_tpu_torch.ops import packed_attention as pk
from dlwpbench_tpu_torch.ops import window_attention as wa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "Bq, Hq, N, D, G",
    [(2, 2, 128, 8, 0), (4, 2, 60, 24, 2), (3, 3, 1, 16, 0), (2, 1, 200, 128, 1),
     (2, 2, 65, 72, 0), (4, 1, 129, 40, 4)],
)
def test_kernel_matches_plain_on_card(cuda, dtype, Bq, Hq, N, D, G):
    g = torch.Generator(device=cuda).manual_seed(N * D)
    q, k, v = (torch.randn(Bq, Hq, N, D, device=cuda, generator=g).to(dtype) for _ in range(3))
    shape = (Hq, N, N) if G == 0 else (G, Hq, N, N)
    bias = torch.randn(shape, device=cuda, generator=g).to(dtype)
    before = fa.flash_window_attention_fwd.launches
    out, lse = fa.flash_window_attention_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    assert fa.flash_window_attention_fwd.launches == before + 1
    want, want_lse = fa.flash_window_attention_plain(q.float(), k.float(), v.float(), bias.float())
    atol = 2e-5 if dtype == torch.float32 else 1e-2  # bf16: output rounding
    torch.testing.assert_close(out.float(), want, rtol=0, atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.zeros(2, 2, 16, 12, device=cuda)  # head dim not a multiple of 8
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_window_attention_fwd(q, q, q, torch.zeros(2, 16, 16, device=cuda))
    q = torch.zeros(2, 2, 16, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_window_attention_fwd(q, q, q, torch.zeros(2, 16, 16, device=cuda, dtype=torch.float16))
    q = torch.zeros(2, 2, 16, 8, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        fa.flash_window_attention_fwd(q, q, q, torch.zeros(2, 16, 16, device=cuda))


def _bwd_inputs(cuda, dtype, Bq, Hq, N, D, G, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, do = (torch.randn(Bq, Hq, N, D, device=cuda, generator=g).to(dtype) for _ in range(4))
    shape = (Hq, N, N) if G == 0 else (G, Hq, N, N)
    bias = torch.randn(shape, device=cuda, generator=g).to(dtype)
    out, lse = fa.flash_window_attention_fwd(q, k, v, bias)
    drow = (do.float() * out.float()).sum(-1)[:, :, None, :]
    return q, k, v, bias, out, lse, do, drow


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "Bq, Hq, N, D, G",
    [(2, 2, 128, 8, 0), (4, 2, 60, 24, 2), (3, 3, 1, 16, 0), (2, 1, 200, 128, 1),
     (2, 2, 65, 72, 0), (4, 1, 129, 40, 4), (6, 2, 100, 48, 3)],
)
def test_backward_kernel_matches_plain_on_card(cuda, dtype, Bq, Hq, N, D, G):
    args = _bwd_inputs(cuda, dtype, Bq, Hq, N, D, G, N * D + 1)
    before = fa.flash_window_attention_bwd.launches
    got = fa.flash_window_attention_bwd(*args)
    torch.cuda.synchronize()
    assert fa.flash_window_attention_bwd.launches == before + 1
    want = fa.flash_window_attention_bwd_plain(*(a.float() for a in args))
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == args[0].dtype and a.shape == w.shape, name
        # fp32: other summation orders, scaled to the gradient's size;
        # bf16: the result is rounded once to bf16
        tol = (2e-5 if dtype == torch.float32 else 1e-2) * max(1.0, w.abs().max().item())
        torch.testing.assert_close(a.float(), w, rtol=0, atol=tol, msg=name)
    again = fa.flash_window_attention_bwd(*args)
    for a, b in zip(got, again):  # no atomics: bit-identical
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_backward_runs_through_the_kernel(cuda):
    """`.backward()` on CUDA tensors launches the backward kernel once and
    matches autograd through the plain version."""
    g = torch.Generator(device=cuda).manual_seed(5)
    ts = [torch.randn(2, 2, 96, 24, device=cuda, generator=g) for _ in range(3)]
    ts.append(torch.randn(1, 2, 96, 96, device=cuda, generator=g))
    leaves = [t.clone().requires_grad_() for t in ts]
    before_f = fa.flash_window_attention_fwd.launches
    before_b = fa.flash_window_attention_bwd.launches
    fa.flash_window_attention(*leaves).square().sum().backward()
    assert fa.flash_window_attention_fwd.launches == before_f + 1
    assert fa.flash_window_attention_bwd.launches == before_b + 1
    ref = [t.clone().requires_grad_() for t in ts]
    fa.flash_window_attention_plain(*ref)[0].square().sum().backward()
    for a, b in zip(leaves, ref):
        scale = max(1.0, b.grad.abs().max().item())
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=2e-5 * scale)


@pytest.mark.cuda
def test_backward_refuses_what_it_cannot_take(cuda):
    q = torch.zeros(2, 2, 16, 8, device=cuda)
    lse = torch.zeros(2, 2, 1, 16, device=cuda)
    with pytest.raises(TypeError):  # dO in another dtype
        fa.flash_window_attention_bwd(q, q, q, torch.zeros(2, 16, 16, device=cuda), q, lse,
                                      q.double(), lse)
    with pytest.raises(TypeError):  # lse not float32
        fa.flash_window_attention_bwd(q, q, q, torch.zeros(2, 16, 16, device=cuda), q,
                                      lse.double(), q, lse)


# ---------------------------------------------------------------- window attention
def _block_mask(lead, nW, N, device):
    """[lead, nW, N, N] symmetric {0, -100} masks, a different cut each."""
    m = torch.zeros(lead, nW, N, N, device=device)
    for lo in range(lead):
        for w in range(nW):
            cut = (lo + w + 1) * N // (lead + nW + 1)
            m[lo, w, :cut, cut:] = -100.0
            m[lo, w, cut:, :cut] = -100.0
    return m


# (layout, qkv shape, nh, window, bias windows, mask lead dims or None)
WINDOW_CASES = [
    ("token-major", (4, 3, 2, 144, 96), 2, None, 2, (3, 2)),
    ("token-major", (3, 1, 5, 64, 288), 4, None, 1, None),
    ("token-major", (2, 1, 3, 72, 72), 1, None, 3, (1, 3)),
    ("token-major", (2, 2, 1, 1, 48), 2, None, 1, (1, 1)),
    ("token-major", (1, 1, 1, 1023, 24), 1, None, 1, None),
    ("token-major", (2, 1, 2, 100, 3 * 128), 1, None, 2, (1, 2)),
    ("token-major", (2, 1, 2, 50, 3 * 2 * 72), 2, None, 2, None),
    ("5d", (4, 2, 6, 24, 96), 2, (2, 3, 12), 2, (2, 2)),
    ("5d", (3, 2, 6, 8, 3 * 40), 1, (2, 3, 4), 2, None),
    ("5d", (2, 2, 12, 24, 3 * 2 * 24), 2, (2, 6, 12), 2, (2, 1)),
]


def _window_inputs(cuda, dtype, layout, shape, nh, win, bW, lead, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(shape, device=cuda, generator=g)
    if layout == "5d":
        nW = (shape[1] // win[0]) * (shape[2] // win[1])
        N = win[0] * win[1] * win[2]
        L = shape[3] // win[2]
    else:
        _, L, nW, N, _ = shape
    bias = torch.randn(bW, nh, N, N, device=cuda, generator=g)
    mask = None
    if lead is not None:
        mask = _block_mask(L if lead[0] > 1 else 1, nW if lead[1] > 1 else 1, N, cuda)
    dout = torch.randn(shape[:-1] + (shape[-1] // 3,), device=cuda, generator=g)
    return [None if t is None else t.to(dtype).contiguous() for t in (qkv, bias, mask, dout)]


def _fwd(layout, qkv, bias, mask, nh, win):
    if layout == "5d":
        return wa.window_attention_qkv5d_fwd(qkv, bias, mask, nh, win)
    return wa.window_attention_qkv_fwd(qkv, bias, mask, nh)


def _bwd(layout, qkv, bias, mask, out, lse, dout, win, plain=False):
    if layout == "5d":
        fn = wa.window_attention_qkv5d_bwd_plain if plain else wa.window_attention_qkv5d_bwd
        return fn(qkv, bias, mask, out, lse, dout, win)
    fn = wa.window_attention_qkv_bwd_plain if plain else wa.window_attention_qkv_bwd
    return fn(qkv, bias, mask, out, lse, dout)


def _check_window_case(cuda, dtype, layout, shape, nh, win, bW, lead):
    """Forward and backward against the plain versions on the CPU, two
    backward calls bit-identical; returns the counters' moves: forward
    launches, backward launches, fused-route backward launches, fused-route
    forward launches."""
    qkv, bias, mask, dout = _window_inputs(cuda, dtype, layout, shape, nh, win, bW, lead,
                                           seed=sum(shape) + bW)
    fwd, bwd = ((wa.window_attention_qkv5d_fwd, wa.window_attention_qkv5d_bwd) if layout == "5d"
                else (wa.window_attention_qkv_fwd, wa.window_attention_qkv_bwd))
    before = (fwd.launches, bwd.launches, bwd.fused_launches, fwd.fused_launches)
    out, lse = _fwd(layout, qkv, bias, mask, nh, win)
    got = _bwd(layout, qkv, bias, mask, out, lse, dout, win)
    again = _bwd(layout, qkv, bias, mask, out, lse, dout, win)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip((fwd.launches, bwd.launches, bwd.fused_launches,
                                    fwd.fused_launches), before)]
    f32 = [None if t is None else t.float() for t in (qkv, bias, mask)]
    want, want_lse = _fwd(layout, *(t.cpu() if t is not None else None for t in f32), nh, win)
    # fp32: other summation orders; bf16: the result is rounded once to bf16
    atol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float().cpu(), want, rtol=0, atol=atol)
    torch.testing.assert_close(lse.cpu(), want_lse, rtol=0, atol=2e-5)
    ref = _bwd(layout, *(t.cpu() if t is not None else None for t in f32),
               out.float().cpu(), lse.cpu(), dout.float().cpu(), win, plain=True)
    for name, a, w in zip(("dqkv", "dbias"), got, ref):
        assert a.dtype == dtype and a.shape == w.shape, name
        tol = (2e-5 if dtype == torch.float32 else 1e-2) * max(1.0, w.abs().max().item())
        torch.testing.assert_close(a.float().cpu(), w, rtol=0, atol=tol, msg=name)
    for a, b in zip(got, again):  # no atomics: bit-identical
        assert torch.equal(a, b)
    return moved


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout, shape, nh, win, bW, lead", WINDOW_CASES)
def test_window_kernels_match_plain_on_card(cuda, dtype, layout, shape, nh, win, bW, lead):
    """Forward and backward of both layouts against their plain versions,
    one counted launch each, and two backward calls bit-identical."""
    moved = _check_window_case(cuda, dtype, layout, shape, nh, win, bW, lead)
    assert moved[:2] == [1, 2]


# (layout, qkv shape, nh, window, bias windows, mask lead dims or None,
# route): the model paths' shapes, and the fused route's edge
ROUTE_CASES = [
    ("token-major", (2, 1, 5, 64, 288), 4, None, 1, None, "fused"),  # N 64 hd 24, bW 1
    ("5d", (2, 2, 12, 24, 576), 6, (2, 6, 12), 2, (2, 2), "fused"),  # N 144 hd 32, [nLon, nW]
    ("token-major", (2, 1, 4, 64, 576), 4, None, 4, None, "fused"),  # N 64 hd 48, bW nW
    ("token-major", (1, 2, 2, 144, 288), 2, None, 2, (2, 2), "fused"),  # the largest taken
    ("token-major", (1, 1, 2, 145, 288), 2, None, 2, (1, 2), "four_pass"),  # N past it
    ("token-major", (1, 1, 2, 144, 168), 1, None, 2, None, "four_pass"),  # hd 56 past it
    ("token-major", (2, 1, 192, 64, 288), 4, None, 1, None, "fused"),  # HEALPix nside 32, 8x8
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout, shape, nh, win, bW, lead, route", ROUTE_CASES)
def test_window_backward_takes_its_route_on_card(cuda, dtype, layout, shape, nh, win, bW,
                                                  lead, route):
    """Each shape's forward and backward run on the routes `fwd_route` and
    `bwd_route` name (the fused counters move with them or not at all),
    match the plain versions, and the backward repeats bit for bit."""
    moved = _check_window_case(cuda, dtype, layout, shape, nh, win, bW, lead)
    fused = route == "fused"
    assert moved == [1, 2, 2 if fused else 0, 1 if fused else 0]


# (layout, qkv shape, nh, window, bias windows, mask lead dims or None):
# the model paths' forward shapes at a small batch, and one past the region
FORWARD_CASES = [
    ("5d", (2, 2, 36, 72, 576), 6, (2, 6, 12), 6, (6, 6)),     # Pangu stage 1, N 144 hd 32
    ("5d", (2, 2, 18, 36, 1152), 12, (2, 6, 12), 3, (3, 3)),   # Pangu stage 2
    ("token-major", (4, 1, 32, 64, 288), 4, None, 1, None),    # swin_win8 stage 0, hd 24
    ("token-major", (4, 1, 8, 64, 576), 4, None, 8, (1, 8)),   # swin_win8 stage 1, hd 48
    ("token-major", (4, 1, 192, 64, 288), 4, None, 1, None),   # HEALPix nside 32 stage 0
    ("token-major", (4, 1, 48, 64, 576), 4, None, 48, (1, 48)),  # its stage 1, shifted
    ("token-major", (2, 2, 3, 72, 144), 3, None, 3, (2, 3)),   # round-2 N 72, hd 16
    ("token-major", (2, 1, 2, 200, 192), 2, None, 2, (1, 2)),  # N 200: past the region
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout, shape, nh, win, bW, lead", FORWARD_CASES)
def test_window_forward_takes_its_route_on_card(cuda, dtype, layout, shape, nh, win, bW, lead):
    """The forward at the model paths' shapes: the route `fwd_route` names,
    against the plain version on the CPU, and the fused design against the
    row kernel (the module's private launcher) on the same inputs."""
    qkv, bias, mask, _ = _window_inputs(cuda, dtype, layout, shape, nh, win, bW, lead,
                                        seed=sum(shape) + nh)
    fwd = wa.window_attention_qkv5d_fwd if layout == "5d" else wa.window_attention_qkv_fwd
    B, L, nW, N, C = (shape[0], shape[3] // win[2], (shape[1] // win[0]) * (shape[2] // win[1]),
                      win[0] * win[1] * win[2], shape[-1] // 3) if layout == "5d" else \
        (*shape[:4], shape[-1] // 3)
    route = wa.fwd_route(N, C // nh)
    before = (fwd.launches, fwd.fused_launches)
    out, lse = _fwd(layout, qkv, bias, mask, nh, win)
    torch.cuda.synchronize()
    assert (fwd.launches - before[0], fwd.fused_launches - before[1]) == \
        (1, 1 if route == "fused" else 0)
    f32 = [None if t is None else t.float().cpu() for t in (qkv, bias, mask)]
    want, want_lse = _fwd(layout, *f32, nh, win)
    # fp32: other summation orders; bf16: the result is rounded once to bf16
    atol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float().cpu(), want, rtol=0, atol=atol)
    torch.testing.assert_close(lse.cpu(), want_lse, rtol=0, atol=2e-5)
    if route == "fused":
        code = wa._FIELD_5D if layout == "5d" else wa._TOKEN_MAJOR
        m = wa._zero_mask(N, qkv) if mask is None else mask
        row_out, row_lse, taken = wa._launch_fwd("row", code, qkv, bias, m, nh, win,
                                                 tuple(out.shape), tuple(lse.shape), route="row")
        torch.cuda.synchronize()
        assert taken == "row"
        # both results rounded: up to one bf16 ulp apart
        torch.testing.assert_close(out.float(), row_out.float(), rtol=0,
                                   atol=atol if dtype == torch.float32 else 4 * atol)
        torch.testing.assert_close(lse, row_lse, rtol=0, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["token-major", "5d"])
def test_window_backward_runs_through_the_kernel(cuda, layout):
    """`.sum().backward()` on CUDA tensors launches each kernel once and
    matches autograd through the plain version on the CPU."""
    shape, win = ((2, 2, 6, 24, 96), (2, 3, 12)) if layout == "5d" else ((2, 2, 2, 72, 96), None)
    qkv, bias, mask, _ = _window_inputs(cuda, torch.float32, layout, shape, 2, win, 2, (2, 2), 3)
    fn = (lambda *a: wa.window_attention_qkv5d(*a, win)) if layout == "5d" else wa.window_attention_qkv
    counters = ((wa.window_attention_qkv5d_fwd, wa.window_attention_qkv5d_bwd) if layout == "5d"
                else (wa.window_attention_qkv_fwd, wa.window_attention_qkv_bwd))
    before = [c.launches for c in counters]
    leaves = [t.clone().requires_grad_() for t in (qkv, bias)]
    fn(*leaves, mask, 2).square().sum().backward()
    assert [c.launches for c in counters] == [b + 1 for b in before]
    ref = [t.detach().cpu().clone().requires_grad_() for t in (qkv, bias)]
    fn(*ref, mask.cpu(), 2).square().sum().backward()
    for a, b in zip(leaves, ref):
        scale = max(1.0, b.grad.abs().max().item())
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=0, atol=2e-5 * scale)


@pytest.mark.cuda
def test_window_kernels_refuse_what_they_cannot_take(cuda):
    bias = torch.zeros(2, 2, 16, 16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):  # hd 12
        wa.window_attention_qkv_fwd(torch.zeros(1, 1, 2, 16, 72, device=cuda), bias, None, 2)
    with pytest.raises(ValueError, match="N = 1024"):
        wa.window_attention_qkv_fwd(torch.zeros(1, 1, 1, 1024, 48, device=cuda),
                                    torch.zeros(1, 2, 1024, 1024, device=cuda), None, 2)
    with pytest.raises(TypeError):  # float16
        wa.window_attention_qkv_fwd(torch.zeros(1, 1, 2, 16, 96, device=cuda).half(),
                                    bias.half(), None, 2)
    with pytest.raises(TypeError):  # mask in another dtype than qkv
        wa.window_attention_qkv_fwd(torch.zeros(1, 1, 2, 16, 96, device=cuda), bias,
                                    torch.zeros(1, 1, 16, 16, device=cuda).double(), 2)
    qkv = torch.zeros(1, 1, 2, 16, 96, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        wa.window_attention_qkv_fwd(qkv, bias, None, 2)


# ---------------------------------------------------------------- packed window attention
# (B_ = BW / nW, nh, N, D, nW, mask lead dims (nLon, nW or 1) or None, mask kind)
PACKED_CASES = [
    (4, 2, 144, 32, 3, (2, 3), "block"),
    (5, 3, 72, 16, 2, (3, 2), "block"),  # 5 members: lon = member % 3 wraps mid-batch
    (3, 2, 50, 64, 2, None, None),
    (2, 1, 144, 128, 2, (2, 1), "random"),
    (2, 2, 200, 72, 2, (1, 2), "random"),
    (2, 2, 1, 8, 1, None, None),
    (1, 1, 1023, 24, 1, (1, 1), "random"),
]


def _packed_inputs(cuda, dtype, B_, nh, N, D, nW, lead, kind, seed):
    """q, k, v, query-major bias, mask (or None) and dO on the card; a
    "random" mask is asymmetric."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, do = (torch.randn(B_ * nW, nh, N, D, device=cuda, generator=g) for _ in range(4))
    bias = torch.randn(nW, nh, N, N, device=cuda, generator=g)
    mask = None
    if kind == "block":
        mask = _block_mask(*lead, N, cuda)
    elif kind == "random":
        mask = 2.0 * torch.randn(*lead, N, N, device=cuda, generator=g)
    return [None if t is None else t.to(dtype).contiguous() for t in (q, k, v, bias, mask, do)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B_, nh, N, D, nW, lead, kind", PACKED_CASES)
def test_packed_kernels_match_plain_on_card(cuda, dtype, B_, nh, N, D, nW, lead, kind):
    """Forward and backward against the plain versions on the CPU, one
    counted launch each, and two backward calls bit-identical."""
    q, k, v, bias, mask, do = _packed_inputs(cuda, dtype, B_, nh, N, D, nW, lead, kind,
                                             seed=N * D + nW)
    counters = (pk.packed_window_attention_fwd, pk.packed_window_attention_bwd)
    before = [c.launches for c in counters]
    out, lse = pk.packed_window_attention_fwd(q, k, v, bias, mask)
    got = pk.packed_window_attention_bwd(q, k, v, bias, mask, out, lse, do)
    again = pk.packed_window_attention_bwd(q, k, v, bias, mask, out, lse, do)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [before[0] + 1, before[1] + 2]
    f32 = [None if t is None else t.float().cpu() for t in (q, k, v, bias, mask)]
    want, want_lse = pk.packed_window_attention_plain(*f32)
    # fp32: other summation orders; bf16: the result is rounded once to bf16
    atol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float().cpu(), want, rtol=0,
                               atol=atol * max(1.0, want.abs().max().item()))
    torch.testing.assert_close(lse.cpu(), want_lse, rtol=0,
                               atol=2e-5 * max(1.0, want_lse.abs().max().item()))
    ref = pk.packed_window_attention_bwd_plain(*f32, out.float().cpu(), lse.cpu(),
                                               do.float().cpu())
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert a.dtype == dtype and a.shape == w.shape, name
        tol = (2e-5 if dtype == torch.float32 else 1e-2) * max(1.0, w.abs().max().item())
        torch.testing.assert_close(a.float().cpu(), w, rtol=0, atol=tol, msg=name)
    for a, b in zip(got, again):  # no atomics: bit-identical
        assert torch.equal(a, b)


# (B_, nh, N, D, nW, mask lead dims, mask kind, route): Pangu's stage-1 and
# stage-2 shapes at a small batch, the round-2 shape, an asymmetric mask,
# and one shape past the fused region
PACKED_ROUTE_CASES = [
    (4, 6, 144, 32, 6, (6, 6), "block", "fused"),
    (4, 12, 144, 32, 3, (3, 3), "block", "fused"),
    (5, 3, 72, 16, 2, (3, 2), "block", "fused"),
    (8, 4, 100, 24, 4, (4, 1), "random", "fused"),
    (4, 2, 200, 32, 2, (2, 2), "random", "four_pass"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B_, nh, N, D, nW, lead, kind, route", PACKED_ROUTE_CASES)
def test_packed_backward_takes_its_route_on_card(cuda, dtype, B_, nh, N, D, nW, lead, kind,
                                                 route):
    """B5's backward runs on the route `bwd_route` names (its fused counter
    moves with it or not at all), matches the plain version on the CPU,
    repeats bit for bit, and on the fused route agrees with the four-pass
    kernels (the module's private launcher) on the same inputs."""
    q, k, v, bias, mask, do = _packed_inputs(cuda, dtype, B_, nh, N, D, nW, lead, kind,
                                             seed=N * D + nh)
    bwd = pk.packed_window_attention_bwd
    out, lse = pk.packed_window_attention_fwd(q, k, v, bias, mask)
    before = (bwd.launches, bwd.fused_launches)
    got = bwd(q, k, v, bias, mask, out, lse, do)
    again = bwd(q, k, v, bias, mask, out, lse, do)
    torch.cuda.synchronize()
    assert (bwd.launches - before[0], bwd.fused_launches - before[1]) == \
        (2, 2 if route == "fused" else 0)
    assert pk._bwd_plan(B_ * nW, nh, N, D, nW)[0] == route
    for a, b in zip(got, again):  # no atomics: bit-identical
        assert torch.equal(a, b)
    f32 = [None if t is None else t.float().cpu() for t in (q, k, v, bias, mask)]
    ref = pk.packed_window_attention_bwd_plain(*f32, out.float().cpu(), lse.cpu(),
                                               do.float().cpu())
    # fp32: other summation orders; bf16: the result is rounded once to bf16
    share = 2e-5 if dtype == torch.float32 else 1e-2
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert a.dtype == dtype and a.shape == w.shape, name
        tol = share * max(1.0, w.abs().max().item())
        torch.testing.assert_close(a.float().cpu(), w, rtol=0, atol=tol, msg=name)
    if route == "fused":
        four = pk._launch_bwd(q, k, v, bias, mask, out, lse, do, route="four_pass")
        torch.cuda.synchronize()
        assert four[4] == "four_pass"
        for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, four[:4]):
            tol = share * max(1.0, w.float().abs().max().item())
            torch.testing.assert_close(a.float(), w.float(), rtol=0, atol=tol, msg=name)


@pytest.mark.cuda
def test_packed_backward_runs_through_the_kernel(cuda):
    """`.backward()` on CUDA tensors launches each kernel once, matches
    autograd through the plain version on the CPU, and leaves the mask
    without a gradient."""
    q, k, v, bias, mask, _ = _packed_inputs(cuda, torch.float32, 3, 2, 72, 16, 2, (3, 2),
                                            "random", 4)
    counters = (pk.packed_window_attention_fwd, pk.packed_window_attention_bwd)
    before = [c.launches for c in counters]
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    pk.packed_window_attention(*leaves, mask).square().sum().backward()
    assert [c.launches for c in counters] == [b + 1 for b in before]
    ref = [t.detach().cpu().clone().requires_grad_() for t in (q, k, v, bias)]
    pk.packed_window_attention(*ref, mask.cpu()).square().sum().backward()
    for a, b in zip(leaves, ref):
        scale = max(1.0, b.grad.abs().max().item())
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=0, atol=2e-5 * scale)


@pytest.mark.cuda
def test_packed_kernels_refuse_what_they_cannot_take(cuda):
    def call(BW, nh, N, D, dtype=torch.float32, bias_dtype=None):
        q = torch.zeros(BW, nh, N, D, device=cuda, dtype=dtype)
        bias = torch.zeros(2, nh, N, N, device=cuda, dtype=bias_dtype or dtype)
        return pk.packed_window_attention_fwd(q, q, q, bias, None)

    with pytest.raises(ValueError, match="head dim"):
        call(4, 2, 16, 12)
    with pytest.raises(ValueError, match="N = 1024"):
        call(2, 1, 1024, 8)
    with pytest.raises(TypeError):
        call(4, 2, 16, 8, torch.float16)
    with pytest.raises(TypeError):  # bias in another dtype than q
        call(4, 2, 16, 8, torch.float32, torch.bfloat16)
    q = torch.zeros(4, 2, 16, 8, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        pk.packed_window_attention_fwd(q, q, q, torch.zeros(2, 2, 16, 16, device=cuda), None)


# ---------------------------------------------------------------- flash backward designs
# (label, B, H, N, D, G or 0 for a 3D bias, bias kind): the Swin train
# path's shapes at batch 32 (stage 0 with a 3D bias and with the shifted
# [1, H, N, N] bias, stage 1), the HEALPix Swin's at nside 8 (the 24 x 32
# rectangle of faces: N 768 and 192), the tail and G = B cases, and D 64,
# the largest head dim the mma design takes
FLASH_DESIGN_CASES = [
    ("stage0 3d", 32, 4, 2048, 24, 0, "random"),
    ("stage0 shifted", 32, 4, 2048, 24, 1, "swin-shift"),
    ("stage1", 32, 4, 512, 48, 0, "random"),
    ("hpx stage0 shifted", 32, 4, 768, 24, 1, "hpx-shift"),
    ("hpx stage1", 32, 4, 192, 48, 0, "random"),
    ("tail N1000 G4", 8, 3, 1000, 32, 4, "random"),
    ("G=B N200 D64", 4, 2, 200, 64, 4, "random"),
]


SHIFT_GRIDS = {"swin-shift": (32, 64), "hpx-shift": (24, 32)}  # the window of each kind


def _flash_design_inputs(cuda, dtype, B, H, N, D, G, kind, seed):
    """q, k, v, bias, out, lse, dO and drow with an lse cotangent folded in
    (drow = rowsum(dO * out) - g_lse), on the card."""
    from dlwpbench_tpu_torch.models.swin import shift_window_groups

    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, N, D, device=cuda, generator=g) for _ in range(4))
    if kind in SHIFT_GRIDS:  # one global window: a table-like bias + the -100 shift mask
        h, w = SHIFT_GRIDS[kind]
        groups = torch.as_tensor(shift_window_groups(h, w, h, w, h // 2, w // 2), device=cuda)
        mask = torch.where(groups[:, None, :] != groups[:, :, None], -100.0, 0.0)
        bias = 0.02 * torch.randn(H, N, N, device=cuda, generator=g) + mask[:, None]
    else:
        bias = torch.randn((H, N, N) if G == 0 else (G, H, N, N), device=cuda, generator=g)
    q, k, v, do, bias = (t.to(dtype).contiguous() for t in (q, k, v, do, bias))
    out, lse = fa.flash_window_attention_fwd(q, k, v, bias)
    g_lse = torch.randn(B, H, 1, N, device=cuda, generator=g)
    drow = (do.float() * out.float()).sum(-1)[:, :, None, :] - g_lse
    return q, k, v, bias, out, lse, do, drow


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label, B, H, N, D, G, kind", FLASH_DESIGN_CASES)
def test_flash_backward_mma_design_on_card(cuda, dtype, label, B, H, N, D, G, kind):
    """The backward at these shapes takes the mma design (its counter moves
    with it), matches the plain version and the row design on the same
    inputs, lse cotangent included, and repeats bit for bit."""
    args = _flash_design_inputs(cuda, dtype, B, H, N, D, G, kind, seed=N + D + G)
    bwd = fa.flash_window_attention_bwd
    before = (bwd.launches, bwd.mma_launches)
    got = bwd(*args)
    again = bwd(*args)
    torch.cuda.synchronize()
    assert fa.bwd_route(N, D) == "mma"
    assert (bwd.launches - before[0], bwd.mma_launches - before[1]) == (2, 2)
    for a, b in zip(got, again):  # no atomics: bit-identical
        assert torch.equal(a, b)
    want = fa.flash_window_attention_bwd_plain(*(a.float() for a in args))
    rows = fa._launch_bwd(*args, route="rows")
    torch.cuda.synchronize()
    assert rows[4] == "rows"
    # a share of max|ref|: fp32 sums over up to 2048 keys and 32 members in
    # other orders; bf16 rounds the fp32 result once
    share = 1e-4 if dtype == torch.float32 else 1e-2
    for name, a, w, r in zip(("dq", "dk", "dv", "dbias"), got, want, rows[:4]):
        assert a.dtype == args[0].dtype and a.shape == w.shape, name
        tol = share * w.abs().max().item()
        torch.testing.assert_close(a.float(), w, rtol=0, atol=tol, msg=name)
        torch.testing.assert_close(a.float(), r.float(), rtol=0, atol=2 * tol, msg=name)


@pytest.mark.cuda
def test_flash_backward_past_the_mma_design_takes_the_rows(cuda):
    """D 72 is past the mma design: the row passes, counted as such."""
    args = _flash_design_inputs(cuda, torch.float32, 2, 2, 100, 72, 2, "random", seed=3)
    bwd = fa.flash_window_attention_bwd
    before = (bwd.launches, bwd.mma_launches)
    got = bwd(*args)
    torch.cuda.synchronize()
    assert (bwd.launches - before[0], bwd.mma_launches - before[1]) == (1, 0)
    want = fa.flash_window_attention_bwd_plain(*(a.float() for a in args))
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-4 * w.abs().max().item(), msg=name)


# ---------------------------------------------------------------- flash forward designs
# (label, B, H, N, D, G or 0 for a 3D bias, bias kind): the Swin paths'
# shapes at batch 32 (stage 0 with a 3D bias and with the shifted
# [1, H, N, N] bias, stage 1; the HEALPix Swin's at nside 8), the tail
# case, Pangu's flash route at
# stage 1 (N 144, G = nLon x nW = 36) and N 60 at D 64, the largest head
# dim the mma design takes
FLASH_FWD_CASES = [
    ("stage0 3d", 32, 4, 2048, 24, 0, "random"),
    ("stage0 shifted", 32, 4, 2048, 24, 1, "swin-shift"),
    ("stage1", 32, 4, 512, 48, 0, "random"),
    ("hpx stage0 shifted", 32, 4, 768, 24, 1, "hpx-shift"),
    ("hpx stage1", 32, 4, 192, 48, 0, "random"),
    ("tail N1000 G4", 8, 3, 1000, 32, 4, "random"),
    ("pangu N144 G36", 72, 6, 144, 32, 36, "random"),
    ("N60 D64", 4, 2, 60, 64, 2, "random"),
]
# fp32: online versus two-pass softmax, sums in another order; bf16: the
# result is rounded once to bf16 (half an ulp is < 4e-3 where |out| < 2,
# the bound grows with max|out| / 2 past that); lse fp32 on both sides
# (chip_smoke.py's FLASH_TOL)
FLASH_FWD_TOL = {torch.float32: (5e-5, 5e-5), torch.bfloat16: (1e-2, 5e-5)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label, B, H, N, D, G, kind", FLASH_FWD_CASES)
def test_flash_forward_mma_design_on_card(cuda, dtype, label, B, H, N, D, G, kind):
    """The forward at these shapes takes the mma design (its counter moves
    with it), matches the plain version and the row design on the same
    inputs, and repeats bit for bit."""
    q, k, v, bias = _flash_design_inputs(cuda, dtype, B, H, N, D, G, kind, seed=N + D + G + 7)[:4]
    fwd = fa.flash_window_attention_fwd
    before = (fwd.launches, fwd.mma_launches)
    out, lse = fwd(q, k, v, bias)
    again = fwd(q, k, v, bias)
    torch.cuda.synchronize()
    assert fa.fwd_route(N, D) == "mma"
    assert (fwd.launches - before[0], fwd.mma_launches - before[1]) == (2, 2)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])  # no atomics
    want, want_lse = fa.flash_window_attention_plain(q.float(), k.float(), v.float(),
                                                     bias.float())
    rows_out, rows_lse, taken = fa._launch_fwd(q, k, v, bias, route="rows")
    torch.cuda.synchronize()
    assert taken == "rows" and out.dtype == dtype and lse.dtype == torch.float32
    out_tol, lse_tol = FLASH_FWD_TOL[dtype]
    atol = out_tol * (1.0 if dtype == torch.float32 else max(1.0, want.abs().max().item() / 2))
    torch.testing.assert_close(out.float(), want, rtol=0, atol=atol)
    torch.testing.assert_close(out.float(), rows_out.float(), rtol=0, atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=lse_tol)
    torch.testing.assert_close(lse, rows_lse, rtol=0, atol=lse_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_past_the_mma_design_takes_the_rows(cuda, dtype):
    """D 72 is past the mma design: the row kernel, counted as such."""
    q, k, v, bias = _flash_design_inputs(cuda, dtype, 4, 2, 100, 72, 2, "random", seed=9)[:4]
    fwd = fa.flash_window_attention_fwd
    before = (fwd.launches, fwd.mma_launches)
    out, lse = fwd(q, k, v, bias)
    torch.cuda.synchronize()
    assert fa.fwd_route(100, 72) == "rows"
    assert (fwd.launches - before[0], fwd.mma_launches - before[1]) == (1, 0)
    want, want_lse = fa.flash_window_attention_plain(q.float(), k.float(), v.float(),
                                                     bias.float())
    out_tol, lse_tol = FLASH_FWD_TOL[dtype]
    atol = out_tol * (1.0 if dtype == torch.float32 else max(1.0, want.abs().max().item() / 2))
    torch.testing.assert_close(out.float(), want, rtol=0, atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=lse_tol)


# ---------------------------------------------------------------- B5's forward designs
# (B_, nh, N, D, nW, mask lead dims, mask kind, route): Pangu's stage-1 and
# stage-2 shapes at a small batch, an asymmetric N 100 mask, and a shape
# past the fused region
PACKED_FORWARD_CASES = [
    (6, 6, 144, 32, 6, (6, 6), "block", "fused"),
    (6, 12, 144, 32, 3, (3, 3), "block", "fused"),
    (8, 4, 100, 24, 4, (4, 1), "random", "fused"),
    (4, 2, 200, 32, 2, (2, 2), "random", "row"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B_, nh, N, D, nW, lead, kind, route", PACKED_FORWARD_CASES)
def test_packed_forward_takes_its_route_on_card(cuda, dtype, B_, nh, N, D, nW, lead, kind,
                                                route):
    """B5's forward runs on the route `fwd_route` names (its fused counter
    moves with it or not at all), matches the plain version on the CPU, and
    on the fused route agrees with the row kernel (the module's private
    launcher) on the same inputs."""
    q, k, v, bias, mask, _ = _packed_inputs(cuda, dtype, B_, nh, N, D, nW, lead, kind,
                                            seed=N * D + nW + 1)
    fwd = pk.packed_window_attention_fwd
    before = (fwd.launches, fwd.fused_launches)
    out, lse = fwd(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert wa.fwd_route(N, D) == route
    assert (fwd.launches - before[0], fwd.fused_launches - before[1]) == \
        (1, 1 if route == "fused" else 0)
    f32 = [t.float().cpu() for t in (q, k, v, bias, mask)]
    want, want_lse = pk.packed_window_attention_plain(*f32)
    # fp32: other summation orders; bf16: the result is rounded once to bf16
    atol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float().cpu(), want, rtol=0,
                               atol=atol * max(1.0, want.abs().max().item()))
    torch.testing.assert_close(lse.cpu(), want_lse, rtol=0,
                               atol=2e-5 * max(1.0, want_lse.abs().max().item()))
    if route == "fused":
        row_out, row_lse, taken = pk._launch_fwd(q, k, v, bias, mask, route="row")
        torch.cuda.synchronize()
        assert taken == "row"
        # both results rounded: up to one bf16 ulp apart
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(out.float(), row_out.float(), rtol=0,
                                   atol=(atol if dtype == torch.float32 else 4 * atol) * scale)
        torch.testing.assert_close(lse, row_lse, rtol=0,
                                   atol=2e-5 * max(1.0, want_lse.abs().max().item()))


# ---------------------------------------------------------------- bf16 instances and the prefetch
def _entry_case(cuda, dtype, family):
    """(differentiable call, its inputs with requires_grad, forward counter,
    backward counter) of one kernel family at a small model-like shape."""
    g = torch.Generator(device=cuda).manual_seed(11)
    rnd = lambda *s: torch.randn(*s, device=cuda, generator=g).to(dtype)  # noqa: E731
    if family == "flash":
        args = [rnd(2, 2, 64, 24) for _ in range(3)] + [rnd(2, 64, 64)]
        return fa.flash_window_attention, args, (), fa.flash_window_attention_fwd, \
            fa.flash_window_attention_bwd
    if family == "token-major":
        args = [rnd(2, 1, 4, 64, 144), rnd(1, 2, 64, 64)]
        return wa.window_attention_qkv, args, (None, 2), wa.window_attention_qkv_fwd, \
            wa.window_attention_qkv_bwd
    if family == "5d":
        args = [rnd(2, 2, 12, 24, 192), rnd(2, 2, 144, 144)]
        return wa.window_attention_qkv5d, args, (None, 2, (2, 6, 12)), \
            wa.window_attention_qkv5d_fwd, wa.window_attention_qkv5d_bwd
    args = [rnd(4, 2, 64, 24) for _ in range(3)] + [rnd(2, 2, 64, 64)]
    return pk.packed_window_attention, args, (), pk.packed_window_attention_fwd, \
        pk.packed_window_attention_bwd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", ["flash", "token-major", "5d", "packed"])
def test_bf16_instances_are_counted_on_card(cuda, dtype, family):
    """Forward and backward through each differentiable entry launch once
    each way, and `.bf16_launches` counts them in bf16 only."""
    fn, args, extra, fwd, bwd = _entry_case(cuda, dtype, family)
    leaves = [a.requires_grad_() for a in args]
    before = [(c.launches, c.bf16_launches) for c in (fwd, bwd)]
    out = fn(*leaves, *extra)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    bf16 = int(dtype == torch.bfloat16)
    assert [(c.launches - b[0], c.bf16_launches - b[1]) for c, b in zip((fwd, bwd), before)] \
        == [(1, bf16), (1, bf16)]
    assert all(leaf.grad.dtype == dtype and torch.isfinite(leaf.grad.float()).all()
               for leaf in leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["flash", "token-major", "5d", "packed"])
def test_a_dtype_mix_raises_on_card(cuda, family):
    """bf16 activations with an fp32 bias reach the wrapper and raise: the
    models must build their constants in the compute dtype."""
    fn, args, extra, _, _ = _entry_case(cuda, torch.bfloat16, family)
    args[-1] = args[-1].float()
    with pytest.raises(TypeError):
        fn(*args, *extra)


@pytest.mark.cuda
def test_prefetch_on_card_copies_in_order_without_a_sync(cuda):
    """The batches arrive on the card, in order and equal to the host's,
    the short last one included, and staging them syncs nothing."""
    import numpy as np

    from dlwpbench_tpu_torch.training.trainer import prefetch_to_device

    rng = np.random.default_rng(0)
    batches = [(None, rng.standard_normal((n, 3, 4)).astype(np.float32),
                rng.standard_normal((n, 2, 4)).astype(np.float32)) for n in (4, 4, 4, 2)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [tuple(None if t is None else t.clone() for t in b)
               for b in prefetch_to_device(iter(batches), cuda)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        assert g[0] is None and all(t.device.type == "cuda" for t in g[1:])
        for t, a in zip(g[1:], b[1:]):
            assert np.array_equal(t.cpu().numpy(), a)


@pytest.mark.cuda
def test_native_batches_through_the_prefetch_on_card(cuda):
    """Shuffled, noisy batches of the native batcher (and one window past
    the data end, on the per-item path) reach the card through the
    prefetch equal to the host's batches from a twin dataset, bit for bit,
    without a sync while they are staged."""
    import numpy as np

    from dlwpbench_tpu_torch.data.dataset import WindowedWeatherDataset, synthetic_weatherbench
    from dlwpbench_tpu_torch.training.trainer import prefetch_to_device

    const, pres, prog = synthetic_weatherbench(n_time=300, nlat=32, nlon=64, seed=5)

    def twin():
        return WindowedWeatherDataset(prognostic=prog, constants=const, prescribed=pres,
                                      sequence_length=3, noise=0.1, seed=9)

    ds_host, ds_card = twin(), twin()
    host = [b for _ in range(2) for b in ds_host.batches(8, shuffle=True)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [tuple(None if t is None else t.clone() for t in b)
               for _ in range(2)
               for b in prefetch_to_device(ds_card.batches(8, shuffle=True), cuda)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ends = WindowedWeatherDataset(prognostic=prog, constants=const, prescribed=pres,
                                  sequence_length=3, init_indices=[0, 296, 10])
    host += list(ends.batches(3))
    got += [tuple(t.clone() for t in b) for b in prefetch_to_device(ends.batches(3), cuda)]
    assert len(got) == len(host) > 2
    for g, h in zip(got, host):
        for t, a in zip(g, h):
            assert t.device.type == "cuda" and np.array_equal(t.cpu().numpy(), a)


# ---------------------------------------------------------------- the ModernUNet family
MUNET = dict(constant_channels=2, prescribed_channels=1, prognostic_channels=2,
             hidden_channels=(8, 16), context_size=2, norm=True)


@pytest.fixture
def cuda_fp32(cuda):
    """The card with fp32 convolutions: cuDNN's TF32 off, as the entry
    points set it."""
    torch.backends.cudnn.allow_tf32 = False
    return cuda


@pytest.mark.cuda
@pytest.mark.parametrize("cls_name, kw", [("ModernUNet", dict(attention=True)),
                                          ("MUNetHPX", dict(variant="reference"))])
def test_modern_unet_on_card_matches_cpu(cuda_fp32, cls_name, kw):
    """cuDNN convs, GroupNorm and the attention block's plain ops on the
    card against the CPU: a 2-step rollout within 1e-4 of max; no
    attention kernel launches."""
    from dlwpbench_tpu_torch.models import modern_unet as mu

    spatial = (12, 4, 4) if cls_name == "MUNetHPX" else (8, 16)
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(2, t, c, *spatial, generator=g) for t, c in ((1, 2), (4, 1), (4, 2))]
    model = getattr(mu, cls_name)(**MUNET, **kw, seed=1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
        ref = model(*args)
        before = fa.flash_window_attention_fwd.launches
        got = model.to(cuda_fp32)(*(a.to(cuda_fp32) for a in args)).cpu()
    assert fa.flash_window_attention_fwd.launches == before
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["mean", "reference"])
def test_diffusion_rollout_on_card_matches_cpu_with_the_same_noise(cuda_fp32, sampler):
    from dlwpbench_tpu_torch.models import modern_unet as mu

    g = torch.Generator().manual_seed(1)
    args = [torch.randn(2, t, c, 8, 16, generator=g) for t, c in ((1, 2), (4, 1), (4, 2))]
    noise = [[torch.randn(2, 1, 2, 8, 16, generator=g) for _ in range(6)] for _ in range(2)]
    model = mu.DiffModernUNet(**MUNET, sampler=sampler, seed=2)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
        ref = model(*args, noise=noise)
        got = model.to(cuda_fp32)(*(a.to(cuda_fp32) for a in args),
                                  noise=[[z.to(cuda_fp32) for z in step] for step in noise]).cpu()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.cuda
def test_diffusion_epoch_on_card_reads_nothing_back(cuda):
    """A diffusion training epoch's steps (k on the host, the noise on the
    card, the EMA update) under set_sync_debug_mode("error")."""
    import numpy as np

    from dlwpbench_tpu_torch.data.dataset import WindowedWeatherDataset
    from dlwpbench_tpu_torch.models import modern_unet as mu
    from dlwpbench_tpu_torch.training.trainer import Trainer

    rng = np.random.default_rng(0)
    ds = WindowedWeatherDataset(
        prognostic=rng.standard_normal((20, 2, 8, 16)).astype(np.float32),
        prescribed=rng.standard_normal((20, 1, 8, 16)).astype(np.float32),
        constants=rng.standard_normal((2, 8, 16)).astype(np.float32),
        sequence_length=3, context_size=2)
    trainer = Trainer(mu.DiffModernUNet(**MUNET, seed=3).to(cuda), training_type="diffusion")
    state = trainer.init()
    trainer.train_epoch(state, ds, 4)  # warm-up: cuDNN, the schedule's tables
    close = trainer._close_epoch

    def close_after_steps(*a):
        torch.cuda.set_sync_debug_mode("default")
        return close(*a)

    trainer._close_epoch = close_after_steps
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = trainer.train_epoch(state, ds, 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(loss) and state.iteration == 2 * len(list(ds.batches(4)))
