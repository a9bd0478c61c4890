"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from dlwpbench_tpu_torch.ops import flash_attention as fa
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout, shape, nh, win, bW, lead", WINDOW_CASES)
def test_window_kernels_match_plain_on_card(cuda, dtype, layout, shape, nh, win, bW, lead):
    """Forward and backward of both layouts against their plain versions,
    one counted launch each, and two backward calls bit-identical."""
    qkv, bias, mask, dout = _window_inputs(cuda, dtype, layout, shape, nh, win, bW, lead,
                                           seed=sum(shape) + bW)
    counters = ((wa.window_attention_qkv5d_fwd, wa.window_attention_qkv5d_bwd) if layout == "5d"
                else (wa.window_attention_qkv_fwd, wa.window_attention_qkv_bwd))
    before = [c.launches for c in counters]
    out, lse = _fwd(layout, qkv, bias, mask, nh, win)
    got = _bwd(layout, qkv, bias, mask, out, lse, dout, win)
    again = _bwd(layout, qkv, bias, mask, out, lse, dout, win)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [before[0] + 1, before[1] + 2]
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
