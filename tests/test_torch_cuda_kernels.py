"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from dlwpbench_tpu_torch.ops import flash_attention as fa


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
