"""Flash window attention: the CUDA kernels' wrappers and their plain versions.

Counterpart of `dlwpbench_tpu/ops/pallas_attention.py`'s
`reference_attention` (`:31-42`), `_flash_impl` (`:200-295`), the backward
`_flash_bwd_panel` (`:396-486`) and `_flash_bwd_impl` (`:640-793`), and the
differentiable entries `flash_window_attention` (`:1124`) and
`flash_window_attention_lse` (`:840`).  Computes

    out = softmax(q k^T * D^-1/2 + bias[b % G]) v,   lse = logsumexp(scores)

for q, k, v [B, H, N, D] and bias [H, N, N] (shared) or [G, H, N, N]
(selected as b % G).  The scale is applied inside; callers do not
pre-scale.

For a CUDA tensor each wrapper launches its hand-written kernel
(`csrc/flash_window_attention.cu` forward, `csrc/flash_window_attention_bwd.cu`
backward, built at first use) or raises: on an unsupported dtype, head
dim, layout, a failed build or a failed launch.  Each has two designs,
chosen from the head dim by `fwd_route` and `bwd_route`: on the tensor
cores (3xTF32 `mma.sync`; the forward in one pass, the backward in three)
for D <= 64, every model path, and on the fp32 CUDA cores (one row of
queries or keys a thread) for the rest.  The plain versions run
only for tensors on the CPU.  `flash_window_attention` and
`flash_window_attention_lse` are `torch.autograd.Function`s whose backward
goes through `flash_window_attention_bwd`; the raw
`flash_window_attention_fwd` is not differentiable on CUDA tensors.
Each wrapper counts its launches in `.launches`, those of the tensor-core
design in `.mma_launches` and those of the bf16 instance in
`.bf16_launches`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dlwpbench_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MMA_MAX_HEAD_DIM = 64  # the tensor-core designs (`fwd_route`, `bwd_route`)


def _check_shapes(q, k, v, bias) -> int:
    """Validate shapes; returns the bias group count G."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one [B, H, N, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, N, _ = q.shape
    if bias.ndim == 3:
        G, tail = 1, tuple(bias.shape)
    elif bias.ndim == 4:
        G, tail = bias.shape[0], tuple(bias.shape[1:])
    else:
        raise ValueError(f"bias must be [H,N,N] or [G,H,N,N], got {tuple(bias.shape)}")
    if tail != (H, N, N) or G < 1 or B % G:
        raise ValueError(
            f"bias {tuple(bias.shape)} does not fit q {tuple(q.shape)} "
            "(need [H,N,N] or [G,H,N,N] with B % G == 0)"
        )
    return G


def flash_window_attention_plain(q, k, v, bias):
    """Plain PyTorch version: two-pass softmax over the full [N, N] scores,
    in fp32 whatever the input type.  Returns (out [B,H,N,D] in q's dtype,
    lse [B,H,1,N] fp32)."""
    G = _check_shapes(q, k, v, bias)
    B, H, N, D = q.shape
    s = torch.einsum("bhnd,bhmd->bhnm", q.float() * D**-0.5, k.float())
    bias4 = bias.float().reshape(G, H, N, N)
    s = (s.reshape(B // G, G, H, N, N) + bias4[None]).reshape(B, H, N, N)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhnm,bhmd->bhnd", p, v.float())
    return out.to(q.dtype), lse[:, :, None, :]


def flash_window_attention_bwd_plain(q, k, v, bias, out, lse, do, drow):
    """Plain PyTorch backward: full [N, N] scores, fp32 whatever the input
    type.  `lse` and `drow` are [B,H,1,N] fp32, with drow = rowsum(do * out)
    (minus the lse cotangent); `out` is part of the signature the kernel
    shares and is not read.  Returns (dq, dk, dv in q's dtype, dbias in the
    bias's dtype and shape, summed over the members b = g + m*G)."""
    G = _check_shapes(q, k, v, bias)
    B, H, N, D = q.shape
    scale = D**-0.5
    qs, kf, vf, dof = q.float() * scale, k.float(), v.float(), do.float()
    s = torch.einsum("bhnd,bhmd->bhnm", qs, kf)
    s = (s.reshape(B // G, G, H, N, N) + bias.float().reshape(G, H, N, N)[None]).reshape(B, H, N, N)
    p = torch.exp(s - lse.float()[:, :, 0, :, None])
    dv = torch.einsum("bhnm,bhnd->bhmd", p, dof)
    dp = torch.einsum("bhnd,bhmd->bhnm", dof, vf)
    ds = p * (dp - drow.float()[:, :, 0, :, None])
    dq = torch.einsum("bhnm,bhmd->bhnd", ds, kf) * scale
    dk = torch.einsum("bhnm,bhnd->bhmd", ds, qs)
    dbias = ds.reshape(B // G, G, H, N, N).sum(0).reshape(bias.shape)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias.to(bias.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fn(source: str, symbol: str, n_ptr: int, n_int: int):
    """The C entry point `symbol` of `csrc/<source>.cu`: n_ptr pointers,
    n_int ints, then the stream; returns cudaGetLastError()."""
    fn = getattr(_build.load(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(name, tensors) -> None:
    """What both kernels take: one CUDA device, all float32 or all
    bfloat16, head dim a multiple of 8 up to 128, contiguous."""
    D = tensors[0].shape[-1]
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODE or any(t.dtype != dtype for t in tensors):
        raise TypeError(
            f"{name} takes q, k, v, bias (and dO) all float32 or all bfloat16, got "
            f"{[str(t.dtype) for t in tensors]}"
        )
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} unsupported: need a multiple of 8 <= {MAX_HEAD_DIM}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: q, k, v, bias (and dO) must be contiguous")


def _device_of(tensors):
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention for device {dev}")
    return dev


def fwd_route(N, D):
    """Which forward design takes q [.., N, D]: "mma" (one pass on the
    tensor cores, 3xTF32, for head dims up to MMA_MAX_HEAD_DIM at any N:
    K and V tiles of 64 x (D + 4) {big, small} pairs and the next tiles as
    copied in shared memory, 102 KB at D 64, and the warp's Q fragments
    and O accumulator in registers) or "rows" (the fp32 CUDA cores, head
    dims up to MAX_HEAD_DIM).  Decided from the shape before the launch,
    never as a retry; N does not enter the choice."""
    del N
    return "mma" if D <= MMA_MAX_HEAD_DIM else "rows"


def _launch_fwd(q, k, v, bias, route=None):
    """Launches the forward of `route` ("mma" or "rows"; by default the one
    `fwd_route` names, as the public wrapper takes it) on checked CUDA
    tensors; returns (out, lse, route)."""
    B, H, N, D = q.shape
    G = _check_shapes(q, k, v, bias)
    route = route or fwd_route(N, D)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, 1, N), dtype=torch.float32, device=q.device)
    symbol = "flash_window_attention_fwd_mma" if route == "mma" else "flash_window_attention_fwd"
    fn = _kernel_fn("flash_window_attention", symbol, 6, 6)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, H, N, D, G,
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_window_attention_fwd: CUDA error {err} on the {route} route for q "
            f"{tuple(q.shape)} {q.dtype}, bias {tuple(bias.shape)}"
        )
    return out, lse, route


def flash_window_attention_fwd(q, k, v, bias):
    """(out, lse): out [B,H,N,D] in q's dtype, lse [B,H,1,N] fp32.

    CPU tensors take the plain version; CUDA tensors the kernel of
    `csrc/flash_window_attention.cu` in the design `fwd_route` names, its
    launches counted in `flash_window_attention_fwd.launches` and those of
    the "mma" design in `flash_window_attention_fwd.mma_launches`.  Not
    differentiable on CUDA tensors: use `flash_window_attention` or
    `flash_window_attention_lse` for gradients."""
    _check_shapes(q, k, v, bias)
    if _device_of((q, k, v, bias)).type == "cpu":
        return flash_window_attention_plain(q, k, v, bias)
    _check_cuda("flash_window_attention_fwd", (q, k, v, bias))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        raise NotImplementedError(
            "flash_window_attention_fwd is not differentiable; call "
            "flash_window_attention (or flash_window_attention_lse), whose "
            "backward launches the CUDA backward kernels"
        )
    out, lse, route = _launch_fwd(q, k, v, bias)
    flash_window_attention_fwd.launches += 1
    flash_window_attention_fwd.bf16_launches += q.dtype == torch.bfloat16
    flash_window_attention_fwd.mma_launches += route == "mma"
    return out, lse


flash_window_attention_fwd.launches = 0
flash_window_attention_fwd.bf16_launches = 0
flash_window_attention_fwd.mma_launches = 0


def bwd_route(N, D):
    """Which backward design takes q [.., N, D]: "mma" (three passes on the
    tensor cores, 3xTF32, for head dims up to MMA_MAX_HEAD_DIM at any N:
    four operand tiles of 64 x (D + 4) {big, small} pairs in shared memory,
    139 KB at D 64, and the dK/dV accumulators in registers) or "rows"
    (three passes on the fp32 CUDA cores, head dims up to MAX_HEAD_DIM).
    Decided from the shape before the launch, never as a retry; N does not
    enter the choice."""
    del N
    return "mma" if D <= MMA_MAX_HEAD_DIM else "rows"


def _launch_bwd(q, k, v, bias, out, lse, do, drow, route=None):
    """Launches the backward of `route` ("mma" or "rows"; by default the one
    `bwd_route` names, as the public wrapper takes it) on checked CUDA
    tensors; returns (dq, dk, dv, dbias, route)."""
    B, H, N, D = q.shape
    G = _check_shapes(q, k, v, bias)
    route = route or bwd_route(N, D)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty_like(bias)
    symbol = "flash_window_attention_bwd_mma" if route == "mma" else "flash_window_attention_bwd"
    fn = _kernel_fn("flash_window_attention_bwd", symbol, 11, 6)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), do.data_ptr(),
            lse.data_ptr(), drow.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dbias.data_ptr(), B, H, N, D, G,
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_window_attention_bwd: CUDA error {err} on the {route} route for q "
            f"{tuple(q.shape)} {q.dtype}, bias {tuple(bias.shape)}"
        )
    return dq, dk, dv, dbias, route


def flash_window_attention_bwd(q, k, v, bias, out, lse, do, drow):
    """(dq, dk, dv, dbias) of `flash_window_attention_fwd`; see
    `flash_window_attention_bwd_plain` for the arguments.

    CPU tensors take the plain version; CUDA tensors the kernels of
    `csrc/flash_window_attention_bwd.cu` in the design `bwd_route` names:
    one counted launch in `flash_window_attention_bwd.launches` runs all its
    passes, and `flash_window_attention_bwd.mma_launches` counts those of
    the "mma" design."""
    _check_shapes(q, k, v, bias)
    B, H, N, D = q.shape
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"dO {tuple(do.shape)} does not match q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("drow", drow)):
        if tuple(t.shape) != (B, H, 1, N):
            raise ValueError(f"{name} must be [B,H,1,N] = {(B, H, 1, N)}, got {tuple(t.shape)}")
    if _device_of((q, k, v, bias, do, lse, drow)).type == "cpu":
        return flash_window_attention_bwd_plain(q, k, v, bias, out, lse, do, drow)
    _check_cuda("flash_window_attention_bwd", (q, k, v, bias, do))
    if lse.dtype != torch.float32 or drow.dtype != torch.float32:
        raise TypeError(f"lse and drow must be float32, got {lse.dtype}, {drow.dtype}")
    dq, dk, dv, dbias, route = _launch_bwd(q, k, v, bias, out, lse.contiguous(), do,
                                           drow.contiguous())
    flash_window_attention_bwd.launches += 1
    flash_window_attention_bwd.bf16_launches += q.dtype == torch.bfloat16
    flash_window_attention_bwd.mma_launches += route == "mma"
    return dq, dk, dv, dbias


flash_window_attention_bwd.launches = 0
flash_window_attention_bwd.bf16_launches = 0
flash_window_attention_bwd.mma_launches = 0


class _FlashWindowAttention(torch.autograd.Function):
    """(out, lse) with the fused backward: the counterpart of `_flash_diff`
    and `_flash_lse_diff` (`pallas_attention.py:796-837`)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        out, lse = flash_window_attention_fwd(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        # drow = rowsum(dO * O), [B,H,1,N] lane-major like lse; the lse
        # cotangent folds in as ds = p * (dp - (drow - g_lse)) (`:654-659`)
        drow = (g_out.float() * out.float()).sum(-1)[:, :, None, :]
        if g_lse is not None:
            drow = drow - g_lse.float()
        return flash_window_attention_bwd(
            q, k, v, bias, out, lse, g_out.contiguous(), drow
        )


def flash_window_attention_lse(q, k, v, bias):
    """Differentiable (out [B,H,N,D], lse [B,H,1,N] fp32); gradients flow
    through both outputs."""
    return _FlashWindowAttention.apply(q, k, v, bias)


def flash_window_attention(q, k, v, bias):
    """Differentiable attention output [B,H,N,D]; see
    `flash_window_attention_fwd`."""
    return _FlashWindowAttention.apply(q, k, v, bias)[0]
