"""Packed small-window attention: the CUDA kernels' wrappers and their
plain versions.

Counterpart of `dlwpbench_tpu/ops/pallas_attention.py`'s
`packed_window_attention` (`:1097`; forward `_packed_impl` `:967`, fused
backward `_packed_bwd` `:1033`, differentiable `_packed_diff` `:1019`).  For
problem p of q, k, v [BW, nh, N, D], laid out as p = b_ * nW + w with
b_ = sample * nLon + lon (the `window_partition_3d` batch layout), and head h:

    s   = q k^T * D^-1/2 + bias[p % nW, h] + mask[(p // nW) % nLon, p % nW or 0]
    out = softmax(s) v,   lse = logsumexp(s)

bias [nW, nh, N, N] and mask [nLon, nW or 1, N, N] are QUERY-major, as in
the JAX API (its kernel transposes both), and the mask may be any additive
mask, symmetric or not.  A None mask is a zero [1, 1, N, N] mask.  BW must
be a whole number of nW-window groups: the JAX backward's grid runs over
BW // nW members and leaves the last BW % nW problems without gradients,
so the port raises instead.

For a CUDA tensor each wrapper launches its hand-written kernel
(`csrc/packed_window_attention.cu`, built at first use) or raises: on an
unsupported dtype, head dim, N, layout, a failed build or a failed launch.
Both launchers are registered operators
(`torch.ops.dlwpbench_torch.packed_window_attention_fwd` and `_bwd`) with
fake implementations, as the other kernels' are.  Forward and backward have the window kernels' two designs, chosen from
(N, D) by `window_attention.fwd_route` and `bwd_route`: the fused
tensor-core kernels for N <= 144 and D <= 48 (every Pangu shape), the row
kernels (the backward's in four passes) for the rest.  The
plain versions run only for tensors on the CPU.  The differentiable
entry `packed_window_attention` is a `torch.autograd.Function` whose
backward goes through `packed_window_attention_bwd`; the mask is a
constant and gets no gradient.  Each wrapper counts its launches in
`.launches`, those of the fused design in `.fused_launches` and those of
the bf16 instance in `.bf16_launches`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from dlwpbench_tpu_torch.ops.flash_attention import _DTYPE_CODE, _device_of, _kernel_fn, sdpa_flops
from dlwpbench_tpu_torch.ops.window_attention import (
    _bwd_chunks,
    _check_cuda,
    _fused_chunks,
    _zero_mask,
    bwd_route,
    fwd_route,
)

_SOURCE = "packed_window_attention"


def _check_shapes(q, k, v, bias, mask) -> int:
    """Validate shapes; returns the window-type count nW."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [BW, nh, N, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BW, nh, N, _ = q.shape
    if bias.ndim != 4 or tuple(bias.shape[1:]) != (nh, N, N) or bias.shape[0] < 1:
        raise ValueError(f"bias must be [nW, nh, N, N] with nh {nh}, N {N}, got "
                         f"{tuple(bias.shape)}")
    nW = bias.shape[0]
    if BW % nW:
        raise ValueError(f"BW = {BW} problems are not whole groups of nW = {nW} "
                         "window types (BW % nW != 0)")
    if mask is not None:
        if mask.ndim != 4 or tuple(mask.shape[2:]) != (N, N) or mask.shape[0] < 1:
            raise ValueError(f"mask must be [nLon, nW or 1, {N}, {N}], got {tuple(mask.shape)}")
        if mask.shape[1] not in (1, nW):
            raise ValueError(f"mask window axis {mask.shape[1]} must be 1 or match bias nW={nW}")
    return nW


# ---------------------------------------------------------------- plain versions
def _scores(qs, kf, bias, mask):
    """fp32 scores [BW, nh, N, N] of pre-scaled fp32 q and fp32 k, with the
    bias of each problem's window type and the mask of its (lon, w)."""
    BW, nh, N, _ = qs.shape
    nW = bias.shape[0]
    s = torch.einsum("bhnd,bhmd->bhnm", qs, kf).reshape(BW // nW, nW, nh, N, N)
    s = s + bias.float()[None]
    if mask is not None:
        lon = torch.arange(BW // nW, device=qs.device) % mask.shape[0]
        s = s + mask.float()[lon][:, :, None]  # [B_, nW or 1, 1, N, N]
    return s.reshape(BW, nh, N, N)


def packed_window_attention_plain(q, k, v, bias, mask):
    """Plain PyTorch version: two-pass softmax over the full [N, N] scores,
    in fp32 whatever the input type.  Returns (out [BW,nh,N,D] in q's dtype,
    lse [BW,nh,1,N] fp32)."""
    _check_shapes(q, k, v, bias, mask)
    D = q.shape[-1]
    s = _scores(q.float() * D**-0.5, k.float(), bias, mask)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhnm,bhmd->bhnd", p, v.float())
    return out.to(q.dtype), lse[:, :, None, :]


def packed_window_attention_bwd_plain(q, k, v, bias, mask, out, lse, do):
    """Plain PyTorch backward of `packed_window_attention_plain`, fp32
    whatever the input type, with drow = rowsum(do * out).  Returns (dq, dk,
    dv in their inputs' dtypes, dbias [nW,nh,N,N] in the bias's dtype, summed
    over the BW / nW problems of each window type)."""
    nW = _check_shapes(q, k, v, bias, mask)
    BW, nh, N, D = q.shape
    scale = D**-0.5
    qs, kf, vf, dof = q.float() * scale, k.float(), v.float(), do.float()
    p = torch.exp(_scores(qs, kf, bias, mask) - lse.float()[:, :, 0, :, None])
    drow = (dof * out.float()).sum(-1)
    dv = torch.einsum("bhnm,bhnd->bhmd", p, dof)
    dp = torch.einsum("bhnd,bhmd->bhnm", dof, vf)
    ds = p * (dp - drow[..., None])
    dq = torch.einsum("bhnm,bhmd->bhnd", ds, kf) * scale
    dk = torch.einsum("bhnm,bhnd->bhmd", ds, qs)
    dbias = ds.reshape(BW // nW, nW, nh, N, N).sum(0)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias.to(bias.dtype)


# ---------------------------------------------------------------- CUDA wrappers
def _launch_fwd(q, k, v, bias, mask, route=None):
    """Launches the forward of `route` ("fused" or "row"; by default the
    one `fwd_route` names, as the public wrapper takes it) on checked CUDA
    tensors, mask not None; returns (out, lse, route)."""
    BW, nh, N, D = q.shape
    route = route or fwd_route(N, D)
    out = torch.empty_like(q)
    lse = torch.empty((BW, nh, 1, N), dtype=torch.float32, device=q.device)
    symbol = "packed_window_attention_fwd_fused" if route == "fused" else "packed_window_attention_fwd"
    fn = _kernel_fn(_SOURCE, symbol, 7, 8)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), BW, nh, N, D, bias.shape[0], mask.shape[0],
                 mask.shape[1], _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"packed_window_attention_fwd: CUDA error {err} on the {route} route "
                           f"for q {tuple(q.shape)} {q.dtype}, bias {tuple(bias.shape)}, "
                           f"mask {tuple(mask.shape)}")
    return out, lse, route


def packed_window_attention_fwd(q, k, v, bias, mask):
    """(out [BW,nh,N,D], lse [BW,nh,1,N] fp32).

    Calls the registered operator `dlwpbench_torch::packed_window_attention_fwd`
    (so `torch.export` keeps the call, not its body): CPU tensors take the
    plain version; CUDA tensors the kernel of `fwd_route`'s design, whose
    launches are counted in `packed_window_attention_fwd.launches`, and
    those of the fused route in `.fused_launches` too.  Not differentiable
    on CUDA tensors: use `packed_window_attention` (on CPU tensors that need
    gradients it is the plain version, differentiated by autograd)."""
    _check_shapes(q, k, v, bias, mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        if _device_of((q, k, v, bias) + (() if mask is None else (mask,))).type == "cpu":
            return packed_window_attention_plain(q, k, v, bias, mask)
        raise NotImplementedError(
            "packed_window_attention_fwd is not differentiable; call "
            "packed_window_attention, whose backward launches the CUDA backward kernels")
    return torch.ops.dlwpbench_torch.packed_window_attention_fwd(q, k, v, bias, mask)


@torch.library.custom_op("dlwpbench_torch::packed_window_attention_fwd", mutates_args=())
def _packed_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                   mask: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """The registered forward: the plain version on CPU tensors, the
    counted kernel launch on CUDA ones."""
    _check_shapes(q, k, v, bias, mask)
    if _device_of((q, k, v, bias) + (() if mask is None else (mask,))).type == "cpu":
        return packed_window_attention_plain(q, k, v, bias, mask)
    N, D = q.shape[2:]
    mask = _zero_mask(N, q) if mask is None else mask
    _check_cuda("packed_window_attention_fwd", (q, k, v, bias, mask), D, N)
    out, lse, route = _launch_fwd(q, k, v, bias, mask)
    packed_window_attention_fwd.launches += 1
    packed_window_attention_fwd.bf16_launches += q.dtype == torch.bfloat16
    packed_window_attention_fwd.fused_launches += route == "fused"
    return out, lse


@_packed_fwd_op.register_fake
def _(q, k, v, bias, mask):
    BW, nh, N, _ = q.shape
    return torch.empty_like(q), q.new_empty((BW, nh, 1, N), dtype=torch.float32)


@register_flop_formula(torch.ops.dlwpbench_torch.packed_window_attention_fwd)
def _(q, k, v, bias, mask, out_shape=None, **kwargs):
    return sdpa_flops(q[0] * q[1], q[2], k[2], q[3])


packed_window_attention_fwd.launches = 0
packed_window_attention_fwd.bf16_launches = 0
packed_window_attention_fwd.fused_launches = 0


def _bwd_plan(BW, nh, N, D, nW, route=None):
    """(route, n_chunks) of a backward launch: the design `bwd_route`
    names (or `route`), and how many chunks of its BW / nW problems each
    window type's dbias sum is split into, by that design's rule."""
    route = route or bwd_route(N, D)
    chunks = _fused_chunks if route == "fused" else _bwd_chunks
    return route, chunks(nW, nh, BW // nW)


def _launch_bwd(q, k, v, bias, mask, out, lse, do, route=None):
    """Launches the backward of `route` ("fused" or "four_pass"; by default
    the one `bwd_route` names, as the public wrapper takes it) on checked
    CUDA tensors, mask not None; returns (dq, dk, dv, dbias, route)."""
    BW, nh, N, D = q.shape
    nW = bias.shape[0]
    route, n_chunks = _bwd_plan(BW, nh, N, D, nW, route)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty_like(bias)
    tensors = [q, k, v, bias, mask, out, do, lse, dq, dk, dv, dbias]
    if route == "fused":
        fn = _kernel_fn(_SOURCE, "packed_window_attention_bwd_fused", 13, 9)
    else:
        tensors.append(torch.empty((BW, nh, N), dtype=torch.float32, device=q.device))  # drow
        fn = _kernel_fn(_SOURCE, "packed_window_attention_bwd", 14, 9)
    tensors.append(torch.empty((n_chunks, nW, nh, N, N), dtype=torch.float32, device=q.device))
    with torch.cuda.device(q.device):
        err = fn(*(t.data_ptr() for t in tensors), BW, nh, N, D, nW, mask.shape[0],
                 mask.shape[1], n_chunks, _DTYPE_CODE[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"packed_window_attention_bwd: CUDA error {err} on the {route} route "
                           f"for q {tuple(q.shape)} {q.dtype}, bias {tuple(bias.shape)}, "
                           f"mask {tuple(mask.shape)}")
    return dq, dk, dv, dbias, route


def packed_window_attention_bwd(q, k, v, bias, mask, out, lse, do):
    """(dq, dk, dv, dbias) of `packed_window_attention_fwd`; see
    `packed_window_attention_bwd_plain`.  Calls the registered operator
    `dlwpbench_torch::packed_window_attention_bwd`: CUDA tensors take the
    kernels of `bwd_route`'s design, one counted launch in
    `packed_window_attention_bwd.launches` running all its passes, and
    `packed_window_attention_bwd.fused_launches` counts those of the fused
    route."""
    _check_shapes(q, k, v, bias, mask)
    BW, nh, N, D = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dO {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)}")
    if tuple(lse.shape) != (BW, nh, 1, N):
        raise ValueError(f"lse must be [BW,nh,1,N] = {(BW, nh, 1, N)}, got {tuple(lse.shape)}")
    return torch.ops.dlwpbench_torch.packed_window_attention_bwd(q, k, v, bias, mask, out, lse,
                                                                 do)


@torch.library.custom_op("dlwpbench_torch::packed_window_attention_bwd", mutates_args=())
def _packed_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                   mask: Optional[torch.Tensor], out: torch.Tensor, lse: torch.Tensor,
                   do: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The registered backward: the plain version on CPU tensors, the
    counted kernel launch on CUDA ones."""
    tensors = (q, k, v, bias, out, lse, do) + (() if mask is None else (mask,))
    if _device_of(tensors).type == "cpu":
        return packed_window_attention_bwd_plain(q, k, v, bias, mask, out, lse, do)
    if lse.dtype != torch.float32:
        raise TypeError(f"lse must be float32, got {lse.dtype}")
    N, D = q.shape[2:]
    mask = _zero_mask(N, q) if mask is None else mask
    _check_cuda("packed_window_attention_bwd", (q, k, v, bias, mask, out, do), D, N)
    dq, dk, dv, dbias, route = _launch_bwd(q, k, v, bias, mask, out, lse.contiguous(), do)
    packed_window_attention_bwd.launches += 1
    packed_window_attention_bwd.bf16_launches += q.dtype == torch.bfloat16
    packed_window_attention_bwd.fused_launches += route == "fused"
    return dq, dk, dv, dbias


@_packed_bwd_op.register_fake
def _(q, k, v, bias, mask, out, lse, do):
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(bias))


@register_flop_formula(torch.ops.dlwpbench_torch.packed_window_attention_bwd)
def _(q, k, v, bias, mask, out, lse, do, out_shape=None, **kwargs):
    return sdpa_flops(q[0] * q[1], q[2], k[2], q[3], backward=True)


packed_window_attention_bwd.launches = 0
packed_window_attention_bwd.bf16_launches = 0
packed_window_attention_bwd.fused_launches = 0


# ---------------------------------------------------------------- autograd
class _PackedWindowAttention(torch.autograd.Function):
    """The counterpart of `_packed_diff` (`pallas_attention.py:1019-1094`)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask):
        out, lse = packed_window_attention_fwd(q, k, v, bias, mask)
        ctx.save_for_backward(q, k, v, bias, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, mask, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = packed_window_attention_bwd(q, k, v, bias, mask, out, lse,
                                                        dout.contiguous())
        return dq, dk, dv, dbias, None


def packed_window_attention(q, k, v, bias, mask=None):
    """Differentiable packed window attention [BW,nh,N,D] (the JAX
    signature without `interpret`); a None mask is a zero [1,1,N,N] mask in
    q's dtype (`pallas_attention.py:1118-1120`)."""
    if mask is None:
        mask = _zero_mask(q.shape[-2], q)
    return _PackedWindowAttention.apply(q, k, v, bias, mask)
