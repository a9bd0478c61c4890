"""The distributed 2D real FFT: a 1D transform along the local dim, a
transpose by all-to-all, a 1D transform along the other dim
(counterpart of `dlwpbench_tpu/parallel/fft.py:35-113`; reference
`models/graphcast/distributed/fft.py:64-230`).

Layout on each of P ranks of `group`:
- input  x_local: [..., H/P, W]   (latitude rows sharded);
- output X_local: [..., H, Wf/P]  (frequency columns sharded), Wf = W//2+1
  padded with zero columns to a multiple of P (33 -> 34 on 2 ranks of a
  64-wide grid, 33 -> 36 on 4).
The backward runs the exchanges in the opposite order: the all-to-all is
its own adjoint (`launch.all_to_all`).

JAX computes the local rfft as a complex FFT and a slice, and flattens to
rank 2 around every FFT; both work around its compiler (the rfft's
transpose rule under `shard_map`, a TPU compiler hang on rank > 2 complex
FFTs).  The port takes `torch.fft.rfft` / `irfft` on any rank, whose
autograd is the same linear map's adjoint: the same numbers.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dlwpbench_tpu_torch.parallel import launch


def exchange(x: torch.Tensor, group, comm_dtype=None) -> torch.Tensor:
    """`launch.all_to_all` along dim 0 of a complex tensor: its real and
    imaginary parts travel as stacked pairs (gloo moves no complex
    dtype), in `comm_dtype` when given (JAX `sht_dist._a2a`: bf16 pairs
    halve the bytes; the result is rebuilt in complex64)."""
    pair = torch.view_as_real(x)
    if comm_dtype is not None:
        pair = pair.to(comm_dtype)
    pair = launch.all_to_all(pair, group)
    return torch.view_as_complex(pair.float().contiguous())


def transpose_fwd(xf: torch.Tensor, group, comm_dtype=None) -> torch.Tensor:
    """[..., H/P, M_pad] -> [..., H, M_pad/P]: shard the columns, gather
    the rows (JAX `sht_dist._transpose_fwd`)."""
    p = dist.get_world_size(group)
    xf = xf.reshape(*xf.shape[:-1], p, xf.shape[-1] // p).movedim(-2, 0)
    xf = exchange(xf, group, comm_dtype)  # slot i: rank i's rows of this rank's columns
    return torch.cat(xf.unbind(0), dim=-2)


def transpose_bwd(xf: torch.Tensor, group, comm_dtype=None) -> torch.Tensor:
    """[..., H, M_pad/P] -> [..., H/P, M_pad]: shard the rows, gather the
    columns (JAX `sht_dist._transpose_bwd`)."""
    p = dist.get_world_size(group)
    h = xf.shape[-2] // p
    xf = xf.reshape(*xf.shape[:-2], p, h, xf.shape[-1]).movedim(-3, 0)
    xf = exchange(xf, group, comm_dtype)
    return torch.cat(xf.unbind(0), dim=-1)


def pad_columns(x: torch.Tensor, size: int) -> torch.Tensor:
    """Zero columns on the last dim of a complex tensor up to `size`; the
    padding's cotangent is dropped, so it reaches no gradient."""
    pad = size - x.shape[-1]
    return torch.view_as_complex(F.pad(torch.view_as_real(x), (0, 0, 0, pad))) if pad else x


def padded(n: int, p: int) -> int:
    """`n` rounded up to a multiple of `p`."""
    return -(-n // p) * p


def dist_rfft2(x_local: torch.Tensor, group=None) -> torch.Tensor:
    """[..., H/P, W] real -> [..., H, Wf_pad/P] complex64 (unnormalised,
    the H axis's spectrum whole)."""
    p = dist.get_world_size(group)
    wf = x_local.shape[-1] // 2 + 1
    xf = torch.fft.rfft(x_local.float(), dim=-1)
    xf = transpose_fwd(pad_columns(xf, padded(wf, p)), group)
    return torch.fft.fft(xf, dim=-2)


def dist_irfft2(Xf_local: torch.Tensor, W: int, group=None) -> torch.Tensor:
    """The inverse of `dist_rfft2`: [..., H, Wf_pad/P] -> [..., H/P, W] real."""
    xf = transpose_bwd(torch.fft.ifft(Xf_local, dim=-2), group)
    return torch.fft.irfft(xf[..., : W // 2 + 1], n=W, dim=-1)


def make_dist_rfft2(mesh, axis_name: str = "x"):
    """(rfft2, irfft2) on replicated [..., H, W] tensors over the mesh dim
    `axis_name`: each enters the sharded region (this rank's rows, or its
    spectrum's columns) and leaves it gathered, so both take and give the
    whole array on every rank, as JAX's wrappers take and give globally
    sharded ones.  A row count that does not split raises ValueError."""
    group = launch.axis(mesh, axis_name)[0]

    def fwd(x: torch.Tensor) -> torch.Tensor:
        local = dist_rfft2(launch.scatter_to_ranks(x, x.ndim - 2, group), group)
        return launch.gather_from_ranks(local, local.ndim - 1, group)

    def inv(Xf: torch.Tensor, W: int) -> torch.Tensor:
        local = dist_irfft2(launch.scatter_to_ranks(Xf, Xf.ndim - 1, group), W, group)
        return launch.gather_from_ranks(local, local.ndim - 2, group)

    return fwd, inv
