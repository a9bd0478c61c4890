"""The distributed spherical harmonic transform (counterpart of
`dlwpbench_tpu/parallel/sht_dist.py:43-237`), the recipe of the
distributed FFT: with latitude rows sharded over the P ranks of `group`,

  forward: local rfft over longitude -> all-to-all transpose, after which
  the azimuthal order m is sharded and latitude whole -> the Legendre
  contraction of the local m-block;

  inverse: the synthesis of the local m-block -> the transpose back ->
  local irfft.

mmax is padded with zero orders to a multiple of P; each rank holds only
its m-block of the Legendre tables, copied to its device once
(`device_constant`).

`pipeline_chunks=K` splits the channel axis (-3) into K chunks and issues
every chunk's transform and exchange before any contraction, JAX's order;
the result is the same as one chunk's.  JAX leaves the overlap to XLA's
scheduler; the port issues the exchanges one after the other and claims
no overlap.  `comm_dtype=torch.bfloat16` ships the exchanged coefficients
as bf16 pairs (half the bytes), the contraction staying in fp32.

The local transforms are `torch.fft.rfft` / `irfft` with norm="forward";
JAX computes its rfft as a complex FFT and a slice for its compiler's
sake (`parallel/fft.py` here says why the numbers are the same).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from dlwpbench_tpu_torch.ops.sht import SHTTables, sht_tables
from dlwpbench_tpu_torch.parallel import launch
from dlwpbench_tpu_torch.parallel.fft import pad_columns, padded, transpose_bwd, transpose_fwd
from dlwpbench_tpu_torch.utils.device import device_constant


def chunk_starts(size: int, k: int) -> list[tuple[int, int]]:
    """(start, length) pairs splitting `size` into at most `k` near-equal
    chunks, the longer ones first (JAX `_chunk_starts`)."""
    k = max(1, min(k, size))
    base, rem = divmod(size, k)
    out, s = [], 0
    for i in range(k):
        n = base + (1 if i < rem else 0)
        out.append((s, n))
        s += n
    return out


def _legendre_block(nlat, nlon, lmax, mmax, grid, name, p, idx):
    """Rank `idx`'s m-block of `fwd` [m_loc, nlat, lmax] or `inv` [m_loc,
    lmax, nlat], the orders past mmax zero, as complex64."""
    table = getattr(sht_tables(nlat, nlon, lmax, mmax, grid), name)
    m_loc = padded(mmax, p) // p
    block = np.zeros((m_loc, *table.shape[1:]), np.complex64)
    rows = table[idx * m_loc:(idx + 1) * m_loc]
    block[: len(rows)] = rows
    return block


def local_table(tables: SHTTables, name: str, group, device) -> torch.Tensor:
    """This rank's m-block of `tables.fwd` or `tables.inv` on `device`."""
    t = tables
    return device_constant(_legendre_block, t.nlat, t.nlon, t.lmax, t.mmax, t.grid, name,
                           dist.get_world_size(group), dist.get_rank(group),
                           device=torch.device(device))


def dist_sht(f_local: torch.Tensor, tables: SHTTables, group=None, pipeline_chunks: int = 1,
             comm_dtype=None) -> torch.Tensor:
    """[..., nlat/P, nlon] real -> [..., lmax, M_pad/P] complex64."""
    p = dist.get_world_size(group)
    m_pad = padded(tables.mmax, p)
    fwd = local_table(tables, "fwd", group, f_local.device)

    def one(f):
        X = torch.fft.rfft(f.float(), dim=-1, norm="forward")[..., : tables.mmax]
        return transpose_fwd(pad_columns(X, m_pad), group, comm_dtype)

    def legendre(X):  # a[..., l, m] = sum_j X[..., j, m] fwd[m, j, l]
        return torch.einsum("...jm,mjl->...lm", X, fwd)

    if pipeline_chunks <= 1 or f_local.ndim < 3:
        return legendre(one(f_local))
    gathered = [one(f_local.narrow(-3, s, n))
                for s, n in chunk_starts(f_local.shape[-3], pipeline_chunks)]
    return torch.cat([legendre(X) for X in gathered], dim=-3)


def dist_isht(a_local: torch.Tensor, tables: SHTTables, group=None, pipeline_chunks: int = 1,
              comm_dtype=None) -> torch.Tensor:
    """[..., lmax, M_pad/P] complex -> [..., nlat/P, nlon] real fp32."""
    inv = local_table(tables, "inv", group, a_local.device)
    nfreq = tables.nlon // 2 + 1

    def synth(a):
        return torch.einsum("...lm,mlj->...jm", a, inv)

    def back(X):
        X = transpose_bwd(X, group, comm_dtype)[..., : tables.mmax]
        return torch.fft.irfft(pad_columns(X, nfreq), n=tables.nlon, dim=-1, norm="forward")

    if pipeline_chunks <= 1 or a_local.ndim < 3:
        return back(synth(a_local))
    synthed = [synth(a_local.narrow(-3, s, n))
               for s, n in chunk_starts(a_local.shape[-3], pipeline_chunks)]
    return torch.cat([back(X) for X in synthed], dim=-3)


def make_dist_sht(mesh, tables: SHTTables, axis_name: str = "x", pipeline_chunks: int = 1,
                  comm_dtype=None):
    """(sht, isht) on replicated tensors over the mesh dim `axis_name`:
    fields [..., nlat, nlon] and coefficients [..., lmax, M_pad], each
    entering its sharded region (rows of a field, orders of a spectrum)
    and gathered on the way out.  An nlat that does not split raises
    ValueError."""
    group = launch.axis(mesh, axis_name)[0]

    def fwd(f: torch.Tensor) -> torch.Tensor:
        a = dist_sht(launch.scatter_to_ranks(f, f.ndim - 2, group), tables, group,
                     pipeline_chunks, comm_dtype)
        return launch.gather_from_ranks(a, a.ndim - 1, group)

    def inv(a: torch.Tensor) -> torch.Tensor:
        f = dist_isht(launch.scatter_to_ranks(a, a.ndim - 1, group), tables, group,
                      pipeline_chunks, comm_dtype)
        return launch.gather_from_ranks(f, f.ndim - 2, group)

    return fwd, inv
