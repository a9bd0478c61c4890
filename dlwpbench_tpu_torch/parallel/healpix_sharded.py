"""HEALPix neighbour padding with the 12 faces sharded over ranks
(counterpart of `dlwpbench_tpu/parallel/healpix_sharded.py:32-96`).

The single-device pad is a weighted gather over the flat [12 n n] field
(`grids.healpix.build_pad_indices`), so the distributed pad is
partitioned message passing (`graph_partition`): every padded output
pixel is a dst node receiving from its (<= 2) source pixels with the
corner weights as edge features, dst pixels partitioned in equal chunks,
and the remote boundary pixels exchanged in one padded all-to-all: the
exchanged volume is the boundary strips, a halo exchange, not a face
replication.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from dlwpbench_tpu_torch.grids.healpix import build_pad_indices
from dlwpbench_tpu_torch.parallel import launch
from dlwpbench_tpu_torch.parallel.graph_partition import (
    GraphPartition,
    partition_graph_nodewise,
    partitioned_message_passing,
)
from dlwpbench_tpu_torch.utils.device import device_constant


@functools.lru_cache(maxsize=None)
def build_sharded_pad_plan(nside: int, padding: int,
                           n_parts: int) -> tuple[GraphPartition, np.ndarray]:
    """Partition plan and per-rank edge weights [P, Emax, 1] of the
    padded-pixel gather."""
    idx, w = build_pad_indices(nside, padding)  # [12, Hp, Wp, 2]
    npad = idx.size // 2
    src = idx.reshape(-1)  # [2 npad], the pairs interleaved
    dst = np.repeat(np.arange(npad), 2)
    part = partition_graph_nodewise(src, dst, 12 * nside * nside, npad, n_parts)
    # per-rank edge weights in the partition's own edge order
    ew = np.where(part.edge_mask, w.reshape(-1)[part.edge_ids], 0.0)
    return part, ew[..., None].astype(np.float32)


def _edge_weights(nside: int, padding: int, n_parts: int) -> np.ndarray:
    return build_sharded_pad_plan(nside, padding, n_parts)[1]


def sharded_healpix_pad(x_local: torch.Tensor, nside: int, padding: int,
                        group=None) -> torch.Tensor:
    """On each rank: its slice [src_chunk, C] of the flat [12 n n, C] field
    (zero rows past the end up to P * src_chunk) -> its slice [dst_chunk,
    C] of the flat padded [12 (n+2p)^2, C] field."""
    n = dist.get_world_size(group)
    part, _ = build_sharded_pad_plan(nside, padding, n)
    ew = device_constant(_edge_weights, nside, padding, n, device=x_local.device)
    ew_local = ew[dist.get_rank(group)].to(x_local.dtype)
    return partitioned_message_passing(part, x_local, ew_local, group)


def make_sharded_healpix_pad(mesh, nside: int, padding: int, axis_name: str = "x"):
    """A function [12, n, n, C] -> [12, n+2p, n+2p, C] of a field that is
    the same on every rank: each rank pads its chunk of the faces' pixels,
    and the padded chunks are gathered back on every rank (gradients the
    same on every rank too, `launch.scatter_to_ranks` and
    `gather_from_ranks`)."""
    group, _, n_parts = launch.axis(mesh, axis_name)
    part, _ = build_sharded_pad_plan(nside, padding, n_parts)
    hp = nside + 2 * padding

    def fn(x: torch.Tensor) -> torch.Tensor:
        C = x.shape[-1]
        flat = x.reshape(12 * nside * nside, C)
        flat = torch.nn.functional.pad(flat, (0, 0, 0, n_parts * part.src_chunk - flat.shape[0]))
        local = launch.scatter_to_ranks(flat, 0, group)
        out = launch.gather_from_ranks(sharded_healpix_pad(local, nside, padding, group), 0, group)
        return out[: 12 * hp * hp].reshape(12, hp, hp, C)

    return fn
