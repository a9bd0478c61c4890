"""Nodewise graph partition for model-parallel message passing
(counterpart of `dlwpbench_tpu/parallel/graph_partition.py:34-190`;
reference `models/graphcast/gnn_layers/distributed_graph.py`).

Equal chunks of dst node ids per rank; each rank owns the incoming edges
of its dst nodes.  The exchange plan is numpy, computed once, as PADDED
per-rank buckets (static shapes, equal splits):

  send_idx [P, P, Smax]: for (owner i -> consumer j) the local node
    indices i sends to j, padded with 0 and masked by send_mask;
  each rank receives [P, Smax, F] remote-feature buckets in ONE
  `all_to_all_single` over equal buckets, addressed by the remapped edge
  source indices [0, src_chunk) own chunk || src_chunk + i * Smax + pos.

`partition_graph_nodewise` is JAX's plan, copied (equal array for
array).  `gather_src_features` and `partitioned_message_passing` run on
each rank's own chunk: bucket gather -> all-to-all -> [local || received]
-> edge gather (-> masked per-node sum).  The all-to-all is an
`autograd.Function` whose backward is the all-to-all the other way (for
equal buckets the same exchange), the adjoint JAX derives and the
reference hand-codes (`autograd.py:189-254`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from dlwpbench_tpu_torch.parallel import launch
from dlwpbench_tpu_torch.utils.device import device_constant


@dataclasses.dataclass(frozen=True, eq=False)  # hashed by identity: a device_constant key
class GraphPartition:
    """Static (numpy) partition plan for one bipartite or homogeneous graph."""

    n_parts: int
    n_src: int
    n_dst: int
    # per-rank padded arrays (stacked along axis 0 = owning rank):
    edge_src_local: np.ndarray  # [P, Emax] index into [local || recv buckets]
    edge_dst_local: np.ndarray  # [P, Emax] index into local dst nodes
    edge_mask: np.ndarray  # [P, Emax] bool
    edge_ids: np.ndarray  # [P, Emax] GLOBAL edge id per rank-slot (pad 0):
    # the single source of truth for per-rank edge order — consumers
    # permuting global per-edge data (features, weights) must index with
    # this, never re-derive the order
    send_idx: np.ndarray  # [P, P, Smax] local src indices rank i sends to j
    send_mask: np.ndarray  # [P, P, Smax] bool
    src_chunk: int  # src nodes per rank (padded)
    dst_chunk: int  # dst nodes per rank (padded)
    n_edges_max: int
    s_max: int


def partition_graph_nodewise(
    src: np.ndarray, dst: np.ndarray, n_src: int, n_dst: int, n_parts: int
) -> GraphPartition:
    """Equal-chunk dst ownership; each rank owns incoming edges of its dsts
    (reference `distributed_graph.py:78-227`), with padded static buckets."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    P = n_parts
    src_chunk = -(-n_src // P)
    dst_chunk = -(-n_dst // P)

    # owner of each src NODE id (indexable by node id)
    owner_of_src = np.minimum(np.arange(n_src) // src_chunk, P - 1)

    edge_lists, send_lists = [], [[[] for _ in range(P)] for _ in range(P)]
    per_rank = []
    for r in range(P):
        e_ids = np.nonzero((dst // dst_chunk) == r)[0]
        per_rank.append(e_ids)

    # Build send plans: rank i sends src node n to rank j if some edge owned
    # by j has src n owned by i.
    for j in range(P):
        e = per_rank[j]
        s = src[e]
        owners = owner_of_src[s]
        for i in range(P):
            if i == j:
                continue
            needed = np.unique(s[owners == i])
            send_lists[i][j] = (needed - i * src_chunk).tolist()

    s_max = max(
        (len(send_lists[i][j]) for i in range(P) for j in range(P)), default=0
    )
    s_max = max(s_max, 1)
    send_idx = np.zeros((P, P, s_max), np.int32)
    send_mask = np.zeros((P, P, s_max), bool)
    for i in range(P):
        for j in range(P):
            lst = send_lists[i][j]
            send_idx[i, j, : len(lst)] = lst
            send_mask[i, j, : len(lst)] = True

    # Remap each rank's edge src indices into its local address space:
    # [0, src_chunk) = own chunk; then P buckets of s_max received features
    # laid out at src_chunk + sender_rank * s_max + position_in_bucket.
    e_max = max((len(e) for e in per_rank), default=1)
    e_max = max(e_max, 1)
    edge_src_local = np.zeros((P, e_max), np.int32)
    edge_dst_local = np.zeros((P, e_max), np.int32)
    edge_mask = np.zeros((P, e_max), bool)
    edge_ids = np.zeros((P, e_max), np.int64)
    for j in range(P):
        e = per_rank[j]
        s, d = src[e], dst[e]
        owners = owner_of_src[s]
        local_addr = np.empty(len(e), np.int64)
        own = owners == j
        local_addr[own] = s[own] - j * src_chunk
        for i in range(P):
            if i == j:
                continue
            m = owners == i
            if not m.any():
                continue
            lst = np.asarray(send_lists[i][j], np.int64) + i * src_chunk
            pos = np.searchsorted(lst, s[m])
            local_addr[m] = src_chunk + i * s_max + pos
        edge_src_local[j, : len(e)] = local_addr
        edge_dst_local[j, : len(e)] = d - j * dst_chunk
        edge_mask[j, : len(e)] = True
        edge_ids[j, : len(e)] = e

    return GraphPartition(
        n_parts=P,
        n_src=n_src,
        n_dst=n_dst,
        edge_src_local=edge_src_local,
        edge_dst_local=edge_dst_local,
        edge_mask=edge_mask,
        edge_ids=edge_ids,
        send_idx=send_idx,
        send_mask=send_mask,
        src_chunk=src_chunk,
        dst_chunk=dst_chunk,
        n_edges_max=e_max,
        s_max=s_max,
    )


def _plan_array(part: GraphPartition, name: str) -> np.ndarray:
    return np.ascontiguousarray(getattr(part, name))


def rank_table(part: GraphPartition, name: str, rank: int, device) -> torch.Tensor:
    """Row `rank` of the plan array `name` on `device`, the whole array
    copied once per (plan, device) by `device_constant`."""
    return device_constant(_plan_array, part, name, device=torch.device(device))[rank]


class _AllToAll(torch.autograd.Function):
    """Slot j of dim 0 goes to rank j, slot i of the result came from rank
    i; with equal slots the exchange is its own adjoint."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return launch.all_to_all_single(x, group)

    @staticmethod
    def backward(ctx, g):
        return launch.all_to_all_single(g, ctx.group), None


def gather_src_features(part: GraphPartition, src_feat_local: torch.Tensor,
                        group=None) -> torch.Tensor:
    """This rank's src features [..., src_chunk, F] -> its address space
    [..., src_chunk + P * s_max, F] = [own || received buckets], any
    leading (batch) dims riding along in the one exchange."""
    p, r = part.n_parts, dist.get_rank(group)
    dev = src_feat_local.device
    send_idx = rank_table(part, "send_idx", r, dev).reshape(-1)  # [P * Smax]
    send_mask = rank_table(part, "send_mask", r, dev)[..., None]  # [P, Smax, 1]
    *lead, _, F = src_feat_local.shape
    out = src_feat_local.index_select(-2, send_idx).reshape(*lead, p, part.s_max, F)
    out = out * send_mask.to(out.dtype)
    recv = _AllToAll.apply(out.movedim(-3, 0).contiguous(), group)  # [P, ..., Smax, F]
    recv = recv.movedim(0, -3).reshape(*lead, p * part.s_max, F)
    return torch.cat([src_feat_local, recv], dim=-2)


def partitioned_message_passing(part: GraphPartition, src_feat_local: torch.Tensor,
                                edge_feat_local: torch.Tensor, group=None) -> torch.Tensor:
    """One aggregate step on this rank: the sum over its owned edges of
    src_feat[src] * edge_feat onto its dst nodes [..., dst_chunk, F] (the
    distributed `ops.graph_ops` aggregate)."""
    r = dist.get_rank(group)
    dev = src_feat_local.device
    addr = gather_src_features(part, src_feat_local, group)
    e_src = rank_table(part, "edge_src_local", r, dev)
    e_dst = rank_table(part, "edge_dst_local", r, dev)
    e_mask = rank_table(part, "edge_mask", r, dev)[..., None]
    msgs = addr.index_select(-2, e_src) * edge_feat_local * e_mask.to(addr.dtype)
    out = msgs.new_zeros((*msgs.shape[:-2], part.dst_chunk, msgs.shape[-1]))
    return out.index_add(-2, e_dst, msgs)
