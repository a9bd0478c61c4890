"""The partitioned GraphCast graphs: grid and mesh nodes sharded over the
ranks of a mesh dim (counterpart of `dlwpbench_tpu/parallel/
graphcast_dist.py:39-165`; reference `gnn_layers/distributed_graph.py`,
`distributed/utils.py:233-656`).

The plan (`graph_partition.partition_graph_nodewise`) is numpy, built
once per graph.  Each rank holds its chunk of the nodes and its owned
edges; the two index-space ops run on those chunks:
- `edge_ends(src_local, dst_local)`: [..., src_chunk, F] / [..., dst_chunk,
  F] -> the per-edge end features [..., Emax, F] of the rank's owned edges
  (one all-to-all moves the boundary src features);
- `aggregate(msgs_local)`: [..., Emax, F] -> the masked per-node sum onto
  the rank's dst nodes [..., dst_chunk, F].
The MLPs run rowwise on the local rows between them, with the same
modules as the single-device model, so one checkpoint runs either way.
Per-edge global data enters in the plan's edge order: `plan.e_perm`
holds the global edge id of every rank-slot ([P * Emax], rank-major).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from dlwpbench_tpu_torch.parallel import launch
from dlwpbench_tpu_torch.parallel.graph_partition import (
    GraphPartition,
    gather_src_features,
    partition_graph_nodewise,
    rank_table,
)


class ProcessorPlan(NamedTuple):
    part: GraphPartition
    e_perm: np.ndarray  # [P*Emax] global edge ids feeding each rank-slot
    n_nodes: int  # dst node count (processor: == src node count)
    n_nodes_padded: int  # P * dst_chunk
    n_edges_padded: int  # P * Emax
    n_src: int = 0
    n_src_padded: int = 0  # P * src_chunk


class ProcessorOps(NamedTuple):
    plan: ProcessorPlan
    edge_ends: Callable  # (src_local, dst_local) -> (src_f, dst_f) [..., Emax, F]
    aggregate: Callable  # msgs_local [..., Emax, F] -> agg [..., dst_chunk, F]


def build_processor_plan(src: np.ndarray, dst: np.ndarray, n_nodes: int, n_parts: int,
                         n_src: Optional[int] = None) -> ProcessorPlan:
    """Partition plan of one graph, bipartite when `n_src != n_nodes`:
    dst-nodewise ownership (g2m by mesh node chunks, m2g by grid node
    chunks, `graph_cast_net.py:113-133`)."""
    n_src = n_nodes if n_src is None else n_src
    part = partition_graph_nodewise(src, dst, n_src, n_nodes, n_parts)
    return ProcessorPlan(
        part=part,
        e_perm=part.edge_ids.reshape(-1),  # the partition's own per-rank edge order
        n_nodes=n_nodes,
        n_nodes_padded=n_parts * part.dst_chunk,
        n_edges_padded=n_parts * part.n_edges_max,
        n_src=n_src,
        n_src_padded=n_parts * part.src_chunk,
    )


def _edge_ends_local(part: GraphPartition, src_local: torch.Tensor,
                     dst_local: Optional[torch.Tensor], group):
    """src_local [..., src_chunk, F], dst_local [..., dst_chunk, F] (None:
    a homogeneous graph passes one array for both)."""
    if dst_local is None:
        dst_local = src_local
    r, dev = dist.get_rank(group), src_local.device
    addr = gather_src_features(part, src_local, group)
    src_f = addr.index_select(-2, rank_table(part, "edge_src_local", r, dev))
    dst_f = dst_local.index_select(-2, rank_table(part, "edge_dst_local", r, dev))
    return src_f, dst_f


def _aggregate_local(part: GraphPartition, msgs_local: torch.Tensor, group):
    r, dev = dist.get_rank(group), msgs_local.device
    e_mask = rank_table(part, "edge_mask", r, dev)[..., None].to(msgs_local.dtype)
    masked = msgs_local * e_mask
    out = masked.new_zeros((*masked.shape[:-2], part.dst_chunk, masked.shape[-1]))
    return out.index_add(-2, rank_table(part, "edge_dst_local", r, dev), masked)


def make_graph_ops(mesh, src: np.ndarray, dst: np.ndarray, n_dst: int,
                   axis_name: str = "x", n_src: Optional[int] = None) -> ProcessorOps:
    """The partitioned index ops of one (possibly bipartite) graph over
    the mesh dim `axis_name`, for this rank."""
    group, _, n_parts = launch.axis(mesh, axis_name)
    plan = build_processor_plan(src, dst, n_dst, n_parts, n_src=n_src)
    part = plan.part

    def edge_ends(src_nodes, dst_nodes):
        return _edge_ends_local(part, src_nodes, dst_nodes, group)

    def aggregate(msgs):
        return _aggregate_local(part, msgs, group)

    return ProcessorOps(plan=plan, edge_ends=edge_ends, aggregate=aggregate)


def local_rows(x: torch.Tensor, n_padded: int, group, dim: int = 1) -> torch.Tensor:
    """This rank's chunk of the replicated node array `x` along `dim`,
    zero-padded to `n_padded` rows first; the backward all-gathers
    (`launch.scatter_to_ranks`)."""
    pad = n_padded - x.shape[dim]
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    return launch.scatter_to_ranks(x, dim, group)

