"""GraphCastNet (counterpart of the single-device branch of
`dlwpbench_tpu/models/graphcast.py:174-219`; reference
`models/graphcast/graph_cast_net.py`), on the numpy graphs of
`grids/mesh_graph.py` and the movements of `ops/graph_ops.py`.

Architecture (reference `:475-569` + gnn_layers):
- grid input [B, H, W, C] -> grid node features [B, H*W, C];
- the encoder embedder: four MLPs embedding the grid nodes, the mesh node
  features (cos lat, sin lon, cos lon), the g2m edge features and the
  multimesh edge features (`gnn_layers/embedder.py:27-127`);
- the g2m encoder: e' = MLP(cat(e, grid[src], mesh[dst])),
  mesh += MLP(cat(aggregate(e' -> mesh), mesh)), grid += MLP(grid)
  (`mesh_graph_encoder.py:123-138`);
- the processor: `processor_layers` pairs of `MeshEdgeBlock` /
  `MeshNodeBlock` over the multimesh (`graph_cast_processor.py:59-180`);
- the m2g decoder: embed the m2g edges, e' = MLP(cat(e, mesh[src],
  grid[dst])), grid += MLP(cat(aggregate(e' -> grid), grid)); a final MLP
  with no norm to the prognostic channels (`mesh_graph_decoder.py`,
  `graph_cast_net.py:363-371`);
- the rollout and residual are `RolloutModel`'s.

The graphs are built once per (input_height, input_width, mesh_level,
grid_convention, node_feat_unit); their index vectors (int64) and static
feature tables are kept on the device through `utils.device.
device_constant` and cast to the compute dtype, as JAX casts its numpy
constants (`:84-98`).  An input on another grid raises (JAX fails in its
reshape).  The embedders' in-features come from the graphs (3 mesh node
features, 4 edge features) and the input, as flax sizes its Dense from the
data: the config's `input_dim_mesh_nodes` and `input_dim_edges` are read
by neither side.

Submodules carry flax's auto-names in creation order: `MeshGraphMLP_0..3`
the embedders, `_4` to `_6` the g2m encoder, `MeshEdgeBlock_i` /
`MeshNodeBlock_i` for the processor, `MeshGraphMLP_7..9` the m2g decoder
and `_10` the head, so `weights.load_flax_params` maps a JAX tree onto
them name for name.  Not ported: the partitioned processor over a device
mesh (`spmd_mesh`, ROADMAP queue A, item 16) raises.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from dlwpbench_tpu_torch.grids.mesh_graph import build_graphcast_graphs
from dlwpbench_tpu_torch.models.base import RolloutModel
from dlwpbench_tpu_torch.models.fno import init_like_flax_
from dlwpbench_tpu_torch.ops.graph_ops import (
    EdgeMovement,
    MeshEdgeBlock,
    MeshGraphMLP,
    MeshNodeBlock,
    check_aggregation,
)
from dlwpbench_tpu_torch.ops.spectral import no_mesh
from dlwpbench_tpu_torch.utils.device import device_constant

@functools.lru_cache(maxsize=None)
def _movements(graph: tuple, impl: str) -> tuple[EdgeMovement, EdgeMovement, EdgeMovement]:
    """(g2m, multimesh, m2g) movements of one graph key, built once: their
    device tables are keyed by them."""
    mesh_g, g2m, m2g, *_ = build_graphcast_graphs(*graph)
    return tuple(EdgeMovement(g.src, g.dst, g.n_src, g.n_dst, impl) for g in (g2m, mesh_g, m2g))


def _static_feat(graph: tuple, name: str) -> np.ndarray:
    """One static feature table of a graph key: the mesh node features
    [V, 3] or an edge set's features [E, 4]."""
    mesh_g, g2m, m2g, mesh_nfeat, _, _ = build_graphcast_graphs(*graph)
    return {"mesh_nfeat": mesh_nfeat, "g2m": g2m.edge_feat, "mesh": mesh_g.edge_feat,
            "m2g": m2g.edge_feat}[name]


class GraphCastNet(RolloutModel):
    """Reference `GraphCastNet` (config `type: GraphCastNet`).  `seed`
    seeds the random init (flax's: lecun-normal Dense kernels, zero
    biases, unit LayerNorm scales).  `movement_impl`: "auto" (the gather
    form, as JAX's "auto" off a TPU), "gather" or "onehot"
    (`ops/graph_ops.py`); `aggregation`: "sum" or "mean"."""

    def __init__(
        self,
        input_height: int = 32,
        input_width: int = 64,
        constant_channels: int = 4,
        prescribed_channels: int = 1,
        prognostic_channels: int = 8,
        mesh_level: int = 3,
        processor_layers: int = 16,
        hidden_layers: int = 1,
        hidden_dim: int = 512,
        aggregation: str = "sum",
        context_size: int = 1,
        mesh: str = "equirectangular",
        grid_convention: str = "cell_centers",
        node_feat_unit: str = "rad",
        spmd_mesh: Any = None,
        movement_impl: str = "auto",
        remat: bool = False,
        remat_policy: str = "full",
        seed: int = 0,
    ):
        super().__init__(context_size, remat, remat_policy)
        no_mesh(spmd_mesh, "GraphCast's processor")
        check_aggregation(aggregation)
        self.mesh = mesh
        self.grid_shape = (int(input_height), int(input_width))
        self.graph = (*self.grid_shape, int(mesh_level), grid_convention, node_feat_unit)
        # the graphs once, here (an unknown grid_convention or node_feat_unit
        # raises now, not in a forward)
        mesh_g, g2m, m2g, mesh_nfeat, _, _ = build_graphcast_graphs(*self.graph)
        self.movements = _movements(self.graph, movement_impl)
        self.prognostic_channels = int(prognostic_channels)
        self.processor_layers = int(processor_layers)
        cin = int(constant_channels) + int(context_size) * (
            int(prescribed_channels) + int(prognostic_channels))
        D, hl = int(hidden_dim), int(hidden_layers)
        mlps = [cin, mesh_nfeat.shape[1], g2m.edge_feat.shape[1], mesh_g.edge_feat.shape[1],
                3 * D, 2 * D, D]
        for i, fin in enumerate(mlps):  # the embedders, then the g2m encoder
            setattr(self, f"MeshGraphMLP_{i}", MeshGraphMLP(fin, D, D, hl))
        for i in range(self.processor_layers):
            setattr(self, f"MeshEdgeBlock_{i}", MeshEdgeBlock(3 * D, D, D, hl))
            setattr(self, f"MeshNodeBlock_{i}", MeshNodeBlock(2 * D, D, D, hl, aggregation))
        self.MeshGraphMLP_7 = MeshGraphMLP(m2g.edge_feat.shape[1], D, D, hl)
        self.MeshGraphMLP_8 = MeshGraphMLP(3 * D, D, D, hl)
        self.MeshGraphMLP_9 = MeshGraphMLP(2 * D, D, D, hl)
        self.MeshGraphMLP_10 = MeshGraphMLP(D, self.prognostic_channels, D, hl, norm=False)
        self.aggregation = aggregation
        init_like_flax_(self, torch.Generator().manual_seed(int(seed)))

    def _feat(self, name: str, B: int, like: torch.Tensor) -> torch.Tensor:
        """A static feature table on the input's device, in its dtype,
        broadcast over the batch."""
        t = device_constant(_static_feat, self.graph, name, device=like.device).to(like.dtype)
        return t.expand(B, *t.shape)

    def step(self, x: torch.Tensor, state: Any, aux: Any = None):
        B, H, W, Cin = x.shape
        if (H, W) != self.grid_shape:
            raise ValueError(f"GraphCastNet was built for the {self.grid_shape[0]} x "
                             f"{self.grid_shape[1]} grid (input_height, input_width), "
                             f"got {H} x {W}")
        g2m_mv, proc_mv, m2g_mv = self.movements
        agg = self.aggregation
        grid = x.reshape(B, H * W, Cin)
        mesh_nf = self._feat("mesh_nfeat", B, x)
        g2m_e, mesh_e, m2g_e = (self._feat(n, B, x) for n in ("g2m", "mesh", "m2g"))

        # the encoder embedder
        grid = self.MeshGraphMLP_0(grid)
        mesh_nf = self.MeshGraphMLP_1(mesh_nf)
        g2m_e = self.MeshGraphMLP_2(g2m_e)
        mesh_e = self.MeshGraphMLP_3(mesh_e)

        # the g2m encoder
        g2m_e = self.MeshGraphMLP_4(torch.cat(
            [g2m_e, g2m_mv.gather_src(grid), g2m_mv.gather_dst(mesh_nf)], dim=-1))
        mesh_nf = mesh_nf + self.MeshGraphMLP_5(
            torch.cat([g2m_mv.aggregate(g2m_e, agg), mesh_nf], dim=-1))
        grid = grid + self.MeshGraphMLP_6(grid)

        # the processor over the multimesh
        for i in range(self.processor_layers):
            mesh_e = getattr(self, f"MeshEdgeBlock_{i}")(mesh_e, mesh_nf, mesh_nf, proc_mv)
            mesh_nf = getattr(self, f"MeshNodeBlock_{i}")(mesh_e, mesh_nf, proc_mv)

        # the m2g decoder
        m2g_e = self.MeshGraphMLP_7(m2g_e)
        m2g_e = self.MeshGraphMLP_8(torch.cat(
            [m2g_e, m2g_mv.gather_src(mesh_nf), m2g_mv.gather_dst(grid)], dim=-1))
        grid = grid + self.MeshGraphMLP_9(
            torch.cat([m2g_mv.aggregate(m2g_e, agg), grid], dim=-1))

        # the final MLP, no norm (`graph_cast_net.py:363-371`)
        out = self.MeshGraphMLP_10(grid)
        return out.reshape(B, H, W, self.prognostic_channels), state
