"""MeshGraphNet (counterpart of `dlwpbench_tpu/models/mgn.py`, the
reference's Modulus MGN, `models/mgn/meshgraphnet.py`), on numpy graphs and
the movements of `ops/graph_ops.py`.

- The model builds its own graph over the lat-lon grid of its input
  (`:233-315`): `grid_2d` (4-stencil, periodic longitude),
  `grid_2d_8stencil` (adds the diagonals and a normalised distance
  feature), `delaunay` (scipy's triangulation of a (W+1) x H vertex sheet
  with the longitudinal seam closed).  `build_grid_graph` is JAX's line for
  line.  scipy's Delaunay of a regular grid is degenerate (its points lie
  on common circles), so Qhull picks the diagonals: the graph is
  reproducible per scipy build, and the port's arrays equal JAX's bit for
  bit under one scipy, not necessarily across two.
- Edge features: periodic-corrected integer normals (+ the distance for
  the 8-stencil) (`:317-345`).  The edge encoder's in-features come from
  the graph (3 on the 8-stencil, else 2), as flax sizes its Dense from the
  data: the config's `input_dim_edges` is read by neither side.
- Encode-process-decode (`:184-229,492-545`): node and edge encoder MLPs
  (ReLU, LayerNorm) into `hidden_dim_processor`, `processor_size` pairs of
  `MeshEdgeBlock`/`MeshNodeBlock`, a node decoder MLP without norm.
- Movement: `movement_impl="auto"` takes the stencil form (rolls and
  masked shifted adds) on `grid_2d` and `grid_2d_8stencil` and the edge
  list (the gather form) on `delaunay`; `"edge_list"` forces the edge
  list.  Both give the same parameter tree.
- The rollout and residual are `RolloutModel`'s (the reference's graph
  batching by replication is a plain batch dim).

Submodules carry flax's auto-names in creation order (`MeshGraphMLP_0`
nodes, `_1` edges, `MeshEdgeBlock_i`/`MeshNodeBlock_i`, `MeshGraphMLP_2`
the decoder).  The graph and its device tables (`utils.device.
device_constant`) are built once per (H, W, graph type, periodic).
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from dlwpbench_tpu_torch.models.base import RolloutModel
from dlwpbench_tpu_torch.models.fno import init_like_flax_
from dlwpbench_tpu_torch.ops.graph_ops import (
    EdgeMovement,
    MeshEdgeBlock,
    MeshGraphMLP,
    MeshNodeBlock,
    StencilMovement,
)
from dlwpbench_tpu_torch.utils.device import device_constant

# Directed stencil directions matching `build_grid_graph`'s bidirected edge
# sets: 4-stencil cardinals, 8-stencil adds the diagonals.
STENCIL_DIRS = {
    "grid_2d": ((0, 1), (0, -1), (1, 0), (-1, 0)),
    "grid_2d_8stencil": (
        (0, 1), (0, -1), (1, 0), (-1, 0),
        (-1, 1), (1, 1), (1, -1), (-1, -1),
    ),
}
GRAPH_TYPES = ("grid_2d", "grid_2d_8stencil", "delaunay")
MOVEMENT_IMPLS = ("auto", "edge_list")


def stencil_edge_feats(graph_type: str) -> np.ndarray:
    """Per-direction edge features, identical to `build_grid_graph`'s
    per-edge (dr, dc[, dist/max]) values (constant within a direction)."""
    dirs = STENCIL_DIRS[graph_type]
    feats = [[float(dr), float(dc)] for dr, dc in dirs]
    if graph_type == "grid_2d_8stencil":
        dmax = np.sqrt(2.0)
        feats = [
            f + [float(np.sqrt(f[0] ** 2 + f[1] ** 2) / dmax)] for f in feats
        ]
    return np.asarray(feats, np.float32)


def _dedup_bidirect(edges: np.ndarray) -> np.ndarray:
    both = np.concatenate([edges, edges[:, ::-1]])
    both = np.unique(both, axis=0)
    return both[both[:, 0] != both[:, 1]]


@functools.lru_cache(maxsize=None)
def build_grid_graph(
    height: int, width: int, graph_type: str = "grid_2d", periodic: bool = True
):
    """Returns (src [E], dst [E], edge_feat [E, F]) numpy arrays.

    Node id = row * width + col (row = latitude index).
    """
    H, W = height, width
    r = np.repeat(np.arange(H), W)
    c = np.tile(np.arange(W), H)
    nid = lambda rr, cc: rr * W + cc  # noqa: E731

    edges = []
    # 4-stencil: lon neighbors (periodic), lat neighbors (clamped)
    cn = (c + 1) % W if periodic else c + 1
    valid = np.ones_like(c, bool) if periodic else (c + 1 < W)
    edges.append(np.stack([nid(r, c)[valid], nid(r, cn % W)[valid]], 1))
    valid = r + 1 < H
    edges.append(np.stack([nid(r, c)[valid], nid(r + 1, c)[valid][: valid.sum()]], 1))

    if graph_type in ("grid_2d_8stencil",):
        for dr, dc in [(-1, 1), (1, 1), (1, -1), (-1, -1)]:
            rr = r + dr
            cc = (c + dc) % W if periodic else c + dc
            valid = (rr >= 0) & (rr < H)
            if not periodic:
                valid &= (c + dc >= 0) & (c + dc < W)
            edges.append(np.stack([nid(r, c)[valid], nid(rr[valid], cc[valid])], 1))

    if graph_type == "delaunay":
        import scipy.spatial

        x = np.arange(W + 1)
        y = np.arange(H)
        xx, yy = np.meshgrid(x, y)
        pts = np.stack([xx.reshape(-1), yy.reshape(-1)], 1).astype(np.float64)
        tri = scipy.spatial.Delaunay(pts).simplices
        if periodic:
            # identify last column with the first (close the seam)
            for i in range(H):
                tri[tri == (W + 1) * i + W] = (W + 1) * i
        # map sheet ids (row-major over W+1 cols) -> grid ids (W cols)
        sheet_r = tri // (W + 1)
        sheet_c = tri % (W + 1)
        tri = sheet_r * W + np.minimum(sheet_c, W - 1)
        e = np.concatenate(
            [tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [2, 0]]], axis=0
        )
        edges = [e]

    edges = _dedup_bidirect(np.concatenate(edges, 0))
    src, dst = edges[:, 0], edges[:, 1]

    # edge features: periodic-corrected normals (`meshgraphnet.py:317-345`)
    ur, uc = src // W, src % W
    vr, vc = dst // W, dst % W
    dr = (vr - ur).astype(np.float64)
    dc = (vc - uc).astype(np.float64)
    dc = np.where(dc >= W - 1, dc - W, dc)
    dc = np.where(dc <= -(W - 1), dc + W, dc)
    dr = np.where(dr >= H - 1, dr - H, dr)
    dr = np.where(dr <= -(H - 1), dr + H, dr)
    feats = [dr, dc]
    if graph_type == "grid_2d_8stencil":
        dist = np.sqrt(dr**2 + dc**2)
        feats.append(dist / dist.max())
    ef = np.stack(feats, 1).astype(np.float32)
    return src.astype(np.int32), dst.astype(np.int32), ef


@functools.lru_cache(maxsize=None)
def _edge_movement(height: int, width: int, graph_type: str, periodic: bool) -> EdgeMovement:
    """The edge-list movement of one grid graph (the gather form), built
    once: its device tables are keyed by it."""
    src, dst, _ = build_grid_graph(height, width, graph_type, periodic)
    return EdgeMovement(src, dst, height * width, height * width, "gather")


def _edge_feat(height: int, width: int, graph_type: str, periodic: bool) -> np.ndarray:
    return build_grid_graph(height, width, graph_type, periodic)[2]


class MeshGraphNet(RolloutModel):
    """Reference `MeshGraphNet` (config `type: MeshGraphNet`).  `seed`
    seeds the random init (flax's: lecun-normal Dense kernels, zero
    biases, unit LayerNorm scales).  The graph follows the input's grid:
    the config's `graph_height`/`graph_width` are read by neither side."""

    def __init__(
        self,
        constant_channels: int = 4,
        prescribed_channels: int = 0,
        prognostic_channels: int = 1,
        context_size: int = 1,
        processor_size: int = 15,
        num_layers_node_processor: int = 2,
        num_layers_edge_processor: int = 2,
        hidden_dim_processor: int = 128,
        hidden_dim_node_encoder: int = 128,
        num_layers_node_encoder: int = 2,
        hidden_dim_edge_encoder: int = 128,
        num_layers_edge_encoder: int = 2,
        hidden_dim_node_decoder: int = 128,
        num_layers_node_decoder: int = 2,
        aggregation: str = "sum",
        graph_type: str = "grid_2d",
        periodic: bool = True,
        mesh: str = "equirectangular",
        movement_impl: str = "auto",
        remat: bool = False,
        remat_policy: str = "full",
        seed: int = 0,
    ):
        super().__init__(context_size, remat, remat_policy)
        if graph_type not in GRAPH_TYPES:
            raise ValueError(f"graph_type {graph_type!r}: expected one of {GRAPH_TYPES}")
        if movement_impl not in MOVEMENT_IMPLS:
            raise ValueError(f"movement_impl {movement_impl!r}: expected one of "
                             f"{MOVEMENT_IMPLS}")
        self.mesh, self.graph_type, self.periodic = mesh, graph_type, bool(periodic)
        self.stencil = graph_type in STENCIL_DIRS and movement_impl != "edge_list"
        self.prognostic_channels = int(prognostic_channels)
        cin = int(constant_channels) + int(context_size) * (
            int(prescribed_channels) + int(prognostic_channels))
        fe = 3 if graph_type == "grid_2d_8stencil" else 2
        hd = int(hidden_dim_processor)
        relu = F.relu
        self.MeshGraphMLP_0 = MeshGraphMLP(cin, hd, hidden_dim_node_encoder,
                                           num_layers_node_encoder, activation=relu)
        self.MeshGraphMLP_1 = MeshGraphMLP(fe, hd, hidden_dim_edge_encoder,
                                           num_layers_edge_encoder, activation=relu)
        self.processor_size = int(processor_size)
        for i in range(self.processor_size):
            setattr(self, f"MeshEdgeBlock_{i}", MeshEdgeBlock(
                3 * hd, hd, hd, num_layers_edge_processor, activation=relu))
            setattr(self, f"MeshNodeBlock_{i}", MeshNodeBlock(
                2 * hd, hd, hd, num_layers_node_processor, aggregation, activation=relu))
        self.MeshGraphMLP_2 = MeshGraphMLP(hd, self.prognostic_channels,
                                           hidden_dim_node_decoder, num_layers_node_decoder,
                                           norm=False, activation=relu)
        init_like_flax_(self, torch.Generator().manual_seed(int(seed)))

    def step(self, x: torch.Tensor, state: Any, aux: Any = None):
        B, H, W, Cin = x.shape
        key = (H, W, self.graph_type, self.periodic)
        if self.stencil:
            # nodes stay [B, H, W, F], edges are [B, D, H, W, Fe] direction planes
            mv = StencilMovement(H, W, STENCIL_DIRS[self.graph_type], self.periodic)
            nodes = x
            ef = device_constant(stencil_edge_feats, self.graph_type, device=x.device)
            edges = ef.to(x.dtype)[:, None, None, :].expand(B, ef.shape[0], H, W, ef.shape[1])
        else:
            mv = _edge_movement(*key)
            nodes = x.reshape(B, H * W, Cin)
            ef = device_constant(_edge_feat, *key, device=x.device)
            edges = ef.to(x.dtype).expand(B, *ef.shape)

        nodes = self.MeshGraphMLP_0(nodes)
        edges = self.MeshGraphMLP_1(edges)
        for i in range(self.processor_size):
            edges = getattr(self, f"MeshEdgeBlock_{i}")(edges, nodes, nodes, mv)
            nodes = getattr(self, f"MeshNodeBlock_{i}")(edges, nodes, mv)
        out = self.MeshGraphMLP_2(nodes)
        return out.reshape(B, H, W, self.prognostic_channels), state
