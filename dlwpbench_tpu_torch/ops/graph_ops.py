"""Graph message passing (counterpart of `dlwpbench_tpu/ops/graph_ops.py`):
the edge-movement operators and the Modulus-style GNN blocks.

Movement forms, as in JAX:
- the gather form: `index_select` over the node axis for the per-edge
  gathers, `index_add` into zeros for the per-node sums (JAX's `jnp.take`
  and `jax.ops.segment_sum`).  Any leading batch dims ride along in one
  call: JAX vmaps them, the port does not loop over them.  On the card
  `index_add` and the backward of `index_select` add with atomics, so two
  runs may differ in the last bits;
- the onehot form (`impl="onehot"`): the gathers and sums as products with
  a 0/1 incidence matrix, `incidence_fp32 @ x.to(bfloat16).to(float32)`,
  cast back to x's dtype: JAX's bf16 operands with fp32 accumulation (the
  0/1 products are exact, only the summation order differs), whose
  backward is the transposed product;
- `impl="auto"` is the gather form.  JAX takes the onehot form under
  "auto" only when `jax.default_backend() == "tpu"` (and the incidence
  holds at most `DENSE_ONEHOT_LIMIT` entries), so off a TPU, on the CPU and
  on CUDA alike, its "auto" is the gather form too.  The port drops
  `DENSE_ONEHOT_LIMIT`: it only ever limits "auto" on a TPU;
- the stencil form (`StencilMovement`) for regular grid graphs: rolls and
  zero-filled row shifts, no gather or scatter at all.

JAX computes all of this with `jnp.take`, `segment_sum`, `dot_general` and
rolls, outside any Pallas kernel, so the port's counterparts are torch ops
(ATen's gathers and scatters, cuBLAS); there is no hand-written kernel
here.  The index vectors (int64), the incidence matrices, the in-degrees
and the stencil masks are kept on the device once per graph through
`utils.device.device_constant`: a movement is hashed by identity, and the
models build theirs once per graph (`functools.lru_cache`).

Blocks (exact wiring from the reference):
- `MeshGraphMLP` (`mesh_graph_mlp.py:103-196`): Dense -> act,
  (hidden_layers-1) more, a final Dense, an optional LayerNorm (eps 1e-5,
  torch's, not flax's 1e-6); `hidden_layers == 0` is a single Dense with no
  LayerNorm;
- `MeshEdgeBlock` (`mesh_edge_block.py:30-94`):
  e' = MLP(cat(e, n_src[src], n_dst[dst])) + e;
- `MeshNodeBlock` (`mesh_node_block.py:30-93`):
  n' = MLP(cat(aggregate(e -> dst), n)) + n.
Submodules carry flax's auto-names (`Dense_i`, `LayerNorm_0`,
`MeshGraphMLP_0`), so `weights.load_flax_params` maps a JAX tree onto them
name for name.  flax sizes each Dense from its first input; the port takes
the in-features at construction.  `pregathered` and `preaggregated`
(JAX's) take per-edge end features and per-node sums that the
partitioned GraphCast computed itself (`parallel/graphcast_dist.py`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dlwpbench_tpu_torch.utils.device import device_constant

IMPLS = ("auto", "gather", "onehot")
AGGREGATIONS = ("sum", "mean")


def check_aggregation(aggregation: str) -> None:
    if aggregation not in AGGREGATIONS:
        raise ValueError(f"aggregation {aggregation!r}: expected one of {AGGREGATIONS}")


def _onehot(idx: np.ndarray, n_nodes: int) -> np.ndarray:
    """[n_idx, n_nodes] float32 one-hot rows (row e hot at idx[e])."""
    out = np.zeros((idx.size, n_nodes), np.float32)
    out[np.arange(idx.size), idx] = 1.0
    return out


def _onehot_contract(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """m [R, C] (0/1, fp32) @ x [..., C, F] -> [..., R, F] in x's dtype:
    x rounded to bf16 once and accumulated in fp32, as JAX's bf16 operands
    with fp32 accumulation."""
    return torch.matmul(m, x.to(torch.bfloat16).float()).to(x.dtype)


def _index(mv: "EdgeMovement", which: str) -> np.ndarray:
    return getattr(mv, which).astype(np.int64)


def _incidence(mv: "EdgeMovement", which: str) -> np.ndarray:
    return _onehot(getattr(mv, which), mv.n_src if which == "src" else mv.n_dst)


def _in_degree(mv: "EdgeMovement") -> np.ndarray:
    """Each destination's in-degree, clamped to at least 1, as [n_dst, 1]."""
    return np.maximum(np.bincount(mv.dst, minlength=mv.n_dst), 1).astype(np.float32)[:, None]


class EdgeMovement:
    """Movement operators for a fixed (src, dst) graph in edge-list form:
    nodes [..., N, F], edges [..., E, F].  Hashed by identity: the key of
    its device tables."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n_src: int, n_dst: int,
                 impl: str = "auto"):
        if impl not in IMPLS:
            raise ValueError(f"movement impl {impl!r}: expected one of {IMPLS}")
        self.src = np.ascontiguousarray(src, dtype=np.int32)
        self.dst = np.ascontiguousarray(dst, dtype=np.int32)
        self.n_src, self.n_dst, self.impl = int(n_src), int(n_dst), impl

    def _gather(self, nfeat: torch.Tensor, which: str) -> torch.Tensor:
        if self.impl == "onehot":
            return _onehot_contract(device_constant(_incidence, self, which,
                                                    device=nfeat.device), nfeat)
        return nfeat.index_select(-2, device_constant(_index, self, which, device=nfeat.device))

    def gather_src(self, nfeat: torch.Tensor) -> torch.Tensor:
        return self._gather(nfeat, "src")

    def gather_dst(self, nfeat: torch.Tensor) -> torch.Tensor:
        return self._gather(nfeat, "dst")

    def aggregate(self, efeat: torch.Tensor, mode: str = "sum") -> torch.Tensor:
        """[..., E, F] -> [..., n_dst, F]: each edge's features summed onto
        its destination ("sum"), or their mean over the in-degree clamped
        to at least 1 ("mean")."""
        dev = efeat.device
        if self.impl == "onehot":
            out = _onehot_contract(device_constant(_incidence, self, "dst", device=dev).T, efeat)
        else:
            shape = (*efeat.shape[:-2], self.n_dst, efeat.shape[-1])
            out = efeat.new_zeros(shape).index_add(
                efeat.dim() - 2, device_constant(_index, self, "dst", device=dev), efeat)
        if mode == "mean":
            out = out / device_constant(_in_degree, self, device=dev).to(out.dtype)
        return out


def _stencil_valid(height: int, width: int, dirs: tuple, periodic: bool) -> np.ndarray:
    """[D, H, W, 1] float32: 1 where slot (d, r, c) is a live edge."""
    masks = []
    for dr, dc in dirs:
        m = np.ones((height, width), np.float32)
        if dr > 0:
            m[height - dr:, :] = 0.0
        elif dr < 0:
            m[: -dr, :] = 0.0
        if not periodic:
            if dc > 0:
                m[:, width - dc:] = 0.0
            elif dc < 0:
                m[:, : -dc] = 0.0
        masks.append(m)
    return np.stack(masks)[..., None]


def _shift(n: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """[..., H, W, F]: the value at (r, c) becomes n[r+dr, (c+dc) mod W];
    rows out of range are zero-filled (they only ever feed dead edge
    slots)."""
    out = n
    if dc:
        out = torch.roll(out, -dc, dims=-2)
    if dr > 0:
        out = F.pad(out[..., dr:, :, :], (0, 0, 0, 0, 0, dr))
    elif dr < 0:
        out = F.pad(out[..., :dr, :, :], (0, 0, 0, 0, -dr, 0))
    return out


class StencilMovement:
    """Movement operators for regular-grid stencil graphs (MGN `grid_2d` /
    `grid_2d_8stencil`, reference `meshgraphnet.py:233-279`).

    Nodes live as [..., H, W, F]; edges as [..., D, H, W, Fe] where slot
    (d, r, c) is the directed edge (r, c) -> (r+dr_d, (c+dc_d) mod W).
    Neighbour access is a longitude roll and a latitude shift, aggregation
    a masked shifted add.  Out-of-range latitude slots are dead edges: they
    flow through the edge MLPs but are masked out of every aggregation;
    `periodic=False` also masks the longitude ends."""

    def __init__(self, height: int, width: int, dirs: tuple[tuple[int, int], ...],
                 periodic: bool = True):
        self.H, self.W, self.dirs, self.periodic = int(height), int(width), tuple(dirs), periodic

    def valid(self, device) -> torch.Tensor:
        """The [D, H, W, 1] float32 masks on `device` (copied once)."""
        return device_constant(_stencil_valid, self.H, self.W, self.dirs, self.periodic,
                               device=device)

    def gather_src(self, nfeat: torch.Tensor) -> torch.Tensor:
        """[..., H, W, F] -> [..., D, H, W, F] (the src of slot (d, r, c) is (r, c))."""
        return nfeat.unsqueeze(-4).expand(*nfeat.shape[:-3], len(self.dirs), *nfeat.shape[-3:])

    def gather_dst(self, nfeat: torch.Tensor) -> torch.Tensor:
        """[..., H, W, F] -> [..., D, H, W, F] (the dst of slot (d, r, c))."""
        return torch.stack([_shift(nfeat, dr, dc) for dr, dc in self.dirs], dim=-4)

    def aggregate(self, efeat: torch.Tensor, mode: str = "sum") -> torch.Tensor:
        """[..., D, H, W, F] -> [..., H, W, F]: edge slot (d, r, c) lands on
        node (r+dr, c+dc); each direction plane masked, shifted back and
        added (the mean divides by the live in-edges, clamped to at least 1)."""
        valid = self.valid(efeat.device).to(efeat.dtype)
        vals = torch.movedim(efeat, -4, 0)
        total = cnt = None
        for i, (dr, dc) in enumerate(self.dirs):
            contrib = _shift(vals[i] * valid[i], -dr, -dc)
            total = contrib if total is None else total + contrib
            if mode == "mean":
                c = _shift(valid[i], -dr, -dc)
                cnt = c if cnt is None else cnt + c
        if mode == "mean":
            total = total / torch.clamp(cnt, min=1.0)
        return total


class MeshGraphMLP(nn.Module):
    """Dense -> act, (hidden_layers - 1) x [Dense -> act], Dense, then a
    LayerNorm when `norm`; `hidden_layers == 0` is one Dense alone."""

    def __init__(self, in_features: int, output_dim: int = 512, hidden_dim: int = 512,
                 hidden_layers: int = 1, norm: bool = True,
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.silu):
        super().__init__()
        self.activation = activation
        self.n_dense = 1 if hidden_layers == 0 else hidden_layers + 1
        widths = [int(in_features)] + [int(hidden_dim)] * (self.n_dense - 1) + [int(output_dim)]
        for i in range(self.n_dense):
            setattr(self, f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))
        # torch's LayerNorm eps (the reference default), not flax's 1e-6
        self.LayerNorm_0 = (nn.LayerNorm(int(output_dim), eps=1e-5)
                            if norm and hidden_layers > 0 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_dense - 1):
            x = self.activation(getattr(self, f"Dense_{i}")(x))
        x = getattr(self, f"Dense_{self.n_dense - 1}")(x)
        return x if self.LayerNorm_0 is None else self.LayerNorm_0(x)


class MeshEdgeBlock(nn.Module):
    """e' = MLP(cat(e, gather_src(n_src), gather_dst(n_dst))) + e, the
    gathers from a movement (`EdgeMovement`, or `StencilMovement` in the
    [..., D, H, W, F] layout); in-features Fe + Fsrc + Fdst."""

    def __init__(self, in_features: int, output_dim: int = 512, hidden_dim: int = 512,
                 hidden_layers: int = 1,
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.silu):
        super().__init__()
        self.MeshGraphMLP_0 = MeshGraphMLP(in_features, output_dim, hidden_dim, hidden_layers,
                                           activation=activation)

    def forward(self, efeat, src_nfeat, dst_nfeat, movement=None, pregathered: bool = False):
        """`pregathered`: {src,dst}_nfeat are already per-edge [..., E, Fn]
        and `movement` is not used."""
        if not pregathered:
            src_nfeat, dst_nfeat = movement.gather_src(src_nfeat), movement.gather_dst(dst_nfeat)
        cat = torch.cat([efeat, src_nfeat, dst_nfeat], dim=-1)
        return self.MeshGraphMLP_0(cat) + efeat


class MeshNodeBlock(nn.Module):
    """n' = MLP(cat(movement.aggregate(e), n)) + n; in-features Fe + Fn."""

    def __init__(self, in_features: int, output_dim: int = 512, hidden_dim: int = 512,
                 hidden_layers: int = 1, aggregation: str = "sum",
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.silu):
        super().__init__()
        check_aggregation(aggregation)
        self.aggregation = aggregation
        self.MeshGraphMLP_0 = MeshGraphMLP(in_features, output_dim, hidden_dim, hidden_layers,
                                           activation=activation)

    def forward(self, efeat, nfeat, movement=None, preaggregated: bool = False):
        """`preaggregated`: `efeat` is already the per-node aggregation
        [..., N, Fe] and `movement` is not used."""
        agg = efeat if preaggregated else movement.aggregate(efeat, self.aggregation)
        return self.MeshGraphMLP_0(torch.cat([agg, nfeat], dim=-1)) + nfeat
