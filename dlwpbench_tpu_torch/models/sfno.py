"""SFNO, the spherical Fourier neural operator on the from-scratch SHT
(counterpart of `dlwpbench_tpu/models/sfno.py`; `configs/model/sfno.yaml`:
equiangular grid, embed 256, 4 layers, "driscoll-healy", big skip,
position embedding, MLP):

    encoder: Dense(embed) -> gelu -> Dense(embed)  (+ position embedding)
    num_layers x block:
        y = ISHT( W_l . SHT(x) ) + Dense_skip(x); x = gelu(y)
        x = x + MLP(x)                      (use_mlp)
    big skip: concatenate the step's input; decoder: Dense -> gelu -> Dense(out)

`SphericalConv` is the "driscoll-healy" spherical convolution: its weight
[Cin, Cout, lmax, 2] mixes channels per degree l, shared across m.
Submodules carry flax's auto-names in call order (`Dense_0`, `Dense_1`,
`pos_embed`, then per layer `SphericalConv_i` and its 1 or 3 Dense
layers, then the decoder's two), so `weights.load_flax_params` maps a JAX
tree onto them name for name.

With `spmd_mesh` (a `DeviceMesh`, `parallel/launch.py::global_mesh`)
the whole step runs on latitude rows sharded over the mesh dim
`dist_axis`, as JAX's SFNO on a sharded input: the input enters through
`launch.scatter_to_ranks` and the output leaves through
`launch.gather_from_ranks`; the Dense layers run on the local rows and
the SHTs are the distributed ones (`parallel/sht_dist.py`).
`dist_schedule` "per_conv" (the default: the single-device tree, each
`SphericalConv_i` its own distributed SHT pair) or "fused" (the block
stack as `parallel/spectral_dist.py::dist_sfno_blocks`, its parameters
`blocks_{i}_{spec,skip_kernel,skip_bias,mlp1_kernel,mlp1_bias,
mlp2_kernel,mlp2_bias}` on the model itself, kernels in flax's [in, out]
layout, the encoder and decoder `Dense_0..3`: JAX's tree).  Without a
mesh "fused" builds the per-conv tree, as JAX.  Each rank's weight
gradients are its rows' share; `partition_group` names the group they are
summed over (the trainer does it).
"""

from __future__ import annotations

import itertools
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from dlwpbench_tpu_torch.models.base import RolloutModel
from dlwpbench_tpu_torch.models.fno import gelu, init_like_flax_
from dlwpbench_tpu_torch.models.fourcastnet import _lecun_normal_
from dlwpbench_tpu_torch.ops.sht import isht, isht_real, sht, sht_real, sht_tables
from dlwpbench_tpu_torch.ops.spectral import check_fft_impl
from dlwpbench_tpu_torch.parallel import launch
from dlwpbench_tpu_torch.parallel.sht_dist import dist_isht, dist_sht
from dlwpbench_tpu_torch.parallel.spectral_dist import dist_sfno_blocks

DIST_SCHEDULES = ("per_conv", "fused")


def comm_dtype(dist_comm_bf16: Any, x: torch.Tensor):
    """The exchanges' payload dtype: bf16 for `True`, and for "auto" when
    the activations are bf16 (the trainer's bf16 compute has accepted that
    rounding); None (fp32) otherwise."""
    if dist_comm_bf16 is True or (dist_comm_bf16 == "auto" and x.dtype == torch.bfloat16):
        return torch.bfloat16
    return None


class SphericalConv(nn.Module):
    """Driscoll-Healy spherical convolution on [B, nlat, nlon, Cin]:
    per-degree channel mixing between the SHT and its inverse, in fp32
    (the weight taken in fp32, the result cast back to the field's
    dtype).  `fft_impl="matmul"` (the default) runs `sht_real` /
    `isht_real`, `"fft"` `sht` / `isht` through `torch.fft`.

    With `spmd_mesh` the SHT pair is the distributed one over the mesh
    dim `dist_axis` (`fft_impl` then unused, as in JAX): `forward` takes
    and gives the replicated field, `local` this rank's latitude rows
    (a model whose step is sharded calls it).  `dist_pipeline_chunks`
    channel chunks per exchange, `dist_comm_bf16` (True, False or "auto":
    `comm_dtype`)."""

    def __init__(self, in_channels: int, features: int, nlat: int, nlon: int,
                 grid: str = "equiangular", lmax: Optional[int] = None,
                 mmax: Optional[int] = None, spmd_mesh: Any = None, dist_axis: str = "x",
                 dist_pipeline_chunks: int = 4, dist_comm_bf16: Any = "auto",
                 fft_impl: str = "matmul"):
        super().__init__()
        check_fft_impl(fft_impl)
        self.tables = sht_tables(int(nlat), int(nlon), lmax, mmax, grid)
        self.fft_impl = fft_impl
        self.group = None if spmd_mesh is None else launch.axis(spmd_mesh, dist_axis)[0]
        self.dist_pipeline_chunks, self.dist_comm_bf16 = int(dist_pipeline_chunks), dist_comm_bf16
        self.weight = nn.Parameter(torch.empty(int(in_channels), int(features),
                                               self.tables.lmax, 2))
        self.init_(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """JAX's draw: N(0, 1) / sqrt(Cin Cout)."""
        cin, cout = self.weight.shape[:2]
        self.weight.normal_(generator=generator).div_(float(np.sqrt(cin * cout)))

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """[B, nlat/P, nlon, Cin] rows of this rank -> its rows of the
        output, through the distributed SHT pair."""
        w = torch.complex(self.weight[..., 0].float(), self.weight[..., 1].float())
        cd = comm_dtype(self.dist_comm_bf16, x)
        k = self.dist_pipeline_chunks
        a = dist_sht(torch.movedim(x, -1, 1), self.tables, self.group, k, cd)
        y = dist_isht(torch.einsum("bilm,iol->bolm", a, w), self.tables, self.group, k, cd)
        return torch.movedim(y, 1, -1).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is not None:
            y = self.local(launch.scatter_to_ranks(x, 1, self.group))
            return launch.gather_from_ranks(y, 1, self.group)
        t, w = self.tables, self.weight.float()
        f = torch.movedim(x, -1, 1)  # [B, C, H, W]
        if self.fft_impl == "matmul":
            ar, ai = sht_real(f, t)  # [B, C, l, m]
            wr, wi = w[..., 0], w[..., 1]
            our = (torch.einsum("bilm,iol->bolm", ar, wr)
                   - torch.einsum("bilm,iol->bolm", ai, wi))
            oui = (torch.einsum("bilm,iol->bolm", ar, wi)
                   + torch.einsum("bilm,iol->bolm", ai, wr))
            y = isht_real(our, oui, t)  # [B, Cout, H, W]
        else:
            out = torch.einsum("bilm,iol->bolm", sht(f, t), torch.complex(w[..., 0], w[..., 1]))
            y = isht(out, t)
        return torch.movedim(y, 1, -1).to(x.dtype)


class SFNO2DModule(RolloutModel):
    """Reference `SFNO2DModule` (config `type: SFNO2DModule`).  `height`
    and `width` are the grid's (JAX reads them from the first input): they
    set lmax = int(height // scale_factor x hard_thresholding_fraction),
    the SHT tables and the position embedding's shape.  `seed` seeds the
    random init (JAX's distributions; the position embedding starts at
    zero).  `spmd_mesh`, `dist_axis`, `dist_schedule`,
    `dist_pipeline_chunks` (the fused schedule's channel chunks, and each
    per-conv exchange's) and `dist_comm_bf16`: the module's docstring."""

    def __init__(
        self,
        constant_channels: int = 4,
        prescribed_channels: int = 1,
        prognostic_channels: int = 8,
        grid: str = "equiangular",
        num_layers: int = 4,
        scale_factor: int = 1,
        embed_dim: int = 256,
        operator_type: str = "driscoll-healy",
        context_size: int = 1,
        height: int = 32,
        width: int = 64,
        hard_thresholding_fraction: float = 1.0,
        rank: float = 1.0,
        big_skip: bool = True,
        pos_embed: bool = True,
        use_mlp: bool = True,
        mesh: str = "equirectangular",
        spmd_mesh: Any = None,
        dist_axis: str = "x",
        fft_impl: str = "matmul",
        dist_schedule: str = "per_conv",
        dist_pipeline_chunks: int = 8,
        dist_comm_bf16: Any = "auto",
        remat: bool = False,
        remat_policy: str = "full",
        seed: int = 0,
    ):
        super().__init__(context_size, remat, remat_policy)
        if dist_schedule not in DIST_SCHEDULES:
            raise ValueError(
                f"dist_schedule={dist_schedule!r}: expected 'per_conv' or 'fused' (the two "
                "schedules have different parameter trees, so a silent fallback would train "
                "a different model)")
        self.fused = spmd_mesh is not None and dist_schedule == "fused"
        if self.fused and not use_mlp:
            raise ValueError("the fused schedule covers the use_mlp block form")
        self.mesh = mesh
        self.height, self.width = H, W = int(height), int(width)
        D = int(embed_dim)
        self.num_layers, self.use_mlp, self.big_skip = int(num_layers), bool(use_mlp), bool(big_skip)
        lmax = max(1, int((H // max(1, int(scale_factor))) * float(hard_thresholding_fraction)))
        in_ch = int(constant_channels) + int(context_size) * (
            int(prescribed_channels) + int(prognostic_channels))
        self.dist_pipeline_chunks, self.dist_comm_bf16 = int(dist_pipeline_chunks), dist_comm_bf16
        if spmd_mesh is not None:
            self.partition_group = launch.axis(spmd_mesh, dist_axis)[0]
        dense = itertools.count()

        def add_dense(c_in: int, c_out: int) -> str:
            name = f"Dense_{next(dense)}"
            setattr(self, name, nn.Linear(c_in, c_out))
            return name

        self.encoder = [add_dense(in_ch, D), add_dense(D, D)]
        self.pos_embed = nn.Parameter(torch.zeros(1, H, W, D)) if pos_embed else None
        self.blocks = []
        if self.fused:
            self.tables = sht_tables(H, W, lmax, None, grid)
            for i in range(self.num_layers):
                for name, shape in (("spec", (D, D, self.tables.lmax, 2)),
                                    ("skip_kernel", (D, D)), ("skip_bias", (D,)),
                                    ("mlp1_kernel", (D, 2 * D)), ("mlp1_bias", (2 * D,)),
                                    ("mlp2_kernel", (2 * D, D)), ("mlp2_bias", (D,))):
                    setattr(self, f"blocks_{i}_{name}", nn.Parameter(torch.zeros(shape)))
        else:
            for i in range(self.num_layers):
                setattr(self, f"SphericalConv_{i}", SphericalConv(
                    D, D, nlat=H, nlon=W, grid=grid, lmax=lmax, spmd_mesh=spmd_mesh,
                    dist_axis=dist_axis, dist_pipeline_chunks=dist_pipeline_chunks,
                    dist_comm_bf16=dist_comm_bf16, fft_impl=fft_impl))
                skip = add_dense(D, D)
                mlp = (add_dense(D, 2 * D), add_dense(2 * D, D)) if self.use_mlp else None
                self.blocks.append((f"SphericalConv_{i}", skip, mlp))
        self.decoder = [add_dense(D + in_ch if self.big_skip else D, D),
                        add_dense(D, int(prognostic_channels))]
        gen = torch.Generator().manual_seed(int(seed))
        init_like_flax_(self, gen)
        if self.fused:
            self._init_fused_(gen, D)

    @torch.no_grad()
    def _init_fused_(self, gen: torch.Generator, D: int) -> None:
        """JAX's draws for the fused parameters: the spectral weight N(0,
        1) / D, lecun-normal kernels, zero biases."""
        for i in range(self.num_layers):
            getattr(self, f"blocks_{i}_spec").normal_(generator=gen).div_(float(D))
            for name in ("skip", "mlp1", "mlp2"):
                k = getattr(self, f"blocks_{i}_{name}_kernel")
                _lecun_normal_(k, k.shape[0], gen)

    def _fused_layers(self) -> list:
        return [{key: getattr(self, f"blocks_{i}_{name}") for key, name in (
            ("spec", "spec"), ("skip_k", "skip_kernel"), ("skip_b", "skip_bias"),
            ("mlp1_k", "mlp1_kernel"), ("mlp1_b", "mlp1_bias"), ("mlp2_k", "mlp2_kernel"),
            ("mlp2_b", "mlp2_bias"))} for i in range(self.num_layers)]

    def step(self, x: torch.Tensor, state: Any, aux: Any = None):
        if tuple(x.shape[1:3]) != (self.height, self.width):
            raise ValueError(f"SFNO built for a {self.height}x{self.width} grid, given "
                             f"{tuple(x.shape[1:3])}")
        group = self.partition_group
        pos = self.pos_embed
        if group is not None:  # this rank's latitude rows from here to the gather
            x = launch.scatter_to_ranks(x, 1, group)
            if pos is not None:
                pos = pos.narrow(1, dist.get_rank(group) * x.shape[1], x.shape[1])
        inp = x
        x = getattr(self, self.encoder[1])(gelu(getattr(self, self.encoder[0])(x)))
        if pos is not None:
            x = x + pos
        if self.fused:
            x = dist_sfno_blocks(x, self._fused_layers(), self.tables, group,
                                 self.dist_pipeline_chunks, comm_dtype(self.dist_comm_bf16, x))
        for conv, skip, mlp in self.blocks:
            conv = getattr(self, conv)
            y = conv(x) if group is None else conv.local(x)
            x = gelu(y + getattr(self, skip)(x))  # the inner skip
            if mlp is not None:
                x = x + getattr(self, mlp[1])(gelu(getattr(self, mlp[0])(x)))
        if self.big_skip:
            x = torch.cat([x, inp], dim=-1)
        x = gelu(getattr(self, self.decoder[0])(x))
        out = getattr(self, self.decoder[1])(x)
        return (out if group is None else launch.gather_from_ranks(out, 1, group)), state
