"""FourCastNet (AFNONet) and FourCastNetv2 (counterpart of
`dlwpbench_tpu/models/fourcastnet.py`), and the pieces other models share:
the trunc-normal init, the transformer MLP, and the random init of the
transformer models with flax's distributions.

A ViT on the lat-lon grid (`configs/model/fourcastnet.yaml`;
`fourcastnetv2.yaml` is the same class with `filter: SFNO`):
- the patch embedding, a conv with kernel and stride `patch_size`, to a
  [B, h, w, D] token grid, plus a learned position embedding;
- `depth` x `AFNOBlock`: LayerNorm -> filter -> residual, LayerNorm -> MLP
  -> residual; the filter is "AFNO2D" (`ops.spectral.AFNO2DFilter`, whose
  output carries its own residual), "SFNO" (`y + SphericalConv(y)`) or
  "FNO2D" (`y + FNOCore(y)`, one spectral layer);
- a bias-free Dense head and the patch reassembly to [B, H, W, Cq].
The reference defines a final LayerNorm that it never applies before the
head; JAX copies that (it declares no such LayerNorm), and so does the port.

Submodules carry flax's auto-names (`Conv_0`, `pos_embed`, `AFNOBlock_i.
{LayerNorm_0, AFNO2DFilter_0 | SphericalConv_0 | FNOCore_0, LayerNorm_1,
Mlp_0}`, `Dense_0`), so `weights.load_flax_params` maps a JAX tree onto
them name for name.

With `spmd_mesh` (a `DeviceMesh`) the whole step runs on token rows
sharded over the mesh dim `dist_axis` (input through
`launch.scatter_to_ranks`, output through `launch.gather_from_ranks`):
the patch conv, the LayerNorms, the MLPs and the head on the local rows,
the AFNO2D and SFNO filters over the distributed rFFT2 and SHT (JAX hands
them the mesh, `models/fourcastnet.py:56-90,134,163`), the FNO2D filter on
the whole token grid gathered from the ranks' rows, each rank keeping its
own (`FNOCore.local`; JAX's GSPMD gathers the rows for the FFT,
`:87-96`).  The token rows must split over the ranks.  Each rank's weight
gradients are its rows' share, summed over `partition_group` (the trainer
does it)."""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from dlwpbench_tpu_torch.models.base import RolloutModel
from dlwpbench_tpu_torch.ops.spectral import AFNO2DFilter
from dlwpbench_tpu_torch.parallel import launch


def trunc_normal_init(std: float = 0.02):
    """Init fn filling a tensor in place with N(0, std) truncated at
    +-2 std (the JAX package's `trunc_normal_init`), drawn from `generator`."""

    def init(tensor: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        with torch.no_grad():
            return nn.init.trunc_normal_(
                tensor, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
            )

    return init


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's default conv init: variance 1/fan_in, normal truncated at
    +-2 std (std corrected for the truncation)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_like_flax_(model: nn.Module, generator: torch.Generator) -> None:
    """Random init with the JAX transformer models' distributions:
    trunc-normal 0.02 for Dense kernels and for parameters declared on the
    model itself (bias tables, position embeddings), lecun-normal for
    (transposed) convs, zero biases, unit LayerNorm scales."""
    trunc = trunc_normal_init()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                trunc(m.weight, generator)
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                kh, kw = m.kernel_size
                _lecun_normal_(m.weight, kh * kw * m.in_channels, generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
            else:
                continue
            if m.bias is not None:
                m.bias.zero_()
        for _, prm in model.named_parameters(recurse=False):
            trunc(prm, generator)


class Mlp(nn.Module):
    """Dense -> GELU -> Dense; tanh-approximate GELU by default, as the JAX
    package (`approximate=False` is the erf GELU of `torch.nn.GELU`)."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 approximate: bool = True):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, hidden)
        self.Dense_1 = nn.Linear(hidden, out)
        self.approximate = "tanh" if approximate else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate=self.approximate))


FILTERS = ("AFNO2D", "SFNO", "FNO2D")


class AFNOBlock(nn.Module):
    """One FourCastNet block on a [B, h, w, D] token grid (`grid_shape` is
    (h, w), which sizes the SFNO and FNO2D filters).  With `spmd_mesh` the
    block takes this rank's token rows and its filter runs distributed
    over the mesh dim `dist_axis` (the filter's `local`)."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, num_blocks: int = 8,
                 sparsity_threshold: float = 0.01, hard_thresholding_fraction: float = 1.0,
                 filter_type: str = "AFNO2D", n_modes: Sequence[int] = (12, 12),
                 exact_gelu: bool = False, fft_impl: str = "matmul",
                 grid_shape: Sequence[int] = (32, 64), spmd_mesh: Any = None,
                 dist_axis: str = "x"):
        super().__init__()
        # the SFNO and FNO2D filters' modules import this one's (as in JAX)
        from dlwpbench_tpu_torch.models.fno import FNOCore
        from dlwpbench_tpu_torch.models.sfno import SphericalConv

        self.sharded = spmd_mesh is not None
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-6)
        if filter_type == "AFNO2D":
            self.AFNO2DFilter_0 = AFNO2DFilter(
                dim, num_blocks, sparsity_threshold, hard_thresholding_fraction,
                spmd_mesh=spmd_mesh, dist_axis=dist_axis, fft_impl=fft_impl)
        elif filter_type == "SFNO":  # FourCastNetv2's mixer, the JAX block's default fft_impl
            self.SphericalConv_0 = SphericalConv(dim, dim, nlat=grid_shape[0], nlon=grid_shape[1],
                                                 spmd_mesh=spmd_mesh, dist_axis=dist_axis)
        elif filter_type == "FNO2D":  # the reference's FNO mixer, one spectral layer
            self.FNOCore_0 = FNOCore(dim, dim, dim, lifting_channels=dim,
                                     projection_channels=dim, n_modes=tuple(n_modes),
                                     n_layers=1, grid_shape=grid_shape, spmd_mesh=spmd_mesh,
                                     dist_axis=dist_axis)
        else:
            raise ValueError(f"unknown filter {filter_type!r}: expected one of {FILTERS}")
        self.filter_type = filter_type
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=1e-6)
        self.Mlp_0 = Mlp(dim, int(dim * mlp_ratio), dim, approximate=not exact_gelu)

    @property
    def filter(self) -> nn.Module:
        return getattr(self, {"AFNO2D": "AFNO2DFilter_0", "SFNO": "SphericalConv_0",
                              "FNO2D": "FNOCore_0"}[self.filter_type])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.LayerNorm_0(x)
        f = self.filter.local(y) if self.sharded else self.filter(y)
        y = f if self.filter_type == "AFNO2D" else y + f
        x = y + x  # double skip
        return self.Mlp_0(self.LayerNorm_1(x)) + x


class FourCastNet(RolloutModel):
    """AFNONet (config `type: FourCastNet`); `filter="SFNO"` is
    FourCastNetv2 (`type: FourCastNetv2`).  `seed` seeds the random init
    (JAX's distributions: trunc-normal 0.02 for the Dense layers and the
    position embedding, lecun-normal for the patch conv, 0.02 N(0, 1) for
    the AFNO weights, each spectral layer its own)."""

    def __init__(
        self,
        img_height: int = 32,
        img_width: int = 64,
        patch_size: Sequence[int] = (1, 1),
        constant_channels: int = 4,
        prescribed_channels: int = 0,
        prognostic_channels: int = 1,
        filter: str = "AFNO2D",
        embed_dim: int = 768,
        depth: int = 12,
        mlp_ratio: float = 4.0,
        num_blocks: int = 16,
        sparsity_threshold: float = 0.01,
        hard_thresholding_fraction: float = 1.0,
        context_size: int = 1,
        use_pos_embed: bool = True,
        n_modes: Sequence[int] = (12, 12),
        mesh: str = "equirectangular",
        spmd_mesh: Any = None,
        dist_axis: str = "x",
        exact_gelu: bool = False,
        fft_impl: str = "matmul",
        remat: bool = False,
        remat_policy: str = "full",
        seed: int = 0,
    ):
        super().__init__(context_size, remat, remat_policy)
        from dlwpbench_tpu_torch.models.fno import init_like_flax_ as init_filter_

        self.mesh = mesh
        ph, pw = self.patch_size = (int(patch_size[0]), int(patch_size[1]))
        h, w = int(img_height) // ph, int(img_width) // pw
        D, self.depth = int(embed_dim), int(depth)
        self.prognostic_channels = int(prognostic_channels)
        in_ch = int(constant_channels) + int(context_size) * (
            int(prescribed_channels) + int(prognostic_channels))
        self.Conv_0 = nn.Conv2d(in_ch, D, (ph, pw), stride=(ph, pw))
        self.pos_embed = nn.Parameter(torch.zeros(1, h, w, D)) if use_pos_embed else None
        for i in range(self.depth):
            setattr(self, f"AFNOBlock_{i}", AFNOBlock(
                D, mlp_ratio, num_blocks, sparsity_threshold, hard_thresholding_fraction,
                filter, tuple(n_modes), exact_gelu=exact_gelu, fft_impl=fft_impl,
                grid_shape=(h, w), spmd_mesh=spmd_mesh, dist_axis=dist_axis))
        if spmd_mesh is not None:
            self.partition_group = launch.axis(spmd_mesh, dist_axis)[0]
        self.Dense_0 = nn.Linear(D, self.prognostic_channels * ph * pw, bias=False)
        gen = torch.Generator().manual_seed(int(seed))
        init_like_flax_(self, gen)
        for i in range(self.depth):  # the filters' own draws (FNOCore: flax's Dense default)
            init_filter_(getattr(self, f"AFNOBlock_{i}").filter, gen)

    def step(self, x: torch.Tensor, state: Any, aux: Any = None):
        (ph, pw), cq = self.patch_size, self.prognostic_channels
        group, pos = self.partition_group, self.pos_embed
        if group is not None:  # this rank's token rows from here to the gather
            p, r = dist.get_world_size(group), dist.get_rank(group)
            if (x.shape[1] // ph) % p:
                raise ValueError(f"{x.shape[1] // ph} token rows do not split over {p} ranks")
            x = launch.scatter_to_ranks(x, 1, group)
            if pos is not None:
                pos = pos.narrow(1, r * (x.shape[1] // ph), x.shape[1] // ph)
        B, H, W, _ = x.shape
        h, w = H // ph, W // pw
        x = self.Conv_0(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)  # [B, h, w, D]
        if pos is not None:
            x = x + pos
        for i in range(self.depth):
            x = getattr(self, f"AFNOBlock_{i}")(x)
        x = self.Dense_0(x)  # [B, h, w, Cq * ph * pw]
        x = x.reshape(B, h, w, ph, pw, cq).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, cq)
        return (x if group is None else launch.gather_from_ranks(x, 1, group)), state
