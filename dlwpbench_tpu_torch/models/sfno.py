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

Not ported: the SHTs over a device mesh (`spmd_mesh`) and the fused
distributed schedule (`dist_schedule="fused"`), ROADMAP queue A, item 27;
both raise.
"""

from __future__ import annotations

import itertools
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from dlwpbench_tpu_torch.models.base import RolloutModel
from dlwpbench_tpu_torch.models.fno import gelu, init_like_flax_
from dlwpbench_tpu_torch.ops.sht import isht, isht_real, sht, sht_real, sht_tables
from dlwpbench_tpu_torch.ops.spectral import check_fft_impl, no_mesh

DIST_SCHEDULES = ("per_conv", "fused")


class SphericalConv(nn.Module):
    """Driscoll-Healy spherical convolution on [B, nlat, nlon, Cin]:
    per-degree channel mixing between the SHT and its inverse, in fp32
    (the weight taken in fp32, the result cast back to the field's
    dtype).  `fft_impl="matmul"` (the default) runs `sht_real` /
    `isht_real`, `"fft"` `sht` / `isht` through `torch.fft`."""

    def __init__(self, in_channels: int, features: int, nlat: int, nlon: int,
                 grid: str = "equiangular", lmax: Optional[int] = None,
                 mmax: Optional[int] = None, spmd_mesh: Any = None,
                 fft_impl: str = "matmul"):
        super().__init__()
        no_mesh(spmd_mesh, "the spherical convolution's SHTs")
        check_fft_impl(fft_impl)
        self.tables = sht_tables(int(nlat), int(nlon), lmax, mmax, grid)
        self.fft_impl = fft_impl
        self.weight = nn.Parameter(torch.empty(int(in_channels), int(features),
                                               self.tables.lmax, 2))
        self.init_(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """JAX's draw: N(0, 1) / sqrt(Cin Cout)."""
        cin, cout = self.weight.shape[:2]
        self.weight.normal_(generator=generator).div_(float(np.sqrt(cin * cout)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
    zero)."""

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
        fft_impl: str = "matmul",
        dist_schedule: str = "per_conv",
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
        no_mesh(spmd_mesh, "SFNO")
        if dist_schedule == "fused":
            raise NotImplementedError(
                "SFNO's fused distributed schedule (dist_schedule='fused') is not ported to "
                "PyTorch yet (ROADMAP queue A, item 27)")
        self.mesh = mesh
        self.height, self.width = H, W = int(height), int(width)
        D = int(embed_dim)
        self.num_layers, self.use_mlp, self.big_skip = int(num_layers), bool(use_mlp), bool(big_skip)
        lmax = max(1, int((H // max(1, int(scale_factor))) * float(hard_thresholding_fraction)))
        in_ch = int(constant_channels) + int(context_size) * (
            int(prescribed_channels) + int(prognostic_channels))
        dense = itertools.count()

        def add_dense(c_in: int, c_out: int) -> str:
            name = f"Dense_{next(dense)}"
            setattr(self, name, nn.Linear(c_in, c_out))
            return name

        self.encoder = [add_dense(in_ch, D), add_dense(D, D)]
        self.pos_embed = nn.Parameter(torch.zeros(1, H, W, D)) if pos_embed else None
        self.blocks = []
        for i in range(self.num_layers):
            setattr(self, f"SphericalConv_{i}", SphericalConv(
                D, D, nlat=H, nlon=W, grid=grid, lmax=lmax, fft_impl=fft_impl))
            skip = add_dense(D, D)
            mlp = (add_dense(D, 2 * D), add_dense(2 * D, D)) if self.use_mlp else None
            self.blocks.append((f"SphericalConv_{i}", skip, mlp))
        self.decoder = [add_dense(D + in_ch if self.big_skip else D, D),
                        add_dense(D, int(prognostic_channels))]
        init_like_flax_(self, torch.Generator().manual_seed(int(seed)))

    def step(self, x: torch.Tensor, state: Any, aux: Any = None):
        if tuple(x.shape[1:3]) != (self.height, self.width):
            raise ValueError(f"SFNO built for a {self.height}x{self.width} grid, given "
                             f"{tuple(x.shape[1:3])}")
        inp = x
        x = getattr(self, self.encoder[1])(gelu(getattr(self, self.encoder[0])(x)))
        if self.pos_embed is not None:
            x = x + self.pos_embed
        for conv, skip, mlp in self.blocks:
            x = gelu(getattr(self, conv)(x) + getattr(self, skip)(x))  # the inner skip
            if mlp is not None:
                x = x + getattr(self, mlp[1])(gelu(getattr(self, mlp[0])(x)))
        if self.big_skip:
            x = torch.cat([x, inp], dim=-1)
        x = gelu(getattr(self, self.decoder[0])(x))
        return getattr(self, self.decoder[1])(x), state
