"""FNO2D and TFNO2D (counterpart of `dlwpbench_tpu/models/fno.py`):

    lifting: Dense(in -> lifting) -> gelu -> Dense(lifting -> hidden)
    n_layers x [ SpectralConv2d + Dense skip, gelu between layers ]
    projection: Dense(hidden -> projection) -> gelu -> Dense(-> out)

`TFNO2DModule` is the same with Tucker-factorised spectral weights
(`configs/model/fno.yaml`: modes 12 x 12, hidden 32, lifting and
projection 256, 4 layers, rank 0.8).  GELU is flax's default, the tanh
approximation.  Submodules carry flax's auto-names in call order
(`Dense_0`, `Dense_1`, then `SpectralConv2d_i` and `Dense_{2+i}`
interleaved, then the projection's two), so `weights.load_flax_params`
maps a JAX tree onto them name for name.

The spectral weights' mode counts follow the grid (`grid_shape`, see
`ops.spectral.SpectralConv2d`), which every build gives: the entry points
pass the data's.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dlwpbench_tpu_torch.models.base import RolloutModel
from dlwpbench_tpu_torch.models.fourcastnet import _lecun_normal_
from dlwpbench_tpu_torch.ops.spectral import SpectralConv2d
from dlwpbench_tpu_torch.parallel import launch


def init_like_flax_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default init: lecun-normal Dense kernels and zero biases;
    each spectral layer draws its own weights (`init_`)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.in_features, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif hasattr(m, "init_"):
                m.init_(generator)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's `nn.gelu` (the tanh approximation)."""
    return F.gelu(x, approximate="tanh")


class FNOCore(nn.Module):
    """The operator on [B, H, W, Cin] fields.  With `spmd_mesh` (FourCastNet's
    FNO2D mixer on token rows sharded over the mesh dim `dist_axis`),
    `local` maps this rank's rows to its rows of the output: JAX runs the
    operator on its sharded rows and GSPMD gathers them for the FFT."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int,
                 lifting_channels: int = 256, projection_channels: int = 256,
                 n_modes: Sequence[int] = (12, 12), n_layers: int = 4,
                 tucker_rank: Optional[float] = None, use_bias: bool = True,
                 fft_impl: str = "matmul", *, grid_shape: Sequence[int],
                 spmd_mesh: Any = None, dist_axis: str = "x"):
        super().__init__()
        self.group = None if spmd_mesh is None else launch.axis(spmd_mesh, dist_axis)[0]
        self.n_layers = int(n_layers)
        hidden = int(hidden_channels)
        self.Dense_0 = nn.Linear(int(in_channels), int(lifting_channels))
        self.Dense_1 = nn.Linear(int(lifting_channels), hidden)
        for i in range(self.n_layers):
            setattr(self, f"SpectralConv2d_{i}", SpectralConv2d(
                hidden, hidden, int(n_modes[0]), int(n_modes[1]), tucker_rank=tucker_rank,
                fft_impl=fft_impl, grid_shape=grid_shape))
            setattr(self, f"Dense_{2 + i}", nn.Linear(hidden, hidden, bias=use_bias))
        L = self.n_layers
        setattr(self, f"Dense_{2 + L}", nn.Linear(hidden, int(projection_channels)))
        setattr(self, f"Dense_{3 + L}", nn.Linear(int(projection_channels), int(out_channels)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dense_1(gelu(self.Dense_0(x)))
        L = self.n_layers
        for i in range(L):
            y = getattr(self, f"SpectralConv2d_{i}")(x) + getattr(self, f"Dense_{2 + i}")(x)
            x = gelu(y) if i < L - 1 else y
        x = gelu(getattr(self, f"Dense_{2 + L}")(x))
        return getattr(self, f"Dense_{3 + L}")(x)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H/P, W, Cin] rows of this rank -> its rows of the output: the
        rows gathered into the whole field (`launch.all_gather`, whose
        backward sums every rank's cotangent of the field, as each rank's
        rows reach all of it through the FFT), the operator on it, this
        rank's rows kept.  The weight gradients are this rank's rows'
        share, summed over the group by the trainer."""
        r = torch.distributed.get_rank(self.group)
        return self(launch.all_gather(x, 1, self.group)).narrow(1, r * x.shape[1], x.shape[1])


class FNO2DModule(RolloutModel):
    """Reference `FNO2DModule` (config `type: FNO2DModule`, full spectral
    weights).  `seed` seeds the random init (JAX's distributions);
    `grid_shape` (H, W), the data's grid, sizes the spectral weights."""

    tucker = False

    def __init__(
        self,
        constant_channels: int = 4,
        prescribed_channels: int = 0,
        prognostic_channels: int = 1,
        hidden_channels: int = 32,
        lifting_channels: int = 256,
        projection_channels: int = 256,
        n_modes: Sequence[int] = (12, 12),
        n_layers: int = 4,
        rank: float = 0.8,
        bias: bool = True,
        context_size: int = 1,
        mesh: str = "equirectangular",
        fft_impl: str = "matmul",
        *,
        grid_shape: Sequence[int],
        remat: bool = False,
        remat_policy: str = "full",
        seed: int = 0,
    ):
        super().__init__(context_size, remat, remat_policy)
        self.mesh = mesh
        in_ch = int(constant_channels) + int(context_size) * (
            int(prescribed_channels) + int(prognostic_channels))
        self.FNOCore_0 = FNOCore(
            in_ch, hidden_channels, int(prognostic_channels), lifting_channels,
            projection_channels, tuple(n_modes), n_layers,
            tucker_rank=float(rank) if self.tucker else None, use_bias=bias,
            fft_impl=fft_impl, grid_shape=grid_shape)
        init_like_flax_(self, torch.Generator().manual_seed(int(seed)))

    def step(self, x: torch.Tensor, state: Any, aux: Any = None):
        return self.FNOCore_0(x), state


class TFNO2DModule(FNO2DModule):
    """Reference `TFNO2DModule` (Tucker-factorised spectral weights)."""

    tucker = True
