"""Pieces of FourCastNet shared with other models (counterpart of
`dlwpbench_tpu/models/fourcastnet.py:27-45`): the trunc-normal init, the
transformer MLP, and the random init of the transformer models with flax's
distributions.  FourCastNet itself is not ported yet."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


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
