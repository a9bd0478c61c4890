"""Weights drawn from the seed, by parameter name and shape, in one call.

One `torch.randn` over the total number of elements, on the device and
from a generator seeded by the run's seed, is cut into the parameters in
the order of their sorted names and scaled by what each name says it is:

- LayerNorm scales: 1 + 0.1 n;
- convolution kernels: n / sqrt(fan in) (LeCun normal);
- every other kernel, table and embedding: 0.02 n;
- biases: 0.02 n.

The same seed gives the same weights for the program and for the
reference, which share parameter names and shapes.
"""

from __future__ import annotations

import math

import torch


def _scale_and_offset(name: str, shape: torch.Size) -> tuple[float, float]:
    leaf = name.rsplit(".", 1)[-1]
    owner = name.rsplit(".", 2)[-2] if "." in name else ""
    if owner.startswith("LayerNorm") and leaf == "weight":
        return 0.1, 1.0
    if leaf == "weight" and owner.startswith("ConvTranspose") and len(shape) == 4:
        return 1.0 / math.sqrt(shape[0] * shape[2] * shape[3]), 0.0
    if leaf == "weight" and owner.startswith("Conv") and len(shape) == 4:
        return 1.0 / math.sqrt(shape[1] * shape[2] * shape[3]), 0.0
    return 0.02, 0.0


def draw(shapes: dict[str, torch.Size], generator: torch.Generator,
         device) -> dict[str, torch.Tensor]:
    """{name: float32 tensor of `shapes[name]`} on `device`."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    out = {}
    for name, chunk in zip(names, torch.split(flat, sizes)):
        scale, offset = _scale_and_offset(name, shapes[name])
        out[name] = (chunk * scale + offset).reshape(shapes[name])
    return out


def load(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy `weights` into `model`'s parameters; the names must match."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        missing, extra = sorted(set(params) - set(weights)), sorted(set(weights) - set(params))
        raise KeyError(f"parameter names differ: model lacks {extra[:5]}, weights lack "
                       f"{missing[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise ValueError(f"{name}: model {tuple(p.shape)}, weights "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])
