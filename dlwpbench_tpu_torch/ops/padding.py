"""Boundary-condition padding for global lat-lon grids (counterpart of
`dlwpbench_tpu/ops/padding.py:30-37`).

- `cylinder_pad`: circular in longitude (the last axis), zero in latitude
  (the one before), on the trailing [H, W] of any leading dims.

The HEALPix neighbour padding (`healpix_pad`, `healpix_pad_channels_last`)
is not ported yet (ROADMAP queue A, item 8).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cylinder_pad(x: torch.Tensor, padding: int) -> torch.Tensor:
    """Circular pad in longitude (last axis), zero pad in latitude (axis -2)."""
    p = int(padding)
    if p == 0:
        return x
    x = torch.cat([x[..., -p:], x, x[..., :p]], dim=-1)
    return F.pad(x, (0, 0, p, p))
