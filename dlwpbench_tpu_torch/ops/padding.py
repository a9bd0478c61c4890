"""Boundary-condition padding for global grids (counterpart of
`dlwpbench_tpu/ops/padding.py`).

- `cylinder_pad`: circular in longitude (the last axis), zero in latitude
  (the one before), on the trailing [H, W] of any leading dims.
- `healpix_pad`, `healpix_pad_channels_last`: neighbour padding of the 12
  HEALPix faces as one gather over the flattened 12*n*n axis
  (`index_select`) and a 2-tap weighted sum, from the tables of
  `grids.healpix.build_pad_indices`.  The products and the sum over the two
  taps are those of the JAX op, so fp32 results are bit for bit the same.
  The tables live on the tensor's device (`utils.device.device_constant`,
  one copy per nside, pad width and device), so a forward copies nothing
  from the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dlwpbench_tpu_torch.grids import healpix as hpx_geom
from dlwpbench_tpu_torch.utils.device import device_constant


def cylinder_pad(x: torch.Tensor, padding: int) -> torch.Tensor:
    """Circular pad in longitude (last axis), zero pad in latitude (axis -2)."""
    p = int(padding)
    if p == 0:
        return x
    x = torch.cat([x[..., -p:], x, x[..., :p]], dim=-1)
    return F.pad(x, (0, 0, p, p))


def _pad_index(nside: int, padding: int) -> np.ndarray:
    """The gather's flat source indices, [12 * (n+2p) * (n+2p) * 2] int64."""
    return hpx_geom.build_pad_indices(nside, padding)[0].reshape(-1).astype(np.int64)


def _pad_weight(nside: int, padding: int) -> np.ndarray:
    """The taps' weights, [12, n+2p, n+2p, 2] float32."""
    return hpx_geom.build_pad_indices(nside, padding)[1]


def _tables(nside: int, padding: int, like: torch.Tensor):
    idx = device_constant(_pad_index, nside, padding, device=like.device)
    w = device_constant(_pad_weight, nside, padding, device=like.device)
    return idx, w.to(like.dtype)


def healpix_pad(x: torch.Tensor, padding: int) -> torch.Tensor:
    """Neighbour-pad a HEALPix field [..., 12, n, n] -> [..., 12, n+2p, n+2p],
    with the reference's neighbour, rotation and corner rules."""
    *lead, F_, H, W = x.shape
    if F_ != 12 or H != W:
        raise ValueError(f"expected [..., 12, n, n], got {tuple(x.shape)}")
    idx, w = _tables(H, int(padding), x)
    g = x.reshape(*lead, F_ * H * W).index_select(-1, idx).reshape(*lead, *w.shape)
    return (g * w).sum(-1)


def healpix_pad_channels_last(x: torch.Tensor, padding: int) -> torch.Tensor:
    """Neighbour-pad a channels-last HEALPix field [B, 12, n, n, C] ->
    [B, 12, n+2p, n+2p, C]; channels stay the trailing (contiguous) dim, so
    the gather moves whole channel rows and feeds NHWC convs directly."""
    B, F_, H, W, C = x.shape
    if F_ != 12 or H != W:
        raise ValueError(f"expected [B, 12, n, n, C], got {tuple(x.shape)}")
    idx, w = _tables(H, int(padding), x)
    g = x.reshape(B, F_ * H * W, C).index_select(1, idx).reshape(B, *w.shape, C)
    return (g * w[..., None]).sum(-2)
