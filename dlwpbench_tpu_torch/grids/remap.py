"""Lat-lon <-> HEALPix remapping as precomputed sparse interpolation operators
(the port's copy of `dlwpbench_tpu/grids/remap.py`).

The reference remaps with astropy WCS + reproject + healpy
(`data/processing/healpix_mapping.py:93-405`); here both directions are
precomputed gather tables (4 source indices + bilinear weights per target
pixel, built in numpy) applied as one gather and a 4-tap weighted sum in
torch, on whatever device the data lies on.

- `ll2hpx`: each HEALPix pixel center (nested, [F=12, nside, nside] layout of
  `grids.healpix`) bilinearly samples the cell-centered lat-lon grid
  (periodic longitude, latitude clamped at the poles).
- `hpx2ll`: each lat-lon point interpolates the HEALPix map with the
  ring-bilinear scheme (the healpy `get_interp_weights` algorithm): linear in
  longitude within the two bracketing iso-latitude rings, then linear in
  colatitude across them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from dlwpbench_tpu_torch.grids import healpix as hpx
from dlwpbench_tpu_torch.utils.device import device_constant


@dataclasses.dataclass(frozen=True, eq=False)  # hashed by identity: a device_constant key
class RemapOp:
    idx: np.ndarray  # [N_out, 4] int32 into flattened source
    w: np.ndarray  # [N_out, 4] float32

    def apply(self, x, out_shape):
        """x: [..., N_in_flat], a torch tensor (on any device) or a numpy
        array -> [..., *out_shape] of the same kind: the 4 sources gathered
        and summed with their weights, in x's dtype."""
        if isinstance(x, np.ndarray):
            return self.apply(torch.from_numpy(np.ascontiguousarray(x)), out_shape).numpy()
        idx = device_constant(_flat_index, self, device=x.device)
        w = device_constant(_weights, self, device=x.device).to(x.dtype)
        g = x.index_select(-1, idx).reshape(*x.shape[:-1], *self.w.shape)  # [..., N_out, 4]
        return (g * w).sum(-1).reshape(*x.shape[:-1], *out_shape)


def _flat_index(op: RemapOp) -> np.ndarray:
    return op.idx.reshape(-1).astype(np.int64)


def _weights(op: RemapOp) -> np.ndarray:
    return op.w


@functools.lru_cache(maxsize=None)
def build_ll2hpx(nlat: int, nlon: int, nside: int) -> RemapOp:
    """Bilinear sampling of the lat-lon grid at HEALPix pixel centers."""
    nest_idx = hpx.nest_to_fhw(nside).reshape(-1)  # [12*n*n] nested ids
    lat, lon = hpx.nest_pix2ang(nside, nest_idx)

    dlat = 180.0 / nlat
    lats = -90 + dlat / 2 + dlat * np.arange(nlat)
    dlon = 360.0 / nlon

    fy = (lat - lats[0]) / dlat
    y0 = np.clip(np.floor(fy).astype(np.int64), 0, nlat - 1)
    y1 = np.clip(y0 + 1, 0, nlat - 1)
    wy = np.clip(fy - y0, 0.0, 1.0)

    fx = (lon % 360.0) / dlon - 0.5
    x0 = np.floor(fx).astype(np.int64) % nlon
    x1 = (x0 + 1) % nlon
    wx = (fx - np.floor(fx))

    idx = np.stack(
        [y0 * nlon + x0, y0 * nlon + x1, y1 * nlon + x0, y1 * nlon + x1], -1
    )
    w = np.stack(
        [(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx], -1
    )
    return RemapOp(idx.astype(np.int32), w.astype(np.float32))


def _ring_layout(nside: int):
    """Per-ring (start, count, shift, theta) for rings 1..4*nside-1."""
    n = 4 * nside - 1
    rings = np.arange(1, n + 1)
    count = np.where(
        rings < nside, 4 * rings, np.where(rings <= 3 * nside, 4 * nside, 4 * (4 * nside - rings))
    )
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    # Pixel-in-ring phase: phi_j = (j0 + shift) * dphi.  From the ring
    # center equation phi = (j - (kshift+1)/2) * dphi (j 1-based):
    # caps have shift 0.5; equatorial rings alternate (1-kshift)/2.
    kshift = np.where(
        (rings >= nside) & (rings <= 3 * nside), (rings - nside) & 1, 0
    )
    shift = np.where(
        (rings >= nside) & (rings <= 3 * nside), (1 - kshift) * 0.5, 0.5
    )
    npix = hpx.npix(nside)
    # ring colatitudes
    z = np.where(
        rings < nside,
        1.0 - (rings.astype(np.float64) ** 2) * 4.0 / npix,
        np.where(
            rings > 3 * nside,
            ((4 * nside - rings).astype(np.float64) ** 2) * 4.0 / npix - 1.0,
            (2 * nside - rings) * 2.0 / (3.0 * nside),
        ),
    )
    theta = np.arccos(np.clip(z, -1, 1))
    return start, count, shift, theta


@functools.lru_cache(maxsize=None)
def build_hpx2ll(nside: int, nlat: int, nlon: int) -> RemapOp:
    """Ring-bilinear interpolation of a HEALPix map at lat-lon grid points.

    Source layout: the flattened [12, nside, nside] face array of
    `grids.healpix` (nested order under the fhw maps).
    """
    start, count, shift, ring_theta = _ring_layout(nside)
    nrings = len(ring_theta)

    dlat = 180.0 / nlat
    lats = -90 + dlat / 2 + dlat * np.arange(nlat)
    lons = 360.0 / nlon * np.arange(nlon)
    lat2, lon2 = np.meshgrid(lats, lons, indexing="ij")
    theta = np.deg2rad(90.0 - lat2.reshape(-1))
    phi = np.deg2rad(lon2.reshape(-1))
    N = theta.shape[0]

    # bracketing rings (ring_theta ascending north->south)
    i1 = np.searchsorted(ring_theta, theta)  # first ring with theta_r >= theta
    i0 = i1 - 1
    i0c = np.clip(i0, 0, nrings - 1)
    i1c = np.clip(i1, 0, nrings - 1)
    denom = ring_theta[i1c] - ring_theta[i0c]
    wr = np.where(denom > 0, (theta - ring_theta[i0c]) / np.where(denom == 0, 1, denom), 0.0)
    wr = np.clip(wr, 0.0, 1.0)
    # at the poles both brackets clamp to the same ring -> pure lon interp

    def ring_pix(ring_idx, phi):
        cnt = count[ring_idx]
        dphi = 2 * np.pi / cnt
        f = phi / dphi - shift[ring_idx]
        j0 = np.floor(f).astype(np.int64)
        wj = f - j0
        j0m = j0 % cnt
        j1m = (j0 + 1) % cnt
        return start[ring_idx] + j0m, start[ring_idx] + j1m, wj

    a0, a1, wa = ring_pix(i0c, phi)
    b0, b1, wb = ring_pix(i1c, phi)

    ring_idx = np.stack([a0, a1, b0, b1], -1)  # RING-scheme pixel ids
    w = np.stack(
        [(1 - wr) * (1 - wa), (1 - wr) * wa, wr * (1 - wb), wr * wb], -1
    )

    # RING ids -> nested ids -> flattened [F, H, W] positions
    r2n = hpx.ring_to_nest(nside)
    n2fhw = hpx.fhw_to_nest(nside)  # nested -> flat fhw position
    flat_idx = n2fhw[r2n[ring_idx]]
    return RemapOp(flat_idx.astype(np.int32), w.astype(np.float32))


class HEALPixRemap:
    """Dataset-level remapper (reference `HEALPixRemap` class API).

    ll2hpx(data [..., nlat, nlon]) -> [..., 12, nside, nside]
    hpx2ll(data [..., 12, nside, nside]) -> [..., nlat, nlon]

    `data` is a torch tensor (CPU or card; the result stays on its device)
    or a numpy array (the result is one too).
    """

    def __init__(self, latitudes: int, longitudes: int, nside: int, **_):
        self.nlat, self.nlon, self.nside = latitudes, longitudes, nside
        self._fwd = build_ll2hpx(latitudes, longitudes, nside)
        self._bwd = build_hpx2ll(nside, latitudes, longitudes)

    def ll2hpx(self, data):
        flat = data.reshape(*data.shape[:-2], self.nlat * self.nlon)
        return self._fwd.apply(flat, (12, self.nside, self.nside))

    def hpx2ll(self, data):
        flat = data.reshape(*data.shape[:-3], 12 * self.nside * self.nside)
        return self._bwd.apply(flat, (self.nlat, self.nlon))
