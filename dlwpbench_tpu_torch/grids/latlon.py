"""Equirectangular (lat-lon) grid geometry (the port's copy of
`dlwpbench_tpu/grids/latlon.py`).

Capability parity with the reference's implicit lat-lon conventions:
- WeatherBench 5.625 degree grid: 32 x 64 cell-centered points
  (reference `configs/data/weatherbench.yaml` height/width).
- Latitude weights cos(lat)/mean(cos(lat)) per WeatherBench eq. (2)
  (reference `scripts/evaluate.py:788-792`).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LatLonGrid:
    """A global cell-centered equirectangular grid.

    Latitudes run south -> north (WeatherBench convention: -87.1875 .. 87.1875
    for the 5.625 degree grid); longitudes run 0 .. 360 (exclusive).
    """

    nlat: int
    nlon: int

    @property
    def lats(self) -> np.ndarray:
        dlat = 180.0 / self.nlat
        return np.linspace(-90 + dlat / 2, 90 - dlat / 2, self.nlat)

    @property
    def lons(self) -> np.ndarray:
        return np.linspace(0, 360, self.nlon, endpoint=False)


def weatherbench_grid(resolution_deg: float = 5.625) -> LatLonGrid:
    """Standard WeatherBench grids: 5.625 deg -> 32x64, 2.8125 -> 64x128, ..."""
    nlat = int(round(180.0 / resolution_deg))
    nlon = int(round(360.0 / resolution_deg))
    return LatLonGrid(nlat, nlon)
