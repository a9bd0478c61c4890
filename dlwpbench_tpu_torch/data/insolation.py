"""Analytic top-of-atmosphere solar insolation (counterpart of
`dlwpbench_tpu/data/insolation.py`).

The reference's orbital-mechanics approximation
(`data/datasets/add_insolation.py:9-73`) with 1995 constants (obliquity
23.4441 deg, eccentricity 0.016715, perihelion longitude 282.7 deg), used
to synthesize the `tisr` prescribed forcing for arbitrary dates.

- `insolation`: numpy, for dataset preparation, on datetime64 dates; each
  date's year starts at `datetime64[Y]` (the JAX package's copy takes it
  from pandas, which the port does not need);
- `insolation_torch`: on tensors of fractional days of the year, on their
  device (the counterpart of `insolation_jax`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 23.4441 * np.pi / 180.0
_ECC = 0.016715
_OM = 282.7 * np.pi / 180.0


def _solar_geometry(days_arr, lat, lon, xp):
    beta = (1 - _ECC**2) ** 0.5
    lambda_m0 = _ECC * (1.0 + beta) * xp.sin(_OM)
    lambda_m = lambda_m0 + 2.0 * xp.pi * (days_arr - 80.5) / 365.0
    lam = lambda_m + 2.0 * _ECC * xp.sin(lambda_m - _OM)
    dec = xp.arcsin(xp.sin(_EPS) * xp.sin(lam))
    h = 2 * xp.pi * (days_arr + lon / 360.0)
    rho = (1.0 - _ECC**2) / (1.0 + _ECC * xp.cos(lam - _OM))
    sol = (
        xp.sin(xp.pi / 180.0 * lat) * xp.sin(dec)
        - xp.cos(xp.pi / 180.0 * lat) * xp.cos(dec) * xp.cos(h)
    ) * rho**-2.0
    return sol


def insolation(dates, lat, lon, S=1.0, daily=False, enforce_2d=True, clip_zero=True):
    """Approximate solar insolation [date, lat, lon] (numpy; reference API)."""
    lat = np.asarray(lat)
    lon = np.asarray(lon)
    if lat.ndim != lon.ndim:
        raise ValueError("'lat' and 'lon' must have the same number of dimensions")
    if lat.ndim >= 2 and lat.shape != lon.shape:
        raise ValueError(f"shape mismatch between lat {lat.shape} and lon {lon.shape}")
    if lat.ndim == 1 and enforce_2d:
        lon, lat = np.meshgrid(lon, lat)

    dates = np.asarray(dates, dtype="datetime64[ns]")
    start_years = dates.astype("datetime64[Y]").astype("datetime64[ns]")
    days_arr = (dates - start_years) / np.timedelta64(1, "D")
    days_arr = days_arr.reshape(days_arr.shape + (1,) * lat.ndim)

    if daily:
        days_arr = 0.5 + np.round(days_arr)
        lon = np.zeros_like(lon, np.float32)
    sol = S * _solar_geometry(days_arr, lat[None], lon.astype(np.float32), np)
    if clip_zero:
        sol = np.where(sol < 0, 0.0, sol)
    return sol.astype(np.float32)


class _TorchMath:
    """The functions `_solar_geometry` calls, on float32 tensors (Python
    constants as float32 scalars, as jnp takes them)."""

    pi = math.pi

    @staticmethod
    def _t(x):
        return x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=torch.float32)

    @classmethod
    def sin(cls, x):
        return torch.sin(cls._t(x))

    @classmethod
    def cos(cls, x):
        return torch.cos(cls._t(x))

    @classmethod
    def arcsin(cls, x):
        return torch.arcsin(cls._t(x))


def insolation_torch(days_of_year, lat2d, lon2d, S=1.0, clip_zero=True) -> torch.Tensor:
    """Insolation [T, H, W] from fractional days of the year [T] and lat/lon
    [H, W] in degrees, in float32 on the tensors' device."""
    days = torch.as_tensor(days_of_year, dtype=torch.float32)[:, None, None]
    lat = torch.as_tensor(lat2d, dtype=torch.float32, device=days.device)[None]
    lon = torch.as_tensor(lon2d, dtype=torch.float32, device=days.device)[None]
    sol = S * _solar_geometry(days, lat, lon, _TorchMath)
    return torch.where(sol < 0, 0.0, sol) if clip_zero else sol
