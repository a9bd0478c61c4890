"""Training losses and metrics (the port's counterpart of
`dlwpbench_tpu/training/losses.py:17-97`).

- `mse_loss`: the reference `CustomMSELoss` (`losses.py:155-188`): plain
  MSE, optionally multiplied by per-gridpoint latitude weights before the
  mean.
- `cell_area_weighted_loss`: the GraphCast-lineage MSE, weighted by cell
  area after the (time, channel) mean.
- `latitude_weights`: cos(lat) / mean(cos(lat)) (WeatherBench eq. 2).
- `zonal_power_spectrum`: zonal power per latitude ring, scaled by the
  ring's circumference, on `torch.fft.rfft(..., norm="forward")`.
- `melr`: the mean energy log ratio log(E_pred / E_true) of two zonal
  spectra.
"""

from __future__ import annotations

import numpy as np
import torch

EARTH_RADIUS_M = 1000 * (6357 + 6378) / 2


def mse_loss(prediction: torch.Tensor, target: torch.Tensor,
             weights: torch.Tensor | None = None) -> torch.Tensor:
    """MSE, optionally latitude-weighted; `weights` broadcasts against the
    trailing spatial dims (e.g. [H, 1] lat weights)."""
    d = (target - prediction) ** 2
    if weights is not None:
        d = d * weights
    return d.mean()


def cell_area_weighted_loss(prediction: torch.Tensor, target: torch.Tensor,
                            area: torch.Tensor) -> torch.Tensor:
    """Cell-area-weighted MSE (JAX `losses.py:36-48`; reference
    `models/graphcast/utils/loss.py:26-56`): the squared error is averaged
    over the leading (time, channel) axes first, then weighted by the
    per-cell `area` [H, W] and averaged spatially, which differs from
    `mse_loss` when `area` is not normalised to mean 1."""
    loss = torch.mean((prediction - target) ** 2, dim=(0, 1))
    return torch.mean(loss * area)


def latitude_weights(lats_deg: np.ndarray) -> np.ndarray:
    """cos(lat)/mean(cos(lat)) (WeatherBench eq. 2; `evaluate.py:788-792`)."""
    w = np.cos(np.deg2rad(lats_deg))
    return w / w.mean()


def zonal_power_spectrum(field: torch.Tensor, lats_deg: np.ndarray) -> torch.Tensor:
    """[..., lat, lon] -> [..., lat, lon // 2 + 1] zonal power, every
    wavenumber but the zeroth doubled and each ring scaled by its
    circumference, so that the sum over wavenumbers is the discrete
    integral around the latitude line."""
    f_k = torch.fft.rfft(field, dim=-1, norm="forward")
    power = (f_k * f_k.conj()).real
    doubling = torch.full((power.shape[-1],), 2.0, dtype=power.dtype, device=power.device)
    doubling[0] = 1.0
    circumference = torch.as_tensor(
        np.cos(np.deg2rad(lats_deg)) * 2 * np.pi * EARTH_RADIUS_M, dtype=power.dtype,
        device=power.device,
    )
    return power * doubling * circumference[..., :, None]


def melr(prediction: torch.Tensor, target: torch.Tensor, lats_deg: np.ndarray,
         eps: float = 1e-10) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean energy log ratio, per-wavenumber log ratio [lon // 2 + 1])
    between the zonal spectra of [sample, lat, lon] fields of one
    variable, each averaged over samples and latitudes."""
    e_pred = zonal_power_spectrum(prediction, lats_deg).mean(dim=(0, 1))
    e_true = zonal_power_spectrum(target, lats_deg).mean(dim=(0, 1))
    ratio = torch.log((e_pred + eps) / (e_true + eps))
    return ratio.mean(), ratio
