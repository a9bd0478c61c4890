"""Training losses (the port's counterpart of
`dlwpbench_tpu/training/losses.py:20-54`).

- `mse_loss`: the reference `CustomMSELoss` (`losses.py:155-188`): plain
  MSE, optionally multiplied by per-gridpoint latitude weights before the
  mean.
- `latitude_weights`: cos(lat) / mean(cos(lat)) (WeatherBench eq. 2).

The zonal power spectrum and `melr` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def mse_loss(prediction: torch.Tensor, target: torch.Tensor,
             weights: torch.Tensor | None = None) -> torch.Tensor:
    """MSE, optionally latitude-weighted; `weights` broadcasts against the
    trailing spatial dims (e.g. [H, 1] lat weights)."""
    d = (target - prediction) ** 2
    if weights is not None:
        d = d * weights
    return d.mean()


def latitude_weights(lats_deg: np.ndarray) -> np.ndarray:
    """cos(lat)/mean(cos(lat)) (WeatherBench eq. 2; `evaluate.py:788-792`)."""
    w = np.cos(np.deg2rad(lats_deg))
    return w / w.mean()
