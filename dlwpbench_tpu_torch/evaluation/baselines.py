"""Forecast baselines (the port's copy of `dlwpbench_tpu/evaluation/baselines.py`;
reference `scripts/build_baselines.py:23-74` and `scripts/climatology.py`)."""

from __future__ import annotations

import numpy as np


def persistence_forecast(inits: np.ndarray, n_steps: int) -> np.ndarray:
    """Broadcast each initial condition over the forecast range.

    inits: [sample, C, ...] -> [sample, n_steps, C, ...]
    (reference `build_baselines.py:23-32`).
    """
    return np.broadcast_to(
        inits[:, None], (inits.shape[0], n_steps, *inits.shape[1:])
    ).copy()


def monthly_climatology(fields: np.ndarray, months: np.ndarray) -> np.ndarray:
    """Per-month mean over the reference period.

    fields: [T, C, ...]; months: [T] in 1..12 -> [12, C, ...]
    (reference `build_baselines.py:35-74`).  Months absent from the period
    take the overall mean (short splits) instead of NaN rows.
    """
    overall = fields.mean(axis=0)
    return np.stack(
        [
            fields[months == m].mean(axis=0) if (months == m).any() else overall
            for m in range(1, 13)
        ],
        axis=0,
    )


def climatology_forecast(clim: np.ndarray, valid_months: np.ndarray) -> np.ndarray:
    """Look up the monthly climatology at each forecast valid time.

    clim: [12, C, ...]; valid_months: [sample, n_steps] in 1..12
    -> [sample, n_steps, C, ...]
    """
    return clim[valid_months - 1]
