"""Array preprocessing for the data sources (numpy, host side).

The port's copy of `coarsen_mean` from `dlwpbench_tpu/data/preprocessing.py:188`,
the one function a source calls (`downscale_factor`).  The rest of that
module (`Preprocessor`, spectra, `regrid_linear`, `resample_mean`) is not
ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import numpy as np


def coarsen_mean(data: np.ndarray, factor: int) -> np.ndarray:
    """Block-mean downscaling (reference `datasets.py:303-305` coarsen)."""
    *lead, H, W = data.shape
    x = data.reshape(*lead, H // factor, factor, W // factor, factor)
    return x.mean(axis=(-3, -1))
