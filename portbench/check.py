"""The numbers that decide `correct`, each against its limit.

Training (the program's first `check_steps` steps against the
reference's from the same weights and batches):
- `loss`: the largest relative gap of a step's loss;
- `grad`: of the first step's gradient as the optimizer takes it (the
  program's worked out from AdamW's first moment after one step), the
  worst leaf's gap between the two sides' norms, against the larger of
  that leaf's reference norm and the median leaf's;
- `change`: the same of each leaf's change over the steps, leaving out
  the leaves whose reference gradient is under a thousandth of the median
  leaf's (moved by round-off alone).

Rollout (a sample of the forecast batches the window completed, drawn
from the seed, against the reference's rollout from the same inputs):
- `forecast`: the largest over the sampled batches and lead steps of
  |program - reference| / |reference - initial frame|, L2 norms over the
  batch's fields at that lead step.
"""

from __future__ import annotations

import numpy as np
import torch

SMALL_GRAD = 1e-3


def leaf_norms(tensors: dict) -> dict[str, float]:
    """{name: L2 norm} in one read from the device."""
    names = sorted(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].double()) for n in names]).cpu()
    return dict(zip(names, vals.tolist()))


def norm_gap(program: dict, reference: dict, keep=None) -> float:
    """max over kept leaves of |p - r| / max(r, median r)."""
    med = float(np.median(list(reference.values())))
    names = [n for n in reference if keep is None or n in keep]
    return max(abs(program[n] - reference[n]) / max(reference[n], med, 1e-30) for n in names)


def train_numbers(p_losses, r_losses, p_grad, r_grad, p_change, r_change) -> dict[str, float]:
    med = float(np.median(list(r_grad.values())))
    moved = {n for n, v in r_grad.items() if v >= SMALL_GRAD * med}
    return {
        "loss": max(abs(p - r) / abs(r) for p, r in zip(p_losses, r_losses)),
        "grad": norm_gap(p_grad, r_grad),
        "change": norm_gap(p_change, r_change, keep=moved),
    }


def forecast_gap(program: np.ndarray, reference: np.ndarray, initial: np.ndarray) -> float:
    """program, reference [B, T, C, H, W]; initial [B, C, H, W]."""
    p = torch.as_tensor(program, dtype=torch.float64)
    r = torch.as_tensor(reference, dtype=torch.float64)
    x0 = torch.as_tensor(initial, dtype=torch.float64)[:, None]
    num = torch.linalg.vector_norm(p - r, dim=(0, 2, 3, 4))
    den = torch.linalg.vector_norm(r - x0, dim=(0, 2, 3, 4))
    return float((num / den).max())


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits and finite, {name: {"value", "limit"}})."""
    table = {n: {"value": float(v), "limit": float(limits[n])} for n, v in numbers.items()}
    ok = all(np.isfinite(t["value"]) and t["value"] <= t["limit"] for t in table.values())
    return ok, table
