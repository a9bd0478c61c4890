"""Geometry tables kept on the device, shared by the grids, the ops and
the models (it sits below all three, so none of them imports another just
to reach it)."""

from __future__ import annotations

import functools
from typing import Callable

import torch


@functools.lru_cache(maxsize=None)
def device_constant(table_fn: Callable, *args, device) -> torch.Tensor:
    """`table_fn(*args)`, a numpy table of a model's geometry (index or
    shift-group tables), as a tensor on `device`.  Built and copied once
    per (table, arguments, device) and returned as the same tensor after
    that, so a forward pass copies nothing from the host; the one copy
    goes from pinned memory without blocking, so not even the first
    forward waits for the card.  Callers must not write to it."""
    t = torch.from_numpy(table_fn(*args))
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t
