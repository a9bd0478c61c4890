"""Geometry tables kept on the device, shared by the grids, the ops and
the models (it sits below all three, so none of them imports another just
to reach it), the models' test for the card's attention routes, and the
measurement entries' device helpers."""

from __future__ import annotations

import functools
from typing import Callable

import torch


def device_constant(table_fn: Callable, *args, device) -> torch.Tensor:
    """`table_fn(*args)`, a numpy table of a model's geometry (index or
    shift-group tables), as a tensor on `device`.  Built and copied once
    per (table, arguments, device) and returned as the same tensor after
    that, so a forward pass copies nothing from the host; the one copy
    goes from pinned memory without blocking, so not even the first
    forward waits for the card.  Callers must not write to it.  Under
    `torch.export` the table is built anew and not cached (it becomes a
    constant of the exported program), so the first eager call after an
    export still gets a real tensor."""
    if torch.compiler.is_exporting():  # fake tensors: neither cached nor pinned
        return torch.from_numpy(table_fn(*args)).to(device)
    return _cached_constant(table_fn, *args, device=device)


@functools.lru_cache(maxsize=None)
def _cached_constant(table_fn: Callable, *args, device) -> torch.Tensor:
    t = torch.from_numpy(table_fn(*args))
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def on_card(x: torch.Tensor) -> bool:
    """Whether the models' automatic attention routes take the card's
    kernels for `x`: on a CUDA tensor, and in any program being exported,
    whatever device it is traced on, so that an artifact traced on the CPU
    launches the kernels where it is served on the card (on CPU tensors
    the registered operators run their plain versions)."""
    return x.is_cuda or torch.compiler.is_exporting()


def entry_device(name: str, entry: str) -> torch.device:
    """A measurement entry's `--device` as a torch device: the card unless
    it is `cpu`.  Where the card is asked for and there is none, the entry
    ends (SystemExit, naming `entry`); no silent fallback to the CPU."""
    from dlwpbench_tpu_torch import resolve_device

    try:
        return resolve_device(name)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"{entry}: {e}") from None


def no_tf32() -> None:
    """fp32 means fp32, as in the train and evaluate entries: no TF32 in
    matmuls or cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sync(device: torch.device) -> None:
    """Wait for the card's work on `device` (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
