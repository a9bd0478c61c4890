"""Trainer: 95th percentile of every window step's interval between CUDA events on the compute stream."""

from portbench.metrics import _shared

UNIT = "ms"


def read(run):
    if run["kind"] != "train":
        return None
    return _shared.p95_ms(run["step_s"])
