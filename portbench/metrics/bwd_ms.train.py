"""Trainer: device ms per training step of the backward passes, remat's recompute included (`dlwpbench.train.backward`), first traced stretch."""

from portbench.metrics import _spans

UNIT = "ms"


def read(run):
    if run["kind"] != "train":
        return None
    return _spans.per_unit_ms(run, ("dlwpbench.train.backward",), device=True)
