"""Trainer: device ms per training step of the micro-batches' losses (`dlwpbench.train.forward`), first traced stretch."""

from portbench.metrics import _spans

UNIT = "ms"


def read(run):
    if run["kind"] != "train":
        return None
    return _spans.per_unit_ms(run, ("dlwpbench.train.forward",), device=True)
