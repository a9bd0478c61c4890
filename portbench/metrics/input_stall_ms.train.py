"""Host input pipeline: device ms per training step by which the compute stream waited on the batch's copy at the hand-over (`dlwpbench.input.stall`), first traced stretch."""

from portbench.metrics import _spans

UNIT = "ms"


def read(run):
    if run["kind"] != "train":
        return None
    return _spans.per_unit_ms(run, ("dlwpbench.input.stall",), device=True)
