"""Host input pipeline: host ms per training step in `prefetch_to_device` pinning each batch and issuing its copy (`dlwpbench.input.pin`), first traced stretch."""

from portbench.metrics import _spans

UNIT = "ms"


def read(run):
    if run["kind"] != "train":
        return None
    return _spans.per_unit_ms(run, ("dlwpbench.input.pin",))
