"""Host input pipeline: host ms per training step in `WindowedWeatherDataset.batches` building batches (`dlwpbench.input.assemble`), first traced stretch."""

from portbench.metrics import _spans

UNIT = "ms"


def read(run):
    if run["kind"] != "train":
        return None
    return _spans.per_unit_ms(run, ("dlwpbench.input.assemble",))
