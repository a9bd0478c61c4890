"""Host input pipeline: host ms per forecast batch in `WindowedWeatherDataset.batches` building it (`dlwpbench.input.assemble`), first traced stretch."""

from portbench.metrics import _spans

UNIT = "ms"


def read(run):
    if run["kind"] != "rollout":
        return None
    return _spans.per_unit_ms(run, ("dlwpbench.input.assemble",))
