"""Trainer: device ms per training step of gradient clipping and the AdamW step (`dlwpbench.train.clip`, `dlwpbench.train.optimizer`), first traced stretch."""

from portbench.metrics import _spans

UNIT = "ms"


def read(run):
    if run["kind"] != "train":
        return None
    return _spans.per_unit_ms(run, ("dlwpbench.train.clip", "dlwpbench.train.optimizer"),
                              device=True)
