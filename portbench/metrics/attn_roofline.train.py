"""Attention kernels: least time of the traced stretch's attention work over the device time of the kernels the dlwpbench_torch:: attention operators launched, in %."""

from portbench.metrics import _shared

UNIT = "%"


def read(run):
    if run["kind"] != "train":
        return None
    return _shared.attention_roofline(run)
