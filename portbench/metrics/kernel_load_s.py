"""Kernels: seconds this process spent building (nvcc, where a library was missing) and loading the program's kernel libraries (the `build.nvcc` and `build.load` counters); None where it loaded none."""

from portbench.metrics import _spans

UNIT = "s"


def read(run):
    return _spans.kernel_load_s()
