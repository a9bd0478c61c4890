"""dlwpbench_tpu_torch — the PyTorch/CUDA port of `dlwpbench_tpu`.

A second package beside the JAX one, ported slice by slice.  It keeps the
JAX package's module paths (`models/swin.py`, `evaluation/evaluate.py`,
...) and reads the same `configs/`, but imports nothing of it: what it
needs from the JAX package's numpy-only modules it keeps as its own copy.
Every Pallas kernel on a ported path becomes a hand-written CUDA kernel
for Hopper (`ops/csrc/`), built with nvcc at first use.

Entry points run on CUDA unless the caller asks for the CPU.
"""


def resolve_device(device: str | None = "cuda"):
    """The torch device an entry point runs on: CUDA unless the caller asks
    for the CPU (in a joined job of several ranks, `cuda` is the rank's
    card, `parallel.launch.rank_device`).  Raises when CUDA is asked for
    and absent; never falls back."""
    import torch

    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; "
            "pass --device cpu to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    if dev.type == "cuda":  # in a job of several ranks: this rank's card
        from dlwpbench_tpu_torch.parallel.launch import rank_device

        dev = rank_device(dev)
    return dev
