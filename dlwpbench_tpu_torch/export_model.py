"""Export a trained run to a serving artifact (counterpart of
`scripts/export_model.py`):

    python -m dlwpbench_tpu_torch.export_model -c RUN_DIR -o model.pt2 \
        [--batch-size 1] [--sequence-length 17] [--device cuda]

The artifact holds the full rollout forward traced by `torch.export` on
`--device` (the card by default; `--device cpu` traces on the CPU) with the
best checkpoint's weights; serve it with `python -m
dlwpbench_tpu_torch.serve` or `utils.export.load_exported`, which need the
port's attention operators but no model code.  A program traced on either
device serves on either: its attention calls launch the hand-written
kernels on the card and run their plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> str:
    """Returns the artifact's path."""
    ap = argparse.ArgumentParser(prog="python -m dlwpbench_tpu_torch.export_model",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", "--run-dir", required=True)
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--sequence-length", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="the device the program is traced on: cuda (default) or cpu")
    a = ap.parse_args(argv)

    from dlwpbench_tpu_torch.utils.export import export_from_run_dir

    t0 = time.perf_counter()
    path = export_from_run_dir(a.run_dir, a.out, batch_size=a.batch_size,
                               sequence_length=a.sequence_length, device=a.device)
    print(f"exported {a.run_dir} -> {path} ({os.path.getsize(path)} bytes, traced on "
          f"{a.device} in {time.perf_counter() - t0:.2f} s)")
    return path


if __name__ == "__main__":
    main()
