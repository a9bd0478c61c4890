"""Standalone monthly-climatology builder (counterpart of
`scripts/climatology.py`, a thin alias of the baselines builder):

    python -m dlwpbench_tpu_torch.climatology -c RUN_DIR [--sequence-length 17]

Runs `python -m dlwpbench_tpu_torch.build_baselines` with the same
arguments; its climatology forecast (`outputs/climatology/evaluation/`)
is what the evaluator's ACC reads.
"""

from __future__ import annotations

import sys

from dlwpbench_tpu_torch.build_baselines import main

if __name__ == "__main__":
    main(sys.argv[1:])
