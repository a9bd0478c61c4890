"""Algorithmic FLOPs of the graph families' ladder and training entries
(counterpart of `scripts/backfill_graph_flops.py`).

"Algorithmic" is the count of the model whose edge movement is the
gather / edge-list form: the gathers and per-node sums that DGL executes
(the reference's `gnn_layers/utils.py:96-235`), which move features and
multiply nothing.  JAX's TPU program takes the one-hot incidence products
instead, whose products its cost model counts, so its `achieved_tflops`
overstates the algorithmic rate and this script adds the gather form's
count beside it.  The port's default movement already is the gather form
(GraphCast's `movement_impl="auto"` is "gather", MeshGraphNet's "auto" its
edge list on the Delaunay graph), so for the port's own entries the
algorithmic count equals the executed one; it is written all the same, so
that an entry carries the same keys whichever package measured it.

For each MeshGraphNet and GraphCast entry of `--ladder` (and of
`--training`, where that file exists) with a `step_s` and no
`algorithmic_flops_per_step` (or any, with `--force`), the model is
rebuilt at the entry's width with `movement_impl` "edge_list"
(MeshGraphNet) or "gather" (GraphCast), one train step of the ladder's
harness is counted on `--device` (`benchmark_ladder.backfill_flops`: the
products of the forward, the remat recompute and the backward), and the
entry gets `algorithmic_flops_per_step` and `algorithmic_tflops` (over its
measured step time).  Wall-clock figures are untouched.

    python -m dlwpbench_tpu_torch.backfill_graph_flops [--ladder outputs/ladder.json]
        [--training outputs/benchmark_training.json] [--force] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

GRAPH_FAMILIES = ("mgn", "graphcast")
GATHER_FORM = {"mgn": "edge_list", "graphcast": "gather"}
# the benchmark zoo's graph models (`benchmark_models.model_zoo`) are the
# ladder's at these widths
ZOO_WIDTH = {"mgn": 64, "graphcast": 128}


def backfill_ladder(path: str, device, force: bool = False) -> dict:
    """The graph entries of the ladder file `path`, filled in place
    (`benchmark_ladder.backfill_flops` with the gather form)."""
    from dlwpbench_tpu_torch.benchmark_ladder import backfill_flops

    with open(path) as f:
        ladder = json.load(f)
    backfill_flops(ladder, GRAPH_FAMILIES, device, path, movement=GATHER_FORM, force=force)
    return ladder


def backfill_training(path: str, device, force: bool = False) -> dict | None:
    """The graph models of the training matrix `path` (the zoo's widths),
    filled in place; None where there is no such file."""
    from dlwpbench_tpu_torch.benchmark_ladder import (build, prepare_step, step_flops,
                                                      synthetic_arrays)

    if not os.path.exists(path):
        print(f"{path}: not there, no training entries to fill")
        return None
    with open(path) as f:
        tr = json.load(f)
    B, T = tr["batch"], tr["seq"]
    H, W = 32, 64
    arrays = tuple(np.zeros(a.shape, np.float32) for a in synthetic_arrays(B, T, (H, W)))
    for name in GRAPH_FAMILIES:
        e = tr["results"].get(name)
        if not e or "error" in e or not e.get("train_step_s"):
            continue
        if e.get("algorithmic_flops_per_step") and not force:
            continue
        try:
            model = build(name, ZOO_WIDTH[name], H, W, 4, 1, 8,
                          movement_impl=GATHER_FORM[name])
            f = step_flops(prepare_step(model, arrays, device))[0]
        except Exception as exc:
            print(f"{name}: FAILED {type(exc).__name__}: {exc}", flush=True)
            continue
        if f:
            over = e["flops_per_step"] / f if e.get("flops_per_step") else 0
            e["algorithmic_flops_per_step"] = f
            e["algorithmic_tflops"] = round(f / e["train_step_s"] / 1e12, 3)
            print(f"benchmark_training/{name}: algorithmic {f / 1e9:.1f} GFLOP/step "
                  f"({over:.2f}x counted by the executed program) -> "
                  f"{e['algorithmic_tflops']:.3f} TFLOP/s", flush=True)
            with open(path, "w") as fh:
                json.dump(tr, fh, indent=1)
    return tr


def main(argv=None) -> dict:
    from dlwpbench_tpu_torch.utils.device import entry_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--ladder", default="outputs/ladder.json")
    ap.add_argument("--training", default="outputs/benchmark_training.json")
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    args = ap.parse_args(argv)

    device = entry_device(args.device, "backfill_graph_flops")
    out = {"ladder": backfill_ladder(args.ladder, device, args.force),
           "training": backfill_training(args.training, device, args.force)}
    print("done")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
