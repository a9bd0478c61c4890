"""Readings that the limits of `correct` are set from, on the card, at the
cell's own sizes (not run by the benchmark's runs):

    python -m portbench.calibrate --workload <cell> --seeds 11,12,... [--control-seeds 3]

For each seed it prints one JSON line with
- `program`: the numbers of a run of the program whose window is one unit
  (its set-up, its first steps and the check exactly as a run makes them);
- on the first `--control-seeds` seeds, `control`: the reference run in
  TF32 (the nearest precision below the configuration's float32) put in
  the program's place, and for training cells `half_batch`: the reference
  trained on the first half of each batch's rows (the mean over the
  rest), both against the float32 reference.
A step that leaves the state unchanged reads 1 on `change` by its
definition and needs no run.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time


def main(argv=None) -> int:
    import torch

    from portbench import cells, check, inputs
    from portbench.kinds import common, rollout, train
    from portbench.run import forbidden_modules, run_cell

    ap = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = cells.load_cell(args.workload)
    tr = cell.traffic
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        res = run_cell(cell, seed, 0.0, False, dev)
        line = {"cell": cell.name, "seed": seed,
                "program": {k: v["value"] for k, v in res["checks"].items()},
                "program_s": time.perf_counter() - t0}
        if i < args.control_seeds:
            ctx = common.Context(config=cell.config, traffic=tr, limits=cell.limits, seed=seed,
                                 seconds=0.0, trace=False, device=dev)
            B, seq = int(tr["batch_size"]), int(tr["sequence_length"])
            ctx_size = int(cell.config["model"]["context_size"])
            if tr["kind"] == "train":
                ds = inputs.windowed(cell.config["data"], seq, B * int(tr["batches_per_epoch"]),
                                     seed, dev, ctx_size)
                kept = list(itertools.islice(ds.batches(B, shuffle=True), int(tr["check_steps"])))
                ref = train.reference_readings(ctx, kept, "float32")
                for name, kw in (("control", {"precision": "tf32"}),
                                 ("half_batch", {"precision": "float32", "rows_fraction": 0.5})):
                    got = train.reference_readings(ctx, kept, **kw)
                    line[name] = check.train_numbers(*got[:1], ref[0], got[1], ref[1], got[2],
                                                     ref[2])
            else:
                split = inputs.windowed(cell.config["data"], seq,
                                        B * int(tr["batches_per_split"]), seed, dev, ctx_size)
                host = list(split.batches(B))[:int(tr["check_batches"])]
                ref = rollout.reference_forecasts(ctx, host, "float32")
                ctl = rollout.reference_forecasts(ctx, host, "tf32")
                line["control"] = {"forecast": max(rollout.forecast_gap(ctx, b, c, r)
                                                   for b, c, r in zip(host, ctl, ref))}
            common.free_cache(dev)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    if forbidden_modules():
        print(f"portbench.calibrate: loaded {forbidden_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
