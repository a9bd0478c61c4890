"""Serve an exported forecast artifact over a dataset, with no model code
(counterpart of `scripts/serve.py`):

    python -m dlwpbench_tpu_torch.serve -a model.pt2 -c RUN_DIR \
        [--out-dir RUN_DIR/serving] [--batch-size B] [--device cuda]

The compute comes from the artifact (`python -m
dlwpbench_tpu_torch.export_model`), whose attention calls launch the
hand-written kernels on the card; the run directory supplies the data
config, so the windows, the normalisation statistics and the biweekly
inits match training.  Writes the evaluator's forecast files and metrics
(a HEALPix run remapped to lat-lon as the evaluator does) and
`serving.json` under `--out-dir`, and prints the steady-state serving
rate: the median seconds of a batch after the first, each timed from the
host arrays to the host forecast after a `torch.cuda.synchronize()`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve_dataset(run, meta, test_ds, batch_size, device="cuda"):
    """Roll the artifact over the dataset; returns (inits, outputs, targets)
    as numpy arrays plus the steady-state seconds per batch.  The artifact
    is shape-locked: batches of another size (the ragged tail) are
    skipped."""
    shapes = meta["shapes"]
    B = int(shapes["prog"][0])
    if batch_size and batch_size != B:
        raise ValueError(f"artifact is shape-locked to batch {B}; re-export with "
                         f"--batch-size {batch_size}")
    outs, tars, inits, times = [], [], [], []
    ctx = int(meta.get("context_size", 1))
    for const, pres, prog, target in test_ds.batches(B):
        if prog.shape[0] != B:
            continue
        _sync(device)
        t0 = time.perf_counter()
        out = run(None if shapes["const"] is None else const,
                  None if shapes["pres"] is None else pres, prog)
        out = out.cpu().numpy()  # waits for the device
        times.append(time.perf_counter() - t0)
        outs.append(out)
        tars.append(target)
        inits.append(prog[:, ctx - 1])
    if not outs:
        raise ValueError(f"no full batches of {B} windows in the test split; re-export "
                         "with a smaller --batch-size")
    steady = float(np.median(times[1:])) if len(times) > 1 else times[0]
    return (np.concatenate(inits, 0), np.concatenate(outs, 0), np.concatenate(tars, 0),
            steady)


def main(argv=None) -> dict:
    """Returns the metrics dict plus `steady_s_per_batch`,
    `gridpoints_per_s` and `out_dir`."""
    ap = argparse.ArgumentParser(prog="python -m dlwpbench_tpu_torch.serve",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("-a", "--artifact", required=True)
    ap.add_argument("-c", "--run-dir", required=True,
                    help="run dir supplying the data config + stats")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--batch-size", type=int, default=None,
                    help="must match the exported batch (checked)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from dlwpbench_tpu_torch import resolve_device
    from dlwpbench_tpu_torch.data.sources import build_datasets
    from dlwpbench_tpu_torch.evaluation import evaluate as E
    from dlwpbench_tpu_torch.grids.latlon import LatLonGrid
    from dlwpbench_tpu_torch.training.config import load_saved_config
    from dlwpbench_tpu_torch.utils.device import no_tf32
    from dlwpbench_tpu_torch.utils.export import load_exported

    dev = resolve_device(args.device)
    no_tf32()
    run, meta = load_exported(args.artifact, device=str(dev))
    cfg = load_saved_config(args.run_dir)
    seq = int(meta["shapes"]["prog"][1])
    cfg.testing["sequence_length"] = seq
    _, _, test_ds, stats = build_datasets(cfg.data, cfg.training, cfg.validation,
                                          cfg.get("testing"), int(meta.get("context_size", 1)),
                                          device=dev)
    test_ds.sequence_length = seq

    inits, outputs, targets, steady = serve_dataset(run, meta, test_ds, args.batch_size, dev)
    # a batch's points over a batch's seconds (JAX's script multiplies by
    # every served sample instead, which overstates the rate by the number
    # of batches)
    B, T = int(meta["shapes"]["prog"][0]), outputs.shape[1]
    npts = int(np.prod(outputs.shape[-2:])) * (12 if outputs.ndim == 6 else 1)
    gps = B * T * npts / steady
    print(f"Serve: {outputs.shape}  steady {steady * 1e3:.1f} ms/batch "
          f"({gps:,.0f} output gridpoints/s)")

    var_names = E.prognostic_channel_names(cfg.data, outputs.shape[2])
    if stats and bool(cfg.data.get("normalize", True)):
        outputs = E.denormalize(outputs, stats, var_names)
        targets = E.denormalize(targets, stats, var_names)
        inits = E.denormalize(inits, stats, var_names, channel_axis=1)
    outputs, targets, inits = E.to_latlon(cfg.data, outputs, targets, inits)

    grid = LatLonGrid(*outputs.shape[-2:])
    out_dir = args.out_dir or os.path.join(args.run_dir, "serving")
    E.write_forecast_files(out_dir, inits, outputs, targets, var_names, grid.lats, grid.lons)
    results = E.compute_metrics(
        outputs, targets, grid.lats, var_names, out_dir,
        timedelta_hours=float(cfg.data.get("timedelta_hours", cfg.data.get("timedelta", 6))),
    )
    with open(os.path.join(out_dir, "serving.json"), "w") as f:
        json.dump({"steady_s_per_batch": steady, "gridpoints_per_s": gps,
                   "artifact": os.path.abspath(args.artifact), "device": str(dev)}, f, indent=1)
    print("RMSE (first var, per lead time):",
          np.round(results["rmse"][var_names[0]], 4).tolist())
    print(f"-> {out_dir}")
    return {**results, "steady_s_per_batch": steady, "gridpoints_per_s": gps,
            "out_dir": out_dir}


if __name__ == "__main__":
    main()
