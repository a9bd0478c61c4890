"""Persistence and climatology baselines of a trained run (the port's
counterpart of `scripts/build_baselines.py`):

    python -m dlwpbench_tpu_torch.build_baselines -c RUN_DIR [--sequence-length 17]

Loads the run's saved config, builds its datasets, and forecasts the test
split's inits with persistence (each init held over the range) and with
the climatology: the train split's monthly mean at each forecast's valid
time where the splits carry `times` (the zarr source), else the train
split's overall mean.  Both are de-normalised, remapped from the HEALPix
faces to the `data.height` x `data.width` lat-lon grid on a HEALPix run
(as `evaluate` remaps a model's forecast), and scored like a model's
forecast; writes `outputs/{persistence,climatology}/evaluation/`
(`metrics.json`, `rmses.nc`) under the working directory, and the
climatology forecast as `outputs/climatology/evaluation/outputs.npz`,
which `python -m dlwpbench_tpu_torch.evaluate` reads for ACC.  Everything
runs on the host; nothing runs on a device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from dlwpbench_tpu_torch.data.sources import build_datasets
from dlwpbench_tpu_torch.evaluation import evaluate as E
from dlwpbench_tpu_torch.evaluation.baselines import (
    climatology_forecast,
    monthly_climatology,
    persistence_forecast,
)
from dlwpbench_tpu_torch.grids.latlon import LatLonGrid
from dlwpbench_tpu_torch.training.config import load_saved_config

CLIMATOLOGY_NPZ = os.path.join("outputs", "climatology", "evaluation", "outputs.npz")


def _months(times: np.ndarray) -> np.ndarray:
    return times.astype("datetime64[M]").astype(int) % 12 + 1


def build_baselines(run_dir: str, sequence_length: int = 17) -> dict:
    """Returns {"persistence": metrics, "climatology": metrics}."""
    cfg = load_saved_config(run_dir)
    ctx = int(cfg.model.context_size)
    cfg.testing["sequence_length"] = sequence_length
    train_ds, _, test_ds, stats = build_datasets(
        cfg.data, cfg.training, cfg.validation, cfg.get("testing"), ctx
    )
    test_ds.sequence_length = sequence_length
    if len(test_ds) == 0:
        raise ValueError("test split has no windows; reduce --sequence-length")

    inits, targets = [], []
    for _, _, prog, tar in test_ds.batches(8):
        inits.append(prog[:, ctx - 1])
        targets.append(tar)
    inits = np.concatenate(inits)
    targets = np.concatenate(targets)
    n_steps = targets.shape[1]

    var_names = E.prognostic_channel_names(cfg.data, targets.shape[2])
    # baselines and metrics in physical units, like model evaluations
    denorm = bool(stats) and bool(cfg.data.get("normalize", True))
    if denorm:
        inits = E.denormalize(inits, stats, var_names, channel_axis=1)
        targets = E.denormalize(targets, stats, var_names)

    pers = persistence_forecast(inits, n_steps)
    if train_ds.times is not None and test_ds.times is not None:
        fields = train_ds.prognostic
        if denorm:
            fields = E.denormalize(fields, stats, var_names, channel_axis=1)
        clim_table = monthly_climatology(fields, _months(train_ds.times))
        te_months = _months(test_ds.times)
        valid = np.stack([te_months[test_ds.target_frame_indices(i)]
                          for i in range(len(test_ds))])
        clim = climatology_forecast(clim_table, valid)
    else:  # no calendar: the climatology of a stationary series
        clim_state = np.zeros_like(inits[0])
        count = 0
        for _, _, prog, _ in train_ds.batches(8):
            clim_state = clim_state + prog.mean(axis=(0, 1)) * prog.shape[0]
            count += prog.shape[0]
        clim_state /= max(count, 1)
        if denorm:
            clim_state = E.denormalize(clim_state[None], stats, var_names, channel_axis=1)[0]
        clim = np.broadcast_to(
            clim_state[None, None], (inits.shape[0], n_steps, *clim_state.shape)
        ).copy()

    targets, pers, clim = E.to_latlon(cfg.data, targets, pers, clim)

    lats = LatLonGrid(*targets.shape[-2:]).lats
    results = {}
    for name, fc in (("persistence", pers), ("climatology", clim)):
        out_dir = os.path.join("outputs", name, "evaluation")
        results[name] = E.compute_metrics(fc, targets, lats, var_names, out_dir)
        print(f"{name}: RMSE(first var) per lead time =",
              np.round(results[name]["rmse"][var_names[0]], 4).tolist())
    np.savez(CLIMATOLOGY_NPZ, outputs=clim)
    print("-> outputs/{persistence,climatology}/evaluation/")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m dlwpbench_tpu_torch.build_baselines",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", "--configuration-dir", required=True,
                    help="a run directory written by python -m dlwpbench_tpu_torch.train")
    ap.add_argument("--sequence-length", type=int, default=17)
    args = ap.parse_args(argv)
    return build_baselines(args.configuration_dir, args.sequence_length)


if __name__ == "__main__":
    main()
