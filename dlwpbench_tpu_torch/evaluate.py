"""Evaluation CLI of the port (counterpart of `scripts/evaluate.py`), in
two modes:

    python -m dlwpbench_tpu_torch.evaluate -c RUN_DIR [RUN_DIR ...] \
        [--batch-size 8] [--sequence-length 17] [--video] [--device cuda]

    python -m dlwpbench_tpu_torch.evaluate model=swintransformer data=synthetic \
        [key=value ...] [--weights W.npz] [--batch-size 8] [--sequence-length 17] \
        [--out-dir D] [--video] [--device cuda]

With `-c`, each run directory that `python -m dlwpbench_tpu_torch.train`
wrote is evaluated: its saved `config.yaml` builds the model and the data,
and the model's weights come from `checkpoints/<name>_best.ckpt`; the
files go to `RUN_DIR/evaluation`; a diffusion run (`training=diffusion`) is
evaluated on the EMA of its parameters.  With overrides, `configs/` is composed
Hydra-style and the model's weights come from `--weights` (an `.npz` of
the flax parameter tree with `/`-joined keys) or a seeded random init from
the config's `seed`; the files go to `--out-dir` (default
`<run_dir>/evaluation`).

Either way the model rolls out in fp32 with no gradients over the test
split on `--device`, the forecasts are de-normalised, a HEALPix run's
faces are remapped to the `data.height` x `data.width` lat-lon grid
(`evaluation.evaluate.to_latlon`), and `inits/outputs/targets.nc`, `rmses.nc`
and `metrics.json` are written on the lat-lon grid; ACC
(`accs.nc`, `rmses_climatology.nc`) is computed when
`outputs/climatology/evaluation/outputs.npz` (written by
`python -m dlwpbench_tpu_torch.build_baselines`) exists under the working
directory and fits the forecast.  Prints the first variable's RMSE per lead
and the rollout's steady-state grid-points/s (batches after the first,
host copies included; the points of the grid the model runs on, HEALPix
pixels on HEALPix).  With `--video`, the first sample's forecast of the
first variable is rendered to `forecast.mp4` beside the files (with its
targets; skipped with a message where ffmpeg is not installed).  After
`-c`, the runs' RMSE curves are overlaid in `outputs/rmse_over_time.png`.
Where matplotlib is not installed (the card's machine) the plot and the
video are skipped with a message that says so, and the results are
returned all the same (the JAX CLI raises ImportError there).
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch

from dlwpbench_tpu_torch import resolve_device, weights as W
from dlwpbench_tpu_torch.data.sources import build_datasets
from dlwpbench_tpu_torch.evaluation import evaluate as E
from dlwpbench_tpu_torch.grids.latlon import LatLonGrid
from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.training.config import load_config, load_saved_config
from dlwpbench_tpu_torch.training.trainer import Trainer, load_checkpoint
from dlwpbench_tpu_torch.utils.device import no_tf32

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs"
)


def _climatology(outputs: np.ndarray):
    """The climatology forecast for ACC when one exists that fits."""
    clim_path = os.path.join("outputs", "climatology", "evaluation", "outputs.npz")
    if not os.path.exists(clim_path):
        return None
    clim_arr = np.load(clim_path)["outputs"]
    if (
        clim_arr.shape[1] >= outputs.shape[1]
        and clim_arr.shape[0] >= outputs.shape[0]
        and clim_arr.shape[2:] == outputs.shape[2:]
    ):
        return clim_arr[: outputs.shape[0], : outputs.shape[1]]
    print(
        f"skipping climatology {clim_arr.shape} (mismatch vs forecasts "
        f"{outputs.shape}); ACC not computed"
    )
    return None


def _matplotlib_missing() -> str | None:
    """Why matplotlib does not import here, or None when it does."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        return str(e)
    return None


def _video(out_dir: str, outputs, targets, var_names) -> None:
    """`forecast.mp4` of the first sample's first variable, or a message
    saying why it was skipped."""
    missing = _matplotlib_missing()
    if missing is not None and shutil.which("ffmpeg") is not None:
        print(f"video: matplotlib unavailable ({missing}), skipped")
        return
    ok = E.generate_mp4(outputs[0, :, 0], os.path.join(out_dir, "forecast.mp4"),
                        targets=targets[0, :, 0], var_name=var_names[0])
    print("video:", "written" if ok else "ffmpeg unavailable, skipped")


def comparison_plot(all_results: dict) -> str | None:
    """The runs' RMSE over lead time in `outputs/rmse_over_time.png`;
    returns its path, or None (with a message) where matplotlib is
    missing."""
    missing = _matplotlib_missing()
    if missing is not None:
        print(f"Comparison plot skipped: matplotlib unavailable ({missing})")
        return None
    var_names = all_results[next(iter(all_results))]["variables"]
    out = os.path.join("outputs", "rmse_over_time.png")
    os.makedirs("outputs", exist_ok=True)
    E.plot_rmse_over_time(all_results, var_names, out)
    print(f"Comparison plot -> {out}")
    return out


def _evaluate_model(cfg, model, batch_size: int, sequence_length: int, out_dir: str,
                    video: bool = False) -> dict:
    """Roll `model` (on its device) over the test split of `cfg`,
    de-normalise, write the forecast files and the metrics under out_dir;
    returns the metrics dict plus `gridpoints_per_s` (None with a single
    batch), `device` and `batch_seconds`."""
    dev = next(model.parameters()).device
    cfg.testing["sequence_length"] = sequence_length
    _, _, test_ds, stats = build_datasets(
        cfg.data, cfg.training, cfg.validation, cfg.get("testing"), int(cfg.model.context_size),
        device=dev,
    )
    test_ds.sequence_length = sequence_length
    if len(test_ds) == 0:
        raise ValueError(
            f"test split has no windows of length {sequence_length}; "
            "reduce --sequence-length or enlarge the test period"
        )

    timings: list = []
    inits, outputs, targets = E.rollout_dataset(model.eval(), test_ds, batch_size, timings)
    print(f"Rollout: {outputs.shape} on {dev}")
    points = outputs.shape[1] * int(np.prod(outputs.shape[3:]))  # a sample's, over its leads

    var_names = E.prognostic_channel_names(cfg.data, outputs.shape[2])
    if stats and bool(cfg.data.get("normalize", True)):
        outputs = E.denormalize(outputs, stats, var_names)
        targets = E.denormalize(targets, stats, var_names)
        inits = E.denormalize(inits, stats, var_names, channel_axis=1)

    outputs, targets, inits = E.to_latlon(cfg.data, outputs, targets, inits)

    grid = LatLonGrid(*outputs.shape[-2:])
    E.write_forecast_files(out_dir, inits, outputs, targets, var_names, grid.lats, grid.lons)
    results = E.compute_metrics(
        outputs, targets, grid.lats, var_names, out_dir,
        climatology=_climatology(outputs),
        timedelta_hours=float(
            cfg.data.get("timedelta_hours", cfg.data.get("timedelta", 6))
        ),
    )
    print("RMSE (first var, per lead time):",
          np.round(results["rmse"][var_names[0]], 4).tolist())
    if video:
        _video(out_dir, outputs, targets, var_names)

    steady = timings[1:]  # the first batch carries the kernel build and warm-up
    rate = (
        sum(n for n, _ in steady) * points / sum(s for _, s in steady)
        if steady else None
    )
    print(f"steady-state grid-points/s: {rate} ({len(steady)} batches after the first, "
          f"device {dev})")
    return {**results, "gridpoints_per_s": rate, "device": str(dev),
            "batch_seconds": timings}


def evaluate(overrides: list[str], weights: str | None = None, batch_size: int = 8,
             sequence_length: int = 17, out_dir: str | None = None,
             device: str = "cuda", video: bool = False) -> dict:
    """Evaluate a model composed from `configs/` and overrides; returns
    what `_evaluate_model` returns."""
    dev = resolve_device(device)
    no_tf32()
    cfg = load_config(CONFIG_DIR, overrides=overrides)
    model = registry.build_model(cfg.model, seed=int(cfg.get("seed", 0)),
                                 grid_shape=registry.data_grid_shape(cfg.data))
    if weights:
        W.load_flax_params(model, W.load_npz(weights))
    return _evaluate_model(cfg, model.to(dev), batch_size, sequence_length,
                           out_dir or os.path.join(cfg.run_dir, "evaluation"), video)


def restore_run(run_dir: str, device: str = "cuda", ema: bool = True):
    """(config, model on `device`, the restored TrainState) of a training
    run's best checkpoint; with `ema`, a diffusion run's model holds the
    EMA of its parameters (what the evaluator rolls out), else the raw
    parameters (what the exporter serves, as JAX's `state.params`)."""
    dev = resolve_device(device)
    cfg = load_saved_config(run_dir)
    model = registry.build_model(cfg.model, seed=int(cfg.get("seed", 0)),
                                 grid_shape=registry.data_grid_shape(cfg.data)).to(dev)
    # the optimizer (and a diffusion run's EMA) are built only so that
    # load_checkpoint can restore into them
    trainer = Trainer(model, training_type=str(cfg.training.get("type", "regular")))
    state = load_checkpoint(run_dir, cfg.model.name, trainer.init(), kind="best")
    if ema and state.ema is not None:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(state.ema[n])
    return cfg, model, state


def evaluate_run(run_dir: str, batch_size: int = 8, sequence_length: int = 17,
                 device: str = "cuda", video: bool = False) -> dict:
    """Evaluate the best checkpoint of a training run (a diffusion run's
    EMA weights) into `run_dir/evaluation`; returns what `_evaluate_model`
    returns."""
    no_tf32()
    cfg, model, state = restore_run(run_dir, device)
    which = "raw" if state.ema is None else "EMA"
    print(f"Restored {cfg.model.name} (epoch {state.epoch}, {which} weights)")
    return _evaluate_model(cfg, model, batch_size, sequence_length,
                           os.path.join(run_dir, "evaluation"), video)


def main(argv=None) -> dict:
    """With `-c`, returns {run name: results} (the run directory's base
    name); else the results of the composed config."""
    ap = argparse.ArgumentParser(prog="python -m dlwpbench_tpu_torch.evaluate",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("overrides", nargs="*",
                    help="config overrides: group=name or a.b.c=value (without -c)")
    ap.add_argument("-c", "--configuration-dir-list", nargs="+", default=None,
                    metavar="RUN_DIR",
                    help="run directories written by python -m dlwpbench_tpu_torch.train: "
                         "evaluate each one's best checkpoint")
    ap.add_argument("--weights", default=None,
                    help=".npz of the flax params tree ('/'-joined keys; without -c)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--sequence-length", type=int, default=17)
    ap.add_argument("--out-dir", default=None, help="without -c (default <run_dir>/evaluation)")
    ap.add_argument("--video", action="store_true",
                    help="render the first sample's forecast to forecast.mp4 (needs ffmpeg)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.configuration_dir_list is None:
        return evaluate(args.overrides, args.weights, args.batch_size,
                        args.sequence_length, args.out_dir, args.device, args.video)
    if args.overrides or args.weights or args.out_dir:
        ap.error("-c takes its config and weights from each run directory: "
                 "no overrides, --weights or --out-dir")
    all_results = {
        os.path.basename(os.path.normpath(run_dir)): evaluate_run(
            run_dir, args.batch_size, args.sequence_length, args.device, args.video)
        for run_dir in args.configuration_dir_list
    }
    comparison_plot(all_results)
    return all_results


if __name__ == "__main__":
    main()
