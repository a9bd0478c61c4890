"""Forecast evaluation (counterpart of `dlwpbench_tpu/evaluation/evaluate.py:33-225`).

- no-grad autoregressive rollout over a test split, one batch at a time
  moved to the model's device;
- de-normalisation with the dataset statistics;
- `inits/outputs/targets.nc` and metrics (`metrics.json`, `rmses.nc`, and
  `accs.nc` / `rmses_climatology.nc` when a climatology is given);
- the RMSE-over-lead-time comparison plot, the forecast's frames as PNGs
  and their mp4 (`plot_rmse_over_time`, `render_forecast_frames`,
  `generate_mp4`; matplotlib is imported by each call, ffmpeg is used
  where it is installed).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from dlwpbench_tpu_torch.evaluation import metrics as M
from dlwpbench_tpu_torch.evaluation.plots import pyplot
from dlwpbench_tpu_torch.grids.remap import HEALPixRemap
from dlwpbench_tpu_torch.utils import netcdf3, profiling


def rollout_dataset(model, dataset, batch_size: int = 8,
                    timings: Optional[list] = None):
    """Roll the model over the whole dataset on the model's device; returns
    (inits, outputs, targets) as numpy [sample, T', C, H, W] arrays in
    normalised units.  With `timings`, appends (samples, seconds) per
    batch: host to device, the rollout, and device to host.

    Spans (`utils/profiling.span`): `dlwpbench.rollout.batch` around each
    batch's work after its assembly, holding `.h2d` (the input copies),
    `.forward` (timed on the device too), `.wait` (while a profiler runs,
    the wait for the forward that the copy back would do, made its own
    span) and `.d2h` (the copy back); `dlwpbench.rollout.concat` around
    the final concatenations."""
    device = next(model.parameters()).device
    outs, tars, inits = [], [], []
    with torch.no_grad():
        for const, pres, prog, target in dataset.batches(batch_size):
            with profiling.span("dlwpbench.rollout.batch"):
                t0 = time.perf_counter()
                with profiling.span("dlwpbench.rollout.h2d"):
                    args = [
                        None if a is None else torch.from_numpy(a).to(device)
                        for a in (const, pres, prog)
                    ]
                with profiling.span("dlwpbench.rollout.forward", device=device):
                    out = model(*args)
                with profiling.span("dlwpbench.rollout.wait") as traced:
                    if traced and out.is_cuda:
                        done = torch.cuda.Event()
                        done.record()
                        done.synchronize()
                with profiling.span("dlwpbench.rollout.d2h"):
                    outs.append(out.cpu().numpy())  # .cpu() waits for the device
                del out  # off the card before the next batch's forward
                if timings is not None:
                    timings.append((prog.shape[0], time.perf_counter() - t0))
            tars.append(target)
            inits.append(prog[:, model.context_size - 1])
    with profiling.span("dlwpbench.rollout.concat"):
        return (
            np.concatenate(inits, 0),
            np.concatenate(outs, 0),
            np.concatenate(tars, 0),
        )


def to_latlon(data_cfg: dict, *arrays: np.ndarray) -> tuple:
    """The arrays on the data's `height` x `width` lat-lon grid, before the
    forecast files and the metrics (`scripts/evaluate.py:79-86`,
    `scripts/build_baselines.py:116-127`): when the first is a HEALPix
    forecast [S, T, C, 12, n, n], each is remapped from its trailing
    [12, n, n] faces; else all come back as they are."""
    if arrays[0].ndim != 6:
        return arrays
    rm = HEALPixRemap(int(data_cfg.get("height", 32)), int(data_cfg.get("width", 64)),
                      arrays[0].shape[-1])
    return tuple(rm.hpx2ll(a) for a in arrays)


def prognostic_channel_names(data_cfg: dict, n_channels: int) -> list[str]:
    """Channel names in dataset order: WeatherBench configs expand
    `prognostic_variable_names_and_levels` (e.g. z500, t850); other sources
    fall back to var{i}."""
    spec = data_cfg.get("prognostic_variable_names_and_levels")
    if spec:
        names = []
        for v, levels in spec.items():
            names += [f"{v}{lv}" for lv in levels] if levels else [v]
        if len(names) == n_channels:
            return names
    return [f"var{i}" for i in range(n_channels)]


def denormalize(arr: np.ndarray, stats: dict, var_names: list[str],
                channel_axis: int = 2) -> np.ndarray:
    """Per-channel de-normalisation back to physical units; a single group
    statistic (synthetic data) covers every channel."""
    out = arr.copy()
    group = next(iter(stats.values())) if len(stats) == 1 else None
    idx = [slice(None)] * arr.ndim
    for i, name in enumerate(var_names):
        st = stats.get(name, group)
        if st is not None:
            idx[channel_axis] = i
            out[tuple(idx)] = out[tuple(idx)] * st.std + st.mean
    return out


def compute_metrics(outputs: np.ndarray, targets: np.ndarray, lats_deg: np.ndarray,
                    var_names: list[str], out_dir: str,
                    climatology: Optional[np.ndarray] = None,
                    timedelta_hours: Optional[float] = None) -> dict:
    """Lat-weighted RMSE/ACC per variable and lead time, zonal RMSEs and
    Frobenius norms of [sample, T, C, H, W] arrays; writes `metrics.json`
    and the `.nc` curves under out_dir and returns the metrics dict."""
    os.makedirs(out_dir, exist_ok=True)
    results: dict = {"variables": var_names}
    rmses, accs, fro = {}, {}, {}
    for i, name in enumerate(var_names):
        o = torch.from_numpy(np.ascontiguousarray(outputs[:, :, i]))
        t = torch.from_numpy(np.ascontiguousarray(targets[:, :, i]))
        rmses[name] = M.weighted_rmse(o, t, lats_deg).tolist()
        fro[name] = M.frobenius_norm(o, t).tolist()
        if climatology is not None:
            clim_i = torch.from_numpy(np.ascontiguousarray(climatology[:, :, i]))
            accs[name] = M.acc(o, t, clim_i, lats_deg).tolist()
            results.setdefault("rmse_climatology", {})[name] = M.weighted_rmse(
                clim_i.expand_as(t), t, lats_deg
            ).tolist()
        results.setdefault("zonal_rmse_global", {})[name] = float(
            M.zonal_mean_rmse(o, t, lats_deg)
        )
        results.setdefault("zonal_rmse_trade_winds", {})[name] = float(
            M.zonal_mean_rmse(o, t, lats_deg, [(-20, -10), (10, 20)])
        )
        results.setdefault("zonal_rmse_south_westerlies", {})[name] = float(
            M.zonal_mean_rmse(o, t, lats_deg, [(-55, -45)])
        )
        if timedelta_hours is not None:
            m1112 = M.rmse_months_11_12(o, t, timedelta_hours)
            if m1112 is not None:
                results.setdefault("rmse_months_11_12", {})[name] = float(m1112)
    results["rmse"] = rmses
    results["frobenius"] = fro
    if accs:
        results["acc"] = accs
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(results, f, indent=1)
    _write_curves(out_dir, "rmses", rmses, var_names)
    if accs:
        _write_curves(out_dir, "accs", accs, var_names)
        _write_curves(out_dir, "rmses_climatology", results["rmse_climatology"], var_names)
    return results


def _write_curves(out_dir, name, per_var: dict, var_names):
    """Metric curves over lead time -> `<name>.nc`."""
    data = {v: (("time",), np.asarray(per_var[v])) for v in var_names if v in per_var}
    netcdf3.write_dataset(os.path.join(out_dir, f"{name}.nc"), data)


def write_forecast_files(out_dir, inits, outputs, targets, var_names, lats, lons):
    """inits [S,C,H,W], outputs/targets [S,T,C,H,W] -> netCDF files."""
    os.makedirs(out_dir, exist_ok=True)
    for arr, want in ((inits, 4), (outputs, 5), (targets, 5)):
        if arr.ndim != want:
            raise ValueError(f"expected a {want}-D lat-lon array, got shape {arr.shape}")

    def var_dict(arr, tdim):
        dims = ("sample", "time", "lat", "lon") if tdim else ("sample", "lat", "lon")
        return {
            v: (dims, arr[:, :, i] if tdim else arr[:, i])
            for i, v in enumerate(var_names)
        }

    coords = {"lat": np.asarray(lats), "lon": np.asarray(lons)}
    for fname, arr, tdim in (("inits.nc", inits, False), ("outputs.nc", outputs, True),
                             ("targets.nc", targets, True)):
        netcdf3.write_dataset(os.path.join(out_dir, fname), var_dict(arr, tdim), coords=coords)


def plot_rmse_over_time(metric_files: dict[str, dict], var_names, out_path):
    """Overlay RMSE-over-leadtime curves per model (reference
    `evaluate.py:714-764`)."""
    plt = pyplot()
    n = len(var_names)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 3), squeeze=False)
    for j, v in enumerate(var_names):
        ax = axes[0, j]
        for model_name, res in metric_files.items():
            if v in res.get("rmse", {}):
                ax.plot(res["rmse"][v], label=model_name)
        ax.set_title(v)
        ax.set_xlabel("lead time")
        ax.set_ylabel("RMSE")
    axes[0, 0].legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)


def render_forecast_frames(outputs: np.ndarray, frames_dir: str,
                           targets: Optional[np.ndarray] = None, var_name: str = "") -> int:
    """Write the reference's per-timestep forecast frames as PNGs.

    outputs (and optionally targets): [T, H, W].  With targets, each frame
    is the reference's 3-panel prediction / ground truth / difference
    layout (`evaluate.py:442-478`: shared output/target color range,
    symmetric bwr difference scale); without, a single panel.  Returns the
    number of frames written.  Needs matplotlib, not ffmpeg."""
    plt = pyplot()
    os.makedirs(frames_dir, exist_ok=True)
    T = outputs.shape[0]
    if targets is not None:
        vmin, vmax = float(np.min(targets)), float(np.max(targets))
        diff = outputs - targets
        diffmax = float(np.abs(diff).max()) or 1.0
    else:
        vmin, vmax = (float(v) for v in np.percentile(outputs, [2, 98]))
    for t in range(T):
        if targets is None:
            fig, ax = plt.subplots(figsize=(4, 2.2))
            ax.imshow(outputs[t], vmin=vmin, vmax=vmax, cmap="RdBu_r", origin="lower")
            ax.set_axis_off()
        else:
            fig, axes = plt.subplots(1, 3, figsize=(12, 3), sharex=True, sharey=True)
            ext = [-180, 180, -90, 90]
            axes[0].imshow(outputs[t], origin="lower", vmin=vmin, vmax=vmax, extent=ext)
            axes[0].set_title(r"Prediction ($\hat{y}$)")
            im1 = axes[1].imshow(targets[t], origin="lower", vmin=vmin, vmax=vmax, extent=ext)
            axes[1].set_title(r"Ground truth ($y$)")
            fig.colorbar(im1, ax=axes[1], fraction=0.025)
            im2 = axes[2].imshow(diff[t], origin="lower", vmin=-diffmax, vmax=diffmax,
                                 cmap="bwr", extent=ext)
            axes[2].set_title(r"Difference ($\hat{y}-y$)")
            fig.colorbar(im2, ax=axes[2], fraction=0.025)
            fig.suptitle(f"{var_name}, time step = {t + 1}/{T}")
            fig.tight_layout()
        fig.savefig(os.path.join(frames_dir, f"f{t:04d}.png"), dpi=80)
        plt.close(fig)
    return T


def generate_mp4(fields: np.ndarray, out_path: str, targets: Optional[np.ndarray] = None,
                 fps: int = 4, var_name: str = "") -> bool:
    """Render a [T, H, W] forecast to mp4 (reference `evaluate.py:419-500`:
    matplotlib frames + ffmpeg).  Returns False without writing anything
    when ffmpeg is not installed."""
    if shutil.which("ffmpeg") is None:
        return False
    with tempfile.TemporaryDirectory() as td:
        render_forecast_frames(fields, td, targets=targets, var_name=var_name)
        ret = subprocess.run(
            ["ffmpeg", "-y", "-loglevel", "quiet", "-framerate", str(fps),
             "-i", os.path.join(td, "f%04d.png"), "-pix_fmt", "yuv420p",
             "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2", out_path],
            check=False,
        )
    return ret.returncode == 0
