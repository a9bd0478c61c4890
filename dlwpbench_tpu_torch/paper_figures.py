"""The paper's figure families from evaluation artifacts (counterpart of
`scripts/paper_figures.py`).

    python -m dlwpbench_tpu_torch.paper_figures -c outputs/<run> [outputs/<other> ...]
        [--out-dir outputs/figures] [--var 0] [--timedelta-hours 6]

The reference's `scripts/plot_results.py` renders its figure families
from hard-coded arrays; this entry draws them from what `python -m
dlwpbench_tpu_torch.evaluate -c RUN_DIR` wrote under each run's
`evaluation/` (`metrics.json` and the `inits/outputs/targets.nc` forecast
files, or a `forecast.npz`):

  - RMSE (and ACC where baselines exist) over lead time, all runs overlaid
    (`rmse_over_time.png`);
  - the zonal-band RMSE bars: global, trade winds, southern westerlies
    (`physical_soundness.png`);
  - per run with forecast arrays: the long rollout's mean and spread
    against the verification, the end-condition fields, the Hovmoller
    diagram, the zonal FFT amplitude and the wavenumber distribution, the
    kinetic-energy-style spectrum, the RMSE map
    (`<figure>_<run>.png`);
  - the runtime and memory over parameters come from `ladder_tables`.

Everything runs on the host (numpy and the CPU's `torch.fft` for the
zonal spectrum); matplotlib is imported inside the plot functions.  The
card's machine has no matplotlib, so this entry runs where the figures
are wanted, on a CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def load_eval(run_dir: str):
    """(metrics, {"inits", "outputs", "targets"} arrays or None) of a run
    directory's `evaluation/`."""
    from dlwpbench_tpu_torch.utils.netcdf3 import read_dataset

    ed = os.path.join(run_dir, "evaluation")
    with open(os.path.join(ed, "metrics.json")) as f:
        metrics = json.load(f)
    fnpz = os.path.join(ed, "forecast.npz")
    if os.path.exists(fnpz):
        with np.load(fnpz) as z:
            return metrics, {k: z[k] for k in ("inits", "outputs", "targets")}
    try:  # the netCDF files (xarray- and scipy-written alike)
        arrays = {}
        for k in ("inits", "outputs", "targets"):
            data, _ = read_dataset(os.path.join(ed, f"{k}.nc"))
            arrays[k] = np.stack([data[v] for v in metrics["variables"]], axis=-3)
        return metrics, arrays
    except (OSError, KeyError, ValueError):
        return metrics, None


def zonal_power(field: np.ndarray, lats: np.ndarray) -> np.ndarray:
    """`losses.zonal_power_spectrum` of a numpy field, on the CPU."""
    import torch

    from dlwpbench_tpu_torch.training.losses import zonal_power_spectrum

    return zonal_power_spectrum(torch.from_numpy(np.asarray(field, np.float32)), lats).numpy()


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", "--configuration-dir-list", nargs="+", required=True)
    ap.add_argument("--out-dir", default="outputs/figures")
    ap.add_argument("--var", type=int, default=0,
                    help="channel index for the single-variable figures")
    ap.add_argument("--timedelta-hours", type=float, default=6.0)
    args = ap.parse_args(argv)

    from dlwpbench_tpu_torch.evaluation import plots as P
    from dlwpbench_tpu_torch.evaluation.evaluate import plot_rmse_over_time
    from dlwpbench_tpu_torch.grids.latlon import LatLonGrid

    os.makedirs(args.out_dir, exist_ok=True)
    runs = {os.path.basename(os.path.normpath(rd)): load_eval(rd)
            for rd in args.configuration_dir_list}
    metrics_by_run = {n: m for n, (m, _) in runs.items()}
    var_names = next(iter(metrics_by_run.values()))["variables"]
    v = args.var
    vn = var_names[v]
    made = []

    # 1) RMSE (/ACC) over lead time, all runs overlaid
    p = os.path.join(args.out_dir, "rmse_over_time.png")
    plot_rmse_over_time(metrics_by_run, var_names, p)
    made.append(p)

    # 2) the zonal-band bars
    plt = P.pyplot()
    bands = ["zonal_rmse_global", "zonal_rmse_trade_winds", "zonal_rmse_south_westerlies"]
    fig, ax = plt.subplots(figsize=(1.2 + 1.6 * len(runs), 3))
    width = 0.8 / len(bands)
    xs = np.arange(len(runs))
    for i, b in enumerate(bands):
        vals = [m.get(b, {}).get(vn, np.nan) for m in metrics_by_run.values()]
        ax.bar(xs + i * width, vals, width, label=b.replace("zonal_rmse_", ""))
    ax.set_xticks(xs + width)
    ax.set_xticklabels(list(runs), rotation=20, fontsize=7)
    ax.set_ylabel(f"zonal-band RMSE ({vn})")
    ax.legend(fontsize=7)
    fig.tight_layout()
    p = os.path.join(args.out_dir, "physical_soundness.png")
    fig.savefig(p, dpi=110)
    plt.close(fig)
    made.append(p)

    # 3..8) the array figures of each run with forecast arrays
    for name, (m, arrays) in runs.items():
        if arrays is None:
            continue
        out, tar = arrays["outputs"], arrays["targets"]
        grid = LatLonGrid(*out.shape[-2:])

        p = os.path.join(args.out_dir, f"long_rollout_{name}.png")
        P.long_rollout_mean_std_plot({name: out[0, :, v]}, tar[0, :, v], p,
                                     timedelta_hours=args.timedelta_hours, var_name=vn)
        made.append(p)

        last = out.shape[1] - 1
        p = os.path.join(args.out_dir, f"end_conditions_{name}.png")
        P.end_conditions_plot({name: out[0, last, v]}, tar[0, last, v], p,
                              day=int(last * args.timedelta_hours / 24), var_name=vn)
        made.append(p)

        p = os.path.join(args.out_dir, f"hovmoller_{name}.png")
        P.hovmoller_plot(out[0, :, v, out.shape[-2] // 2], grid.lons, p, var=vn)
        made.append(p)

        # [T, lat, K] zonal power; the mid-latitude ring for the line figures
        amp = zonal_power(out[0, :, v], grid.lats)
        mid = amp.shape[-2] // 2
        p = os.path.join(args.out_dir, f"zonal_fft_{name}.png")
        P.zonal_fft_amplitude_plot(amp[:, mid], p,
                                   time_indices=(0, out.shape[1] // 2, out.shape[1] - 1), var=vn)
        made.append(p)

        p = os.path.join(args.out_dir, f"wavenumber_dist_{name}.png")
        P.zonal_wavenumber_distribution_plot(amp[:, mid], p, var=vn)
        made.append(p)

        p = os.path.join(args.out_dir, f"ke_spectrum_{name}.png")
        P.kinetic_energy_spectrum_plot(
            {name: amp[:, mid].mean(axis=0),
             "verification": zonal_power(tar[0, :, v], grid.lats)[:, mid].mean(axis=0)}, p)
        made.append(p)

        p = os.path.join(args.out_dir, f"rmse_map_{name}.png")
        P.rmse_per_gridpoint_plot(out[:, :, v], tar[:, :, v], p, title=name)
        made.append(p)

    for p in made:
        print(f"-> {p}")
    return made


if __name__ == "__main__":
    main(sys.argv[1:])
