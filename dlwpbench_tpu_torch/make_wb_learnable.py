"""Generate a learnable WeatherBench-layout dataset from Navier-Stokes
dynamics (the port's counterpart of `scripts/make_wb_learnable.py`):

    python -m dlwpbench_tpu_torch.make_wb_learnable [--root data/zarr/wb_learnable] \
        [--years 1979 1982] [--inner-steps 600] [--n 64] [--nu 1e-3] [--seed 7] \
        [--device cuda]

A random walk's best forecast is persistence, so a model cannot show skill
on one; here the fields come from the port's 2D Navier-Stokes solver
(`data/ns2d.py`, on `--device`), whose vorticity evolves deterministically.
The layout is the reference's (`datasets.py:277-298`): per-variable
directories of yearly zarr stores plus `constants/`, 6-hourly CF time
coordinates, written by the port's `zarr_lite`.  The variables are those of
`configs/data/wb_learnable.yaml`: `msl` (the vorticity) and `stream` at
levels 250 (the streamfunction) and 500 (u = d(psi)/dy), each pooled to
32 x 64 and scaled to the physical range of the manual normalisation table
(`data/stats_tables.py`); `tisr`, the analytic insolation at the frames'
dates (`data/insolation.py`, in solar-constant units); and the constants
`orography`, `lsm`, `lat2d`, `lon2d`.

`--inner-steps` sets the solver time per 6-hour frame (dt = 1e-3): 600
gives a lag-1 autocorrelation about 0.98 and about 0.7 by lag 16.  A
burn-in of 20 frames' worth of steps puts the first year on the attractor.
The JAX script records in chunks of 400 frames to keep its traces short;
the port runs one simulation.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

STEPS_PER_DAY = 4  # 6-hourly
H, W = 32, 64


def year_hours(year: int, n_steps: int) -> np.ndarray:
    """Hours since 1979-01-01 of a year's 6-hourly frames."""
    start = np.datetime64(f"{year}-01-01T00:00")
    epoch = np.datetime64("1979-01-01T00:00")
    offset = (start - epoch) // np.timedelta64(1, "h")
    return (offset + np.arange(n_steps) * (24 // STEPS_PER_DAY)).astype("int64")


def _to_latlon(f: np.ndarray) -> np.ndarray:
    """[T, n, n] on the torus -> [T, 32, 64]: row pairs mean-pooled (lat),
    longitudes periodic."""
    return f.reshape(f.shape[0], H, 2, W).mean(axis=2).astype(np.float32)


def _normalize_to(f: np.ndarray, mean: float, std: float) -> np.ndarray:
    f = (f - f.mean()) / (f.std() + 1e-12)
    return (f * std + mean).astype(np.float32)


def lag_autocorrelations(field: np.ndarray, lags=(1, 4, 16)) -> dict[int, float]:
    """{lag: autocorrelation} of a [T, ...] series about its overall mean."""
    flat = field.reshape(len(field), -1) - field.mean()
    out = {}
    for lag in lags:
        num = (flat[:-lag] * flat[lag:]).sum()
        den = np.sqrt((flat[:-lag] ** 2).sum() * (flat[lag:] ** 2).sum())
        out[lag] = float(num / den)
    return out


def make_wb_learnable(root: str, years=(1979, 1982), inner_steps: int = 600, n: int = 64,
                      nu: float = 1e-3, seed: int = 7, device="cuda", w0=None) -> dict:
    """Simulate and write the store under `root`; `w0` [1, n, n] replaces
    the initial field drawn from `seed` (a test hands in the JAX
    package's).  Returns the frame count and the lag autocorrelations."""
    import torch

    from dlwpbench_tpu_torch import resolve_device
    from dlwpbench_tpu_torch.data import ns2d, zarr_lite
    from dlwpbench_tpu_torch.data.insolation import insolation
    from dlwpbench_tpu_torch.data.stats_tables import TABLES

    dev = resolve_device(device)
    years = list(range(int(years[0]), int(years[1]) + 1))
    n_frames_year = 365 * STEPS_PER_DAY
    total = len(years) * n_frames_year

    print(f"simulating {total} frames ({len(years)} years) at n={n}, "
          f"inner_steps={inner_steps} on {dev} ...", flush=True)
    if w0 is None:
        w0 = ns2d.initial_field(seed, n, 1)
    w0 = torch.as_tensor(w0, dtype=torch.float32).to(dev)
    # burn-in onto the attractor so year 1 is statistically stationary
    burn = ns2d.simulate(w0, n=n, nu=nu, dt=1e-3, record_steps=1, inner_steps=20 * inner_steps)
    traj = ns2d.simulate(burn[:, -1], n=n, nu=nu, dt=1e-3, record_steps=total,
                         inner_steps=inner_steps)
    w = traj[0, 1:].cpu().numpy()  # [total, n, n], the repeated start dropped

    # solver diagnostics on the torus -> physical-range WB variables
    g = ns2d.make_grid(n)
    w_hat = np.fft.rfft2(w)
    psi_hat = w_hat * g.inv_lap.numpy()  # streamfunction
    psi = np.fft.irfft2(psi_hat, s=(n, n))
    # u = d(psi)/dy: the second deterministic diagnostic, for stream500
    u = np.fft.irfft2(1j * g.ky.numpy() * psi_hat, s=(n, n))

    wz = _to_latlon(w)
    lags = lag_autocorrelations(wz)
    for lag, r in lags.items():
        print(f"  lag-{lag} autocorr: {r:.3f}", flush=True)

    tbl = next(t for t in TABLES.values() if "msl" in t and "stream250" in t)
    msl_field = _normalize_to(wz, tbl["msl"]["mean"], tbl["msl"]["std"])
    # "stream" is level-indexed in the config (stream: [250, 500]): one
    # store with a level dim; the per-level stats come from the flat
    # stream250/stream500 table keys
    stream = np.stack([
        _normalize_to(_to_latlon(psi), tbl["stream250"]["mean"], tbl["stream250"]["std"]),
        _normalize_to(_to_latlon(u), tbl["stream500"]["mean"], tbl["stream500"]["std"]),
    ], axis=1)  # [T, level, H, W]

    lat = np.linspace(-87.1875, 87.1875, H).astype(np.float32)
    lon = (np.arange(W) * (360.0 / W)).astype(np.float32)
    time_attrs = {"units": "hours since 1979-01-01 00:00:00",
                  "calendar": "proleptic_gregorian"}

    all_dates = np.concatenate([
        np.datetime64("1979-01-01T00:00") + year_hours(y, n_frames_year) * np.timedelta64(1, "h")
        for y in years
    ])
    # S=1.0: the manual tisr stats (mean 0.25, std 0.32) are in normalised
    # solar-constant units; raw W/m^2 would enter the model at ~4000 sigma
    tisr = insolation(all_dates, lat, lon, S=1.0).astype(np.float32)

    def write_var(dirname, varname, data, levels=None):
        dims = ("time", "level", "lat", "lon") if levels is not None else ("time", "lat", "lon")
        for i, y in enumerate(years):
            coords = {
                "time": (("time",), year_hours(y, n_frames_year), time_attrs),
                "lat": (("lat",), lat),
                "lon": (("lon",), lon),
            }
            if levels is not None:
                coords["level"] = (("level",), np.asarray(levels, dtype="int64"))
            zarr_lite.write_dataset(
                os.path.join(root, dirname, f"{varname}_{y}_5.625deg.zarr"),
                {varname: (dims, data[i * n_frames_year : (i + 1) * n_frames_year])},
                coords,
            )

    write_var("msl", "msl", msl_field)
    write_var("stream", "stream", stream, levels=[250, 500])
    write_var("toa_incident_solar_radiation", "tisr", tisr)

    lat2d, lon2d = np.meshgrid(lat, lon, indexing="ij")
    rng = np.random.default_rng(seed)
    zarr_lite.write_dataset(
        os.path.join(root, "constants", "constants_5.625deg.zarr"),
        {
            "orography": (("lat", "lon"), 840.0 * rng.random((H, W)).astype(np.float32)),
            "lsm": (("lat", "lon"), (rng.random((H, W)) > 0.6).astype(np.float32)),
            "lat2d": (("lat", "lon"), lat2d.astype(np.float32)),
            "lon2d": (("lat", "lon"), lon2d.astype(np.float32)),
        },
        {"lat": (("lat",), lat), "lon": (("lon",), lon)},
    )
    print(f"-> {root} ({total} frames, {len(years)} years)")
    return {"frames": total, "lag_autocorr": lags}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m dlwpbench_tpu_torch.make_wb_learnable",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default="data/zarr/wb_learnable")
    ap.add_argument("--years", nargs=2, type=int, default=[1979, 1982],
                    help="first and last year (inclusive)")
    ap.add_argument("--inner-steps", type=int, default=600)
    ap.add_argument("--n", type=int, default=64, help="solver grid")
    ap.add_argument("--nu", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return make_wb_learnable(args.root, args.years, args.inner_steps, args.n, args.nu,
                             args.seed, args.device)


if __name__ == "__main__":
    main()
