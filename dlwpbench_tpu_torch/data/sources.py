"""Data sources: build train/val/test `WindowedWeatherDataset`s from a config.

The port's copy of `dlwpbench_tpu/data/sources.py`:
- `synthetic`: deterministic ERA5-like random fields, on a lat-lon grid
  or on the HEALPix faces (`healpix_nside`);
- `WeatherBenchZarr`: the reference's zarr tree layout
  (`data/datasets/datasets.py:277-298`): per-variable directories of yearly
  zarr stores, split by date range, z-score normalised per variable and
  level, read by the port's `zarr_lite`.  A HEALPix tree's arrays carry a
  face dim (`[time, (level,) face, height, width]`), which passes through
  to fields [T, C, 12, n, n].
`NavierStokes` raises and names its ROADMAP item.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from dlwpbench_tpu_torch.data.dataset import (
    VariableStats,
    WindowedWeatherDataset,
    biweekly_init_indices,
    compute_stats,
    synthetic_weatherbench,
)

_NOT_PORTED = {
    "NavierStokes": "ROADMAP queue A, Navier-Stokes solver",
}


def build_datasets(data_cfg: dict, training_cfg: dict, validation_cfg: dict,
                   testing_cfg: dict | None = None, context_size: int = 1):
    """Returns (train_ds, val_ds, test_ds, stats) per the config."""
    typ = data_cfg["type"]
    if typ == "synthetic":
        return _synthetic(data_cfg, training_cfg, validation_cfg, testing_cfg, context_size)
    if typ == "WeatherBenchZarr":
        return _weatherbench_zarr(data_cfg, training_cfg, validation_cfg, testing_cfg,
                                  context_size)
    if typ in _NOT_PORTED:
        raise NotImplementedError(
            f"data type {typ!r} is not ported to PyTorch yet ({_NOT_PORTED[typ]})"
        )
    raise ValueError(f"unknown data type {typ!r}")


def _split_windows(const, pres, prog, fractions=(0.7, 0.15, 0.15)):
    T = prog.shape[0]
    n_train = int(T * fractions[0])
    n_val = int(T * fractions[1])
    return [
        (const, None if pres is None else pres[lo:hi], prog[lo:hi])
        for lo, hi in [(0, n_train), (n_train, n_train + n_val), (n_train + n_val, T)]
    ]


def _mk(split, seq, ctx, noise, seed):
    const, pres, prog = split
    return WindowedWeatherDataset(
        prognostic=prog,
        constants=const,
        prescribed=pres,
        sequence_length=seq,
        context_size=ctx,
        noise=noise,
        seed=seed,
    )


def _synthetic(d, tr, va, te, ctx):
    const, pres, prog = synthetic_weatherbench(
        n_time=int(d.get("n_time", 128)),
        nlat=int(d["height"]),
        nlon=int(d["width"]),
        n_prognostic=int(d["prognostic_channels"]),
        n_prescribed=int(d["prescribed_channels"]),
        n_constants=int(d["constant_channels"]),
        healpix_nside=d.get("healpix_nside"),
        seed=int(d.get("seed", 0)),
    )
    stats = {"prognostic": compute_stats(prog)}
    if d.get("normalize", True):
        prog = np.nan_to_num(stats["prognostic"].normalize(prog)).astype(np.float32)
    splits = _split_windows(const, pres, prog)
    train = _mk(splits[0], int(tr["sequence_length"]), ctx, float(tr.get("noise", 0)), 1)
    val = _mk(splits[1], int(va["sequence_length"]), ctx, 0.0, 2)
    test_seq = int((te or va)["sequence_length"])
    test = _mk(splits[2], test_seq, ctx, 0.0, 3)

    # Forecast protocol: biweekly Monday/Thursday 11:00 UTC inits; the
    # synthetic timeline is 6-hourly from `start_date` and the test split
    # inherits its tail.
    timedelta_h = int(d.get("timedelta", 6))
    start = np.datetime64(str(d.get("start_date", "2017-01-01T05:00")))
    n_total = prog.shape[0]
    times = start + np.arange(n_total) * np.timedelta64(timedelta_h, "h")
    test_t0 = n_total - splits[2][2].shape[0]
    test_times = times[test_t0:]
    idx = biweekly_init_indices(test_times, test_times[0], test_times[-1])
    idx = idx[idx + test_seq + 1 <= len(test_times)]
    if len(idx):
        test.init_indices = idx.tolist()
    return train, val, test, stats


def _find_data_array(group, want: str):
    """Locate the data variable in a per-variable yearly store.

    WeatherBench directory names differ from the variable names inside
    (e.g. `toa_incident_solar_radiation/` holds `tisr`), so fall back to
    the unique array that is not a coordinate (its name is not a dim).
    """
    if want in group:
        return want
    candidates = [k for k in group.array_keys()
                  if k not in group[k].dims and k not in ("level",)]
    if len(candidates) == 1:
        return candidates[0]
    raise ValueError(
        f"cannot identify data variable in {group.path} (candidates: {candidates})"
    )


def _load_variable_series(path: str, var_dir: str):
    """Concatenate a variable's yearly zarr stores along time.

    Returns (times[T], values[T, (level,) (face,) H, W], dims, levels): the
    reference's `xr.open_mfdataset(glob(...))` and time sort
    (`datasets.py:291-298`).
    """
    from dlwpbench_tpu_torch.data import zarr_lite

    stores = [s for s in sorted(glob.glob(os.path.join(path, var_dir, "*"))) if os.path.isdir(s)]
    if not stores:
        raise FileNotFoundError(f"no zarr stores under {path}/{var_dir}")
    times, chunks, dims, levels = [], [], None, None
    for s in stores:
        g = zarr_lite.ZarrGroup.open(s)
        arr = g[_find_data_array(g, os.path.basename(var_dir))]
        if "time" not in arr.dims:
            raise ValueError(f"{arr.path} has no time dim: {arr.dims}")
        if arr.dims.index("time") != 0:
            raise NotImplementedError("time must be the leading dim")
        times.append(zarr_lite.read_time_coord(g["time"]))
        chunks.append(arr.read())
        dims = arr.dims
        if "level" in g:
            levels = g["level"].read()
    t = np.concatenate(times)
    v = np.concatenate(chunks, axis=0)
    order = np.argsort(t, kind="stable")
    return t[order], v[order], dims, levels


def _load_constants(path: str, names):
    """Read constant fields from the `constants/` store(s)."""
    from dlwpbench_tpu_torch.data import zarr_lite

    out = {}
    stores = [s for s in sorted(glob.glob(os.path.join(path, "constants", "*")))
              if os.path.isdir(s)]
    if os.path.exists(os.path.join(path, "constants", ".zgroup")):
        stores = [os.path.join(path, "constants")] + stores
    for s in stores:
        g = zarr_lite.ZarrGroup.open(s)
        for k in g.array_keys():
            arr = g[k]
            if k in names and k not in arr.dims and "time" not in arr.dims:
                out[k] = arr.read()
    missing = [n for n in names if n not in out]
    if missing:
        raise FileNotFoundError(f"constants {missing} not found under {path}/constants")
    return out


def _weatherbench_zarr(d, tr, va, te, ctx):
    """The reference's zarr tree through `zarr_lite`.

    Layout, role split, manual normalisation tables (else statistics of
    each variable's whole loaded series), NaN fill, the `timedelta`
    stride, `downscale_factor`, per-split `times` and the test split's
    biweekly inits all follow the JAX package's `_weatherbench_zarr`
    (reference `datasets.py:264-416`).
    """
    from dlwpbench_tpu_torch.data import stats_tables
    from dlwpbench_tpu_torch.data.preprocessing import coarsen_mean

    path = d["data_path"]
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"WeatherBench data not found at {path!r}; convert it to the zarr "
            "layout first or use data=synthetic."
        )
    td = int(d.get("timedelta", 6))
    normalize = bool(d.get("normalize", True))
    downscale = int(d.get("downscale_factor", 1))
    train_year = int(str(d["train_start_date"])[:4])
    table = stats_tables.select_table(d.get("statistics"), train_year)

    prog_spec = d["prognostic_variable_names_and_levels"]
    pres_names = list(d.get("prescribed_variable_names", []))
    const_names = list(d.get("constant_names", []))

    # every variable's full series, loaded once
    series = {  # var -> (times, values, dims, levels)
        v: _load_variable_series(path, stats_tables.file_name_for(table, v))
        for v in list(prog_spec) + pres_names
    }
    const_raw = _load_constants(path, const_names) if const_names else {}

    raw_stats: dict[str, VariableStats] = {}

    def norm(key, var, arr, level=None):
        st = stats_tables.stats_for(table, var, level) if normalize else None
        if st is None:
            st = raw_stats.setdefault(key, compute_stats(arr))
        else:
            raw_stats.setdefault(key, st)
        if not normalize:
            return np.nan_to_num(arr)
        return np.nan_to_num(st.normalize(arr))

    def channels(var, arr, dims, levels):
        """A loaded series split into per-level [T, ...] channels."""
        want = prog_spec.get(var, [])
        if not want:
            yield norm(var, var, arr)
            return
        if levels is None or "level" not in dims:
            raise ValueError(f"{var} has no level dim but levels {want} requested")
        ax = dims.index("level")
        lv_idx = {float(lv): i for i, lv in enumerate(np.asarray(levels).ravel())}
        for lv in want:
            yield norm(f"{var}{lv}", var, np.take(arr, lv_idx[float(lv)], axis=ax), lv)

    def ds_space(a):
        return coarsen_mean(a, downscale) if downscale > 1 else a

    def window(start, stop):  # the dates, stop inclusive
        return np.datetime64(str(start)), np.datetime64(str(stop)) + np.timedelta64(1, "D")

    def select(times, values, start, stop):
        t0, t1 = window(start, stop)
        return values[(times >= t0) & (times < t1)][::td]

    # each channel normalised once, in the JAX source's order (the
    # statistics are those of the whole loaded series, as there), then
    # each split selected from it; the raw series go once normalised
    t_ref = series[next(iter(prog_spec))][0]
    prog_series = [(series[v][0], ch) for v in prog_spec for ch in channels(v, *series[v][1:])]
    pres_series = [(series[v][0], norm(v, v, series[v][1])) for v in pres_names]
    const = None
    if const_names:
        const = np.stack(
            [ds_space(norm(c, c, const_raw[c])) for c in const_names], 0
        ).astype(np.float32)
    series.clear()

    def to_arrays(start, stop):
        prog = np.stack([ds_space(select(t, ch, start, stop)) for t, ch in prog_series],
                        1).astype(np.float32)
        pres = (np.stack([ds_space(select(t, ch, start, stop)) for t, ch in pres_series],
                         1).astype(np.float32) if pres_series else None)
        return None if const is None else const.copy(), pres, prog

    splits = [(d[f"{s}_start_date"], d[f"{s}_stop_date"]) for s in ("train", "val", "test")]
    train = _mk(to_arrays(*splits[0]), int(tr["sequence_length"]), ctx,
                float(tr.get("noise", 0)), 1)
    val = _mk(to_arrays(*splits[1]), int(va["sequence_length"]), ctx, 0.0, 2)
    test_seq = int((te or va)["sequence_length"])
    test = _mk(to_arrays(*splits[2]), test_seq, ctx, 0.0, 3)

    # per-frame valid times (the real calendar), so consumers can stratify
    # by month (monthly climatology, ACC)
    for ds, (start, stop) in zip((train, val, test), splits):
        t0, t1 = window(start, stop)
        ds.times = t_ref[(t_ref >= t0) & (t_ref < t1)][::td]

    # the forecast protocol on the test split: biweekly Monday/Thursday
    # 11:00 UTC inits (reference `evaluate.py:56-77`)
    if len(test.times):
        idx = biweekly_init_indices(test.times, test.times[0], test.times[-1])
        idx = idx[idx + test_seq + 1 <= len(test.times)]
        if len(idx):
            test.init_indices = idx.tolist()
    return train, val, test, raw_stats
