"""Regrid EC46 ensemble / ERA5 files onto the 5.625-degree WeatherBench
grid (counterpart of `scripts/ec46_regrid.py`):

    python -m dlwpbench_tpu_torch.ec46_regrid --src SRC_DIR --dst DST_DIR [--ec46]

The reference's `data/processing/EC46_regridding.py:5-77` loops a directory
of netCDF files, linearly interpolates each dataset onto the hardcoded
32x64 target grid (after an optional -180..180 -> 0..360 longitude
convention flip), warns on NaNs, and writes per-year files.  Here each
classic netCDF3 file (`scipy.io.netcdf_file`) or zarr store
(`data/zarr_lite.py`) under SRC_DIR is regridded with
`data.preprocessing.regrid_linear` and written as the zarr store
`<stem>_5.625deg.zarr` under DST_DIR, which the `WeatherBenchZarr`
source reads.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from dlwpbench_tpu_torch.data import zarr_lite
from dlwpbench_tpu_torch.data.preprocessing import regrid_linear

# the reference's hardcoded 5.625-degree target grid (`EC46_regridding.py:19-36`)
TARGET_LAT = np.linspace(-87.1875, 87.1875, 32)
TARGET_LON = np.arange(64) * 5.625


def convert_longitude_180_to_360(lon: np.ndarray) -> np.ndarray:
    """`EC46_regridding.py:8-9`."""
    return (lon + 360) % 360


def _read_netcdf3(path):
    """Classic netCDF via scipy: {name: (dims, array, attrs)}, coords
    included; text attributes decoded (JAX's script keeps them as bytes,
    which the zarr writer's JSON refuses)."""
    from scipy.io import netcdf_file

    with netcdf_file(path, mmap=False) as f:
        out = {}
        for name, var in f.variables.items():
            out[name] = (tuple(var.dimensions), np.asarray(var[:]),
                         {k: (v.decode() if isinstance(v, bytes) else v)
                          for k, v in var._attributes.items()})
    return out


def _read_zarr(path):
    g = zarr_lite.ZarrGroup.open(path)
    out = {}
    for name in g.array_keys():
        arr = g[name]
        out[name] = (arr.dims, arr.read(), dict(arr.attrs))
    return out


def regrid_dataset(variables: dict, ec46: bool = True) -> dict:
    """Interpolate every (time, [level,] lat, lon) variable onto the
    5.625-degree grid; returns the regridded dataset dict."""
    def pick(*names):
        for n in names:
            if n in variables:
                return n
        return None

    lat_name = pick("lat", "latitude")
    lon_name = pick("lon", "longitude")
    if lat_name is None or lon_name is None:
        raise ValueError(f"no lat/lon coords among {sorted(variables)}")
    src_lat = variables[lat_name][1].astype(np.float64)
    src_lon = variables[lon_name][1].astype(np.float64)
    if src_lon.min() < -1e-6:  # -180..180 convention
        src_lon = convert_longitude_180_to_360(src_lon)
    order_lon = np.argsort(src_lon)
    order_lat = np.argsort(src_lat)

    out = {}
    for name, (dims, data, attrs) in variables.items():
        if lat_name not in dims or lon_name not in dims:
            if name not in (lat_name, lon_name):
                out[name] = (dims, data, attrs)
            continue
        if np.isnan(np.asarray(data, np.float64)).any():
            print(f"Warning: {name} contains NaN values")
        la, lo = dims.index(lat_name), dims.index(lon_name)
        d = np.moveaxis(data, (la, lo), (-2, -1))
        d = d[..., order_lat, :][..., order_lon]
        r = regrid_linear(
            np.asarray(d, np.float32),
            src_lat[order_lat], src_lon[order_lon],
            TARGET_LAT, TARGET_LON,
        )
        new_dims = tuple(
            x for i, x in enumerate(dims) if i not in (la, lo)
        ) + ("lat", "lon")
        out[name] = (new_dims, r, attrs)
    out["lat"] = (("lat",), TARGET_LAT.astype(np.float32), {})
    out["lon"] = (("lon",), TARGET_LON.astype(np.float32), {})
    return out


def write_zarr(ds: dict, path: str) -> None:
    data_vars, coords = {}, {}
    for name, (dims, data, attrs) in ds.items():
        if name in dims or name in ("lat", "lon", "time", "level"):
            coords[name] = (dims, data, attrs)
        else:
            data_vars[name] = (dims, data)
    zarr_lite.write_dataset(path, data_vars, coords)


def main(argv=None) -> int:
    """Returns the number of stores regridded."""
    ap = argparse.ArgumentParser(prog="python -m dlwpbench_tpu_torch.ec46_regrid",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="directory of .nc/.zarr stores")
    ap.add_argument("--dst", required=True, help="output zarr directory")
    ap.add_argument("--ec46", action="store_true",
                    help="EC46 naming (month-year) instead of tisr yearly")
    args = ap.parse_args(argv)

    entries = sorted(glob.glob(os.path.join(args.src, "*")))
    n = 0
    for p in entries:
        if p.endswith(".nc") and os.path.isfile(p):
            variables = _read_netcdf3(p)
        elif os.path.isdir(p) and os.path.exists(os.path.join(p, ".zgroup")):
            variables = _read_zarr(p)
        else:
            continue
        print(f"Processing: {p}")
        ds = regrid_dataset(variables, ec46=args.ec46)
        stem = os.path.splitext(os.path.basename(p))[0]
        write_zarr(ds, os.path.join(args.dst, f"{stem}_5.625deg.zarr"))
        n += 1
    print(f"regridded {n} stores -> {args.dst}")
    return n


if __name__ == "__main__":
    main()
