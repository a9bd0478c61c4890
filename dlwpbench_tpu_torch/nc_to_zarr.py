"""netCDF -> zarr tree converter (counterpart of `scripts/nc_to_zarr.py`;
reference `data/processing/nc_to_zarr.py`):

    python -m dlwpbench_tpu_torch.nc_to_zarr SRC_DIR DST_DIR

Every classic netCDF3 file under SRC_DIR (read with
`scipy.io.netcdf_file`) becomes a zarr store at the same relative path
under DST_DIR, written with the port's `data/zarr_lite.py`: its dimension
variables as coordinates with their CF attributes, the rest as data
variables.  netCDF4/HDF5 files need xarray, which the JAX script uses where
it is installed; the port has no such branch and says so.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def convert(path: str, dst: str) -> None:
    """Classic netCDF3 -> zarr via zarr_lite (CF attrs preserved)."""
    from scipy.io import netcdf_file

    from dlwpbench_tpu_torch.data import zarr_lite

    with netcdf_file(path, mmap=False) as f:
        dim_names = set(f.dimensions)
        data_vars, coords = {}, {}
        for name, var in f.variables.items():
            dims = tuple(var.dimensions)
            attrs = {k: (v.decode() if isinstance(v, bytes) else v)
                     for k, v in var._attributes.items()}
            arr = np.asarray(var[:])
            if name in dim_names:
                coords[name] = (dims, arr, attrs)
            else:
                data_vars[name] = (dims, arr)
        zarr_lite.write_dataset(dst, data_vars, coords)


def main(argv=None) -> int:
    """Returns the number of files converted."""
    ap = argparse.ArgumentParser(prog="python -m dlwpbench_tpu_torch.nc_to_zarr",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("src_dir")
    ap.add_argument("dst_dir")
    args = ap.parse_args(argv)
    n = 0
    for path in sorted(glob.glob(os.path.join(args.src_dir, "**", "*.nc"), recursive=True)):
        rel = os.path.relpath(path, args.src_dir)
        dst = os.path.join(args.dst_dir, os.path.splitext(rel)[0] + ".zarr")
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        try:
            convert(path, dst)
        except TypeError as e:
            raise SystemExit(f"{path}: not a classic netCDF3 file; converting netCDF4/HDF5 "
                             "needs xarray (scripts/nc_to_zarr.py where it is installed)") from e
        print(f"{path} -> {dst}")
        n += 1
    print(f"converted {n} files")
    return n


if __name__ == "__main__":
    main()
