"""Lat-lon <-> HEALPix remap CLI of the port (counterpart of
`scripts/remap_healpix.py`; reference `data/processing/healpix_mapping.py`
CLI) on .npy / .npz arrays:

    python -m dlwpbench_tpu_torch.remap_healpix ll2hpx IN.npy OUT.npy [--nside 8]
    python -m dlwpbench_tpu_torch.remap_healpix hpx2ll IN.npy OUT.npy [--nlat 32 --nlon 64]

`ll2hpx` reads [..., nlat, nlon] and writes [..., 12, nside, nside];
`hpx2ll` reads [..., 12, nside, nside] and writes [..., nlat, nlon].  An
.npz input gives its first array.  The remap (`grids.remap`) runs on
`--device`, CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dlwpbench_tpu_torch import resolve_device
from dlwpbench_tpu_torch.grids.remap import HEALPixRemap


def main(argv=None) -> np.ndarray:
    """Returns the remapped array it wrote."""
    ap = argparse.ArgumentParser(prog="python -m dlwpbench_tpu_torch.remap_healpix",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("direction", choices=["ll2hpx", "hpx2ll"])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--nside", type=int, default=8)
    ap.add_argument("--nlat", type=int, default=32)
    ap.add_argument("--nlon", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    data = np.load(args.input)
    if hasattr(data, "files"):  # npz
        data = data[data.files[0]]
    x = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
    if args.direction == "ll2hpx":
        out = HEALPixRemap(*data.shape[-2:], args.nside).ll2hpx(x)
    else:
        out = HEALPixRemap(args.nlat, args.nlon, data.shape[-1]).hpx2ll(x)
    out = out.cpu().numpy()
    np.save(args.output, out)
    print(f"{args.direction}: {data.shape} -> {out.shape} -> {args.output}")
    return out


if __name__ == "__main__":
    main()
