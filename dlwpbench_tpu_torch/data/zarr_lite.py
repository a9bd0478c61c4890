"""First-party zarr v2 directory-store reader/writer (numpy + stdlib zlib).

The port's copy of `dlwpbench_tpu/data/zarr_lite.py`.  The reference
loads WeatherBench data from per-variable yearly zarr stores via
`xr.open_mfdataset` (reference `data/datasets/datasets.py:277-298`).
Neither xarray, zarr-python nor the blosc codec is a dependency, so this
module implements the subset of the zarr v2 spec + xarray's zarr
conventions that the WeatherBench layout uses:

- directory stores: `.zgroup` / `.zarray` / `.zattrs` JSON metadata, chunk
  files named `i.j.k` (C order);
- codecs: raw (`compressor: null`) and zlib/gzip (stdlib);
- xarray conventions: every array carries `_ARRAY_DIMENSIONS` in its
  `.zattrs`; coordinate arrays are group members named after dimensions;
  time coordinates are ints with CF `units` ("hours since YYYY-MM-DD ...").

Arrays of more than one chunk are decoded by the native decoder
(`data/native.py`, `src/native/zarr_decoder.cpp`); a library that does not
build raises.  The writer emits stores that real zarr/xarray installations
read back unchanged (same spec).
"""

from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass, field

import numpy as np


def _json_load(path):
    with open(path) as f:
        return json.load(f)


def _read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _decode_chunk(buf: bytes, compressor) -> bytes:
    if compressor is None:
        return buf
    cid = compressor.get("id")
    if cid in ("zlib", "gzip"):
        return zlib.decompress(buf, 47)  # wbits=47: auto zlib/gzip header
    raise NotImplementedError(
        f"zarr_lite supports null/zlib/gzip compressors, got {cid!r} "
        "(blosc etc. are not supported)"
    )


def _encode_chunk(buf: bytes, compressor) -> bytes:
    if compressor is None:
        return buf
    if compressor.get("id") == "zlib":
        return zlib.compress(buf, compressor.get("level", 5))
    raise NotImplementedError(compressor.get("id"))


@dataclass
class ZarrArray:
    """A zarr v2 array in a directory store, loaded lazily per chunk."""

    path: str
    meta: dict = field(default_factory=dict)
    attrs: dict = field(default_factory=dict)

    @classmethod
    def open(cls, path: str) -> "ZarrArray":
        meta = _json_load(os.path.join(path, ".zarray"))
        if meta.get("zarr_format") != 2:
            raise ValueError(f"not a zarr v2 array: {path}")
        if meta.get("filters"):
            raise NotImplementedError("zarr filters not supported")
        if meta.get("order", "C") != "C":
            raise NotImplementedError("only C order supported")
        attrs = {}
        ap = os.path.join(path, ".zattrs")
        if os.path.exists(ap):
            attrs = _json_load(ap)
        return cls(path=path, meta=meta, attrs=attrs)

    @property
    def shape(self):
        return tuple(self.meta["shape"])

    @property
    def chunks(self):
        return tuple(self.meta["chunks"])

    @property
    def dtype(self):
        return np.dtype(self.meta["dtype"])

    @property
    def dims(self):
        return tuple(self.attrs.get("_ARRAY_DIMENSIONS", ()))

    def read(self) -> np.ndarray:
        """Materialize the full array."""
        shape, chunks = self.shape, self.chunks
        dt = self.dtype
        fill = self.meta.get("fill_value")
        out = np.full(
            shape, 0 if fill is None else fill, dtype=dt
        )
        if not shape:  # 0-d
            key = "0"
            fp = os.path.join(self.path, key)
            if os.path.exists(fp):
                raw = _decode_chunk(_read_bytes(fp), self.meta.get("compressor"))
                return np.frombuffer(raw, dt).reshape(())
            return out
        grid = [
            (s + c - 1) // c for s, c in zip(shape, chunks)
        ]
        sep = self.meta.get("dimension_separator", ".")
        idx_list = list(np.ndindex(*grid))
        paths = [
            os.path.join(self.path, sep.join(str(i) for i in idx))
            for idx in idx_list
        ]
        comp = self.meta.get("compressor")
        chunk_nbytes = int(np.prod(chunks)) * dt.itemsize

        exists = [os.path.exists(p) for p in paths]

        def scatter(j, block):
            idx = idx_list[j]
            slices = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, chunks, shape)
            )
            trims = tuple(slice(0, sl.stop - sl.start) for sl in slices)
            out[slices] = block[trims]

        # Native path: multithreaded read+inflate into an arena (GIL-free
        # C++, src/native/zarr_decoder.cpp); scatter stays vectorized here.
        # The arena is decoded in bounded batches so peak host RAM stays
        # ~1x the array (a full-array arena + `out` would be 2x).
        if len(idx_list) > 1 and (comp is None or comp.get("id") in ("zlib", "gzip")):
            from dlwpbench_tpu_torch.data import native

            batch = max(1, (256 << 20) // max(chunk_nbytes, 1))
            for lo in range(0, len(paths), batch):
                sub = paths[lo: lo + batch]
                arena, ok = native.decode_chunks(
                    sub, compressed=comp is not None, chunk_nbytes=chunk_nbytes,
                )
                for j2 in range(len(sub)):
                    j = lo + j2
                    if not ok[j2]:
                        if exists[j]:
                            # a decode failure is not an absent chunk (=
                            # fill_value): the pure-Python path raises too
                            raise ValueError(
                                f"corrupt or truncated zarr chunk {sub[j2]}"
                            )
                        continue  # missing chunk -> fill_value
                    scatter(j, arena[j2].view(dt).reshape(chunks))
            return out

        for j in range(len(idx_list)):
            if not exists[j]:
                continue  # missing chunk -> fill_value
            raw = _decode_chunk(_read_bytes(paths[j]), comp)
            scatter(j, np.frombuffer(raw, dt).reshape(chunks))
        return out


@dataclass
class ZarrGroup:
    """A zarr v2 group (xarray dataset): named member arrays + attrs."""

    path: str
    attrs: dict = field(default_factory=dict)

    @classmethod
    def open(cls, path: str) -> "ZarrGroup":
        if not os.path.exists(os.path.join(path, ".zgroup")):
            raise ValueError(f"not a zarr group: {path}")
        attrs = {}
        ap = os.path.join(path, ".zattrs")
        if os.path.exists(ap):
            attrs = _json_load(ap)
        return cls(path=path, attrs=attrs)

    def array_keys(self):
        out = []
        for name in sorted(os.listdir(self.path)):
            if os.path.exists(os.path.join(self.path, name, ".zarray")):
                out.append(name)
        return out

    def __getitem__(self, name: str) -> ZarrArray:
        return ZarrArray.open(os.path.join(self.path, name))

    def __contains__(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.path, name, ".zarray"))


# ---------------------------------------------------------------------------
# CF time decoding (the slice of cftime/xarray the WeatherBench layout needs)
# ---------------------------------------------------------------------------

_UNIT_TO_NP = {
    "nanoseconds": "ns", "microseconds": "us", "milliseconds": "ms",
    "seconds": "s", "minutes": "m", "hours": "h", "days": "D",
}


def decode_cf_time(values: np.ndarray, units: str) -> np.ndarray:
    """Decode "hours since 1979-01-01[ 00:00:00]"-style ints -> datetime64."""
    unit, _, epoch = units.partition(" since ")
    unit = _UNIT_TO_NP.get(unit.strip())
    if unit is None:
        raise ValueError(f"unsupported time units {units!r}")
    epoch = epoch.strip().replace(" ", "T")
    # offsets in the unit's OWN resolution (converting the step to seconds
    # would truncate sub-second units ms/us/ns -> 0 and silently decode
    # every timestamp as the epoch); ns-resolution base keeps a
    # time-of-day epoch exact even with coarse units like days
    base = np.datetime64(epoch, "ns")
    return base + values.astype("int64").astype(f"timedelta64[{unit}]")


def read_time_coord(arr: ZarrArray) -> np.ndarray:
    vals = arr.read()
    if np.issubdtype(vals.dtype, np.datetime64):
        return vals
    units = arr.attrs.get("units")
    if units is None:
        raise ValueError(f"time coord at {arr.path} lacks CF units")
    return decode_cf_time(vals, units)


# ---------------------------------------------------------------------------
# Writer (fixtures, nc->zarr fallback)
# ---------------------------------------------------------------------------


def write_array(
    path: str,
    data: np.ndarray,
    dims,
    chunks=None,
    attrs: dict | None = None,
    compressor: dict | str | None = "default",
) -> None:
    """Write one zarr v2 array with xarray's `_ARRAY_DIMENSIONS` attr.

    compressor: "default" -> zlib level 5; None -> uncompressed (raw);
    or an explicit zarr compressor dict.
    """
    if compressor == "default":
        compressor = {"id": "zlib", "level": 5}
    os.makedirs(path, exist_ok=True)
    data = np.ascontiguousarray(data)
    if chunks is None:
        chunks = data.shape
    meta = {
        "zarr_format": 2,
        "shape": list(data.shape),
        "chunks": list(chunks),
        "dtype": data.dtype.str,
        "compressor": compressor,
        "fill_value": None,
        "order": "C",
        "filters": None,
    }
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f)
    a = dict(attrs or {})
    a["_ARRAY_DIMENSIONS"] = list(dims)
    with open(os.path.join(path, ".zattrs"), "w") as f:
        json.dump(a, f)
    grid = [
        (s + c - 1) // c for s, c in zip(data.shape, chunks)
    ] or [1]
    for idx in np.ndindex(*grid):
        slices = tuple(
            slice(i * c, min((i + 1) * c, s))
            for i, c, s in zip(idx, chunks, data.shape)
        )
        block = data[slices]
        # pad partial edge chunks to full chunk shape (zarr stores full chunks)
        if block.shape != tuple(chunks):
            pad = [(0, c - bs) for c, bs in zip(chunks, block.shape)]
            block = np.pad(block, pad)
        key = ".".join(str(i) for i in idx) if data.shape else "0"
        with open(os.path.join(path, key), "wb") as f:
            f.write(_encode_chunk(block.tobytes(), compressor))


def write_dataset(
    path: str,
    data_vars: dict,
    coords: dict,
    attrs: dict | None = None,
) -> None:
    """Write an xarray-style dataset as a zarr group.

    data_vars: {name: (dims, ndarray)}; coords: {name: (dims, ndarray,
    attrs)} — pass time as int64 + CF "units" attr.
    """
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ".zgroup"), "w") as f:
        json.dump({"zarr_format": 2}, f)
    with open(os.path.join(path, ".zattrs"), "w") as f:
        json.dump(attrs or {}, f)
    for name, (dims, arr) in data_vars.items():
        write_array(os.path.join(path, name), np.asarray(arr), dims)
    for name, spec in coords.items():
        dims, arr, *rest = spec
        cattrs = rest[0] if rest else {}
        write_array(os.path.join(path, name), np.asarray(arr), dims, attrs=cattrs)
