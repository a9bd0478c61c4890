"""ctypes loader for the native C++ data libraries (`src/native/*.cpp`).

The port's own loader for the sources the JAX package ships:

- `window_batcher.cpp`: `assemble_windows` (a multithreaded gather of a
  batch's windows) and `add_gaussian_noise` (fused xorshift128+ /
  Box-Muller noise, per-thread streams);
- `zarr_decoder.cpp`: `decode_zarr_chunks` (multithreaded read and zlib
  inflate of zarr chunk files into an arena).

Each library is built at first use with

    g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread SRC -o LIB [-lz]

into `build/native/` at the repository root (listed in `.gitignore`),
named by a hash of its source, of the flags and of what `-march=native`
means on this CPU, so an edited source or another CPU never gets a stale
library.  Nothing is written next to the source.  A failed build raises
with the compiler's output; there is no numpy fallback.  Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC_DIR = os.path.join(_REPO, "src", "native")
BUILD_DIR = os.path.join(_REPO, "build", "native")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")
_LIBS = {"window_batcher": (), "zarr_decoder": ("-lz",)}
# the JAX loader's thread counts: the noise streams are split per thread,
# so the batcher's count is part of what its noise is
BATCH_THREADS = 4
DECODE_THREADS = 8


@functools.lru_cache(maxsize=None)
def _target() -> bytes:
    """What `-march=native` resolves to on this CPU (g++'s target
    options), so a library built for one CPU is never loaded on another
    that lacks its instructions (a build directory copied between
    machines)."""
    try:
        proc = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                              capture_output=True, check=True)
    except (FileNotFoundError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"g++ cannot report its -march=native target: {e}") from None
    return proc.stdout


def library_path(name: str) -> str:
    """Where `src/native/<name>.cpp` is built: keyed by the source, the
    flags, the machine's arch and the CPU's `-march=native` target."""
    digest = hashlib.sha256()
    with open(os.path.join(SRC_DIR, f"{name}.cpp"), "rb") as f:
        digest.update(f.read())
    digest.update(" ".join((*GXX_FLAGS, *_LIBS[name])).encode())
    digest.update(_target())
    return os.path.join(BUILD_DIR, f"{name}-{platform.machine()}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile `src/native/<name>.cpp` unless its build exists; returns the
    library's path.  Builds into a temp file and renames it, so a process
    never loads a half-written library from a concurrent build.  Raises
    with g++'s output on a failed build."""
    lib = library_path(name)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, os.path.join(SRC_DIR, f"{name}.cpp"), "-o", tmp, *_LIBS[name]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    except FileNotFoundError:
        os.unlink(tmp)
        raise RuntimeError(f"g++ not found: the port builds {name}.cpp from source") from None
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"g++ failed for {name}.cpp:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load a native library, once per process,
    with every entry point's argument and result types declared."""
    lib = ctypes.CDLL(build(name))
    if name == "window_batcher":
        lib.assemble_windows.argtypes = [_F32P, ctypes.c_int64, ctypes.c_int64, _I64P,
                                         ctypes.c_int64, ctypes.c_int64, _F32P, ctypes.c_int]
        lib.assemble_windows.restype = None
        lib.add_gaussian_noise.argtypes = [_F32P, ctypes.c_int64, ctypes.c_float,
                                           ctypes.c_uint64, ctypes.c_int]
        lib.add_gaussian_noise.restype = None
    else:
        lib.decode_zarr_chunks.argtypes = [ctypes.c_char_p, _I64P, ctypes.c_int64, _U8P, _U8P,
                                           ctypes.c_int64, _U8P, ctypes.c_int]
        lib.decode_zarr_chunks.restype = None
    return lib


def assemble_windows(data: np.ndarray, starts: np.ndarray, seq: int,
                     n_threads: int = BATCH_THREADS) -> np.ndarray:
    """data [T, *feat] float32 and window starts [B] -> [B, seq, *feat]."""
    data = np.ascontiguousarray(data, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    T, feat_shape = data.shape[0], data.shape[1:]
    B = len(starts)
    # the only bounds check before the library's unchecked memcpy (a
    # raise, not an assert: `python -O` strips asserts)
    if B and not ((starts >= 0).all() and (starts + seq <= T).all()):
        raise ValueError(
            f"window out of bounds: starts in [{starts.min()}, {starts.max()}], "
            f"seq {seq}, T {T}"
        )
    out = np.empty((B, seq, *feat_shape), np.float32)
    load("window_batcher").assemble_windows(
        data.ctypes.data_as(_F32P), T, int(np.prod(feat_shape, dtype=np.int64)),
        starts.ctypes.data_as(_I64P), B, seq, out.ctypes.data_as(_F32P), int(n_threads),
    )
    return out


def add_gaussian_noise(arr: np.ndarray, noise_std: float, seed: int) -> np.ndarray:
    """arr += noise_std * N(0, 1), in place, from `seed` (split into
    `BATCH_THREADS` streams, as the JAX loader splits it); returns arr."""
    if noise_std == 0:
        return arr
    if arr.dtype != np.float32 or not arr.flags.c_contiguous:
        raise ValueError("add_gaussian_noise takes a C-contiguous float32 array")
    load("window_batcher").add_gaussian_noise(
        arr.ctypes.data_as(_F32P), arr.size, float(noise_std), int(seed) & (2**64 - 1),
        BATCH_THREADS,
    )
    return arr


def decode_chunks(paths: list, compressed: bool, chunk_nbytes: int):
    """Read and decode chunk files in parallel -> (arena [n, chunk_nbytes]
    uint8, ok [n] bool); ok is False for a missing or undecodable file."""
    lib = load("zarr_decoder")
    enc = [os.fsencode(p) + b"\0" for p in paths]
    offsets = np.cumsum([0] + [len(e) for e in enc[:-1]], dtype=np.int64)
    blob = b"".join(enc)
    arena = np.empty((len(enc), chunk_nbytes), np.uint8)
    ok = np.zeros(len(enc), np.uint8)
    comp = np.full(len(enc), 1 if compressed else 0, np.uint8)
    lib.decode_zarr_chunks(
        blob, offsets.ctypes.data_as(_I64P), len(enc), comp.ctypes.data_as(_U8P),
        arena.ctypes.data_as(_U8P), int(chunk_nbytes), ok.ctypes.data_as(_U8P),
        DECODE_THREADS,
    )
    return arena, ok.astype(bool)
