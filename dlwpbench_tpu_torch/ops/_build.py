"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers), so
`nvcc` compiles it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -split-compile=0 -Xptxas -v \
        -o build/cuda/<name>-<hash>.so csrc/<name>.cu

The library lands in `build/cuda/` at the repository root (listed in
`.gitignore`), named by a hash of its source and of the headers beside it
(`csrc/*.cuh`) so an edited kernel is never served from a stale build.
Nothing here runs at import time.  Two always-on counters
(`utils/profiling.add`) record the seconds of each nvcc build
(`build.nvcc`, only where the library was missing) and of each library's
load (`build.load`, once per library and process).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

from dlwpbench_tpu_torch.utils import profiling

_OPS_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_OPS_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_OPS_DIR)), "build", "cuda")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
# -split-compile=0: optimise the source's kernels on every host thread
# (the window source's ~300 template instances build in about half the time)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-split-compile=0", "-Xptxas", "-v",
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or NVCC_DEFAULT
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found on PATH or at {NVCC_DEFAULT}: the port's CUDA "
            "kernels are built from source at first use"
        )
    return path


def library_path(name: str) -> str:
    """Where `csrc/<name>.cu` is built: keyed by the hash of the source and
    of every header in `csrc/`."""
    digest = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, f"{name}.cu"),
                 *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless its build exists; returns the shared
    library's path.  Raises with nvcc's output on a failed build; on a
    good one keeps that output (ptxas's registers, shared memory and spills
    per kernel) beside the library as `<library>.log`."""
    lib = library_path(name)
    if os.path.exists(lib):
        return lib
    t0 = time.perf_counter()
    nvcc = _nvcc()
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib))
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {name}.cu:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    with open(lib[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    profiling.add("build.nvcc", time.perf_counter() - t0)
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load `csrc/<name>.cu`, once per process."""
    path = build(name)
    t0 = time.perf_counter()
    lib = ctypes.CDLL(path)
    profiling.add("build.load", time.perf_counter() - t0)
    return lib
