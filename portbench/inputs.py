"""The general generator: a cell's inputs from its seed and its traffic file.

Fields shaped like the configuration's data (WeatherBench 5.625 deg:
32 x 64, 4 constant, 1 prescribed and 8 prognostic channels) are drawn on
the device in a few large calls from a generator seeded by the run's seed:
spatially smoothed normal noise, the prognostic channels an AR(1) series
in time (unit variance, lag-one correlation 0.9), the prescribed ones
fresh noise each frame, the constants one frame.  They go to the host once
and into the program's own `WindowedWeatherDataset`: the windows every
seed sees are the same in number and size, only their values and their
shuffled order differ.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

AR_COEFF = 0.9


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (`tag`) of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


def _smooth(x: torch.Tensor) -> torch.Tensor:
    """A 3-point box filter along each of the two grid dims (periodic),
    rescaled to unit variance."""
    for dim in (-2, -1):
        x = (x + torch.roll(x, 1, dim) + torch.roll(x, -1, dim)) / 3.0
    return x * 3.0


def fields(data: dict, frames: int, seed: int, device) -> tuple:
    """(constants [Cc, H, W], prescribed [T, Cp, H, W], prognostic
    [T, Cq, H, W]) numpy float32 arrays of `frames` frames."""
    g = generator(seed, "fields", device)
    H, W = int(data["height"]), int(data["width"])
    cc, cp, cq = (int(data[k]) for k in ("constant_channels", "prescribed_channels",
                                         "prognostic_channels"))
    noise = _smooth(torch.randn(frames + 1, cq + cp + cc, H, W, generator=g, device=device))
    prog = torch.empty(frames, cq, H, W, device=device)
    prog[0] = noise[0, :cq]
    b = (1.0 - AR_COEFF**2) ** 0.5
    for t in range(1, frames):
        torch.add(prog[t - 1] * AR_COEFF, noise[t, :cq], alpha=b, out=prog[t])
    pres = noise[:frames, cq:cq + cp]
    const = noise[frames, cq + cp:]
    return tuple(None if x.shape[-3] == 0 else x.cpu().numpy() for x in (const, pres, prog))


def windowed(data: dict, sequence_length: int, windows: int, seed: int, device, context_size: int):
    """The program's `WindowedWeatherDataset` holding exactly `windows`
    non-overlapping windows of `sequence_length` frames (plus the target
    frame), its shuffle order seeded by the run's seed."""
    from dlwpbench_tpu_torch.data.dataset import WindowedWeatherDataset

    const, pres, prog = fields(data, (windows + 1) * sequence_length, seed, device)
    ds = WindowedWeatherDataset(prognostic=prog, constants=const, prescribed=pres,
                                sequence_length=sequence_length, context_size=context_size,
                                noise=0.0, seed=subseed(seed, "order"))
    if len(ds) != windows:
        raise RuntimeError(f"{len(ds)} windows, expected {windows}")
    return ds


def host_batch_to(batch, device) -> tuple:
    return tuple(None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in batch)
