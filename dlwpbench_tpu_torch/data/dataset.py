"""Dataset layer: WeatherBench-style windowed sequences (numpy, host side).

The port's copy of `dlwpbench_tpu/data/dataset.py`: the same item
semantics (reference `data/datasets/datasets.py`):

- per-variable z-score statistics (`VariableStats`, `compute_stats`);
- variable roles: constants [1, Cc, H, W], prescribed [T, Cp, H, W],
  prognostic [T, Cq, H, W] (+1 frame for the target), with a face dim
  before H, W on HEALPix ([T, C, 12, n, n]);
- non-overlapping windows of `sequence_length` starting at
  `item * sequence_length`, or explicit init indices;
- `target = prognostic[1:]`, returned from `context_size` on;
- input noise on the prognostic inputs;
- per-frame valid `times` where the source has a calendar,
  `target_frame_indices` and `compute_statistics`;
- the biweekly Monday/Thursday 11:00 UTC init-date rule.

`batches` gathers a batch's windows with the native C++ batcher
(`data/native.py`, `src/native/window_batcher.cpp`) and adds its fused
noise, as the JAX package does, so batches (noise included) equal the JAX
package's bit for bit; windows past the data end take the per-item numpy
path (zero fill).  The evaluator and the trainer move each batch to the
device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np


@dataclasses.dataclass
class VariableStats:
    mean: float
    std: float

    def normalize(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean) / self.std


def compute_stats(arr: np.ndarray) -> VariableStats:
    return VariableStats(float(np.nanmean(arr)), float(np.nanstd(arr)) or 1.0)


@dataclasses.dataclass
class WindowedWeatherDataset:
    """In-memory windowed dataset with the reference's item semantics.

    Args:
      prognostic: [T, Cq, H, W].
      constants: [Cc, H, W] or None.
      prescribed: [T, Cp, H, W] or None (already time-ordered).
      sequence_length: steps per item (seq inputs + 1 extra target frame).
      context_size: teacher-forcing context (targets returned from there on).
      noise: stddev of Gaussian noise added to prognostic inputs.
      init_indices: optional explicit window start indices.
    """

    prognostic: np.ndarray
    constants: np.ndarray | None = None
    prescribed: np.ndarray | None = None
    sequence_length: int = 15
    context_size: int = 1
    noise: float = 0.0
    init_indices: Sequence[int] | None = None
    seed: int = 0
    # per-frame datetime64 valid times (len == prognostic frames), from
    # sources with a real calendar: the monthly climatology stratifies by
    # them; not part of the batch tuple
    times: np.ndarray | None = None

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        if self.prognostic.ndim < 4:
            raise ValueError(f"prognostic must be [T, C, H, W], got {self.prognostic.shape}")
        if self.constants is not None and self.constants.ndim == self.prognostic.ndim - 1:
            self.constants = self.constants[None]  # [1, Cc, ...]

    def __len__(self) -> int:
        if self.init_indices is None:
            return max(
                0,
                (self.prognostic.shape[0] - self.sequence_length)
                // self.sequence_length,
            )
        return len(self.init_indices)

    def window_start(self, item: int) -> int:
        """Frame index where window `item` begins."""
        if self.init_indices is None:
            return item * self.sequence_length
        return int(self.init_indices[item])

    def target_frame_indices(self, item: int) -> np.ndarray:
        """Frame indices of the target steps `item` yields, clamped to the
        data end for zero-filled long rollouts (consumers index `times`
        with these)."""
        start = self.window_start(item)
        idx = np.arange(start + 1 + self.context_size, start + self.sequence_length + 1)
        return np.minimum(idx, self.prognostic.shape[0] - 1)

    def __getitem__(self, item: int):
        start = self.window_start(item)
        seq = self.sequence_length

        pres = (
            None
            if self.prescribed is None
            else self.prescribed[start : start + seq]
        )
        if pres is not None and pres.shape[0] < seq:
            # long rollouts past the data end: repeat the last forcing frame
            if pres.shape[0] == 0:
                pres = np.zeros((seq, *self.prescribed.shape[1:]), np.float32)
            else:
                reps = np.repeat(pres[-1:], seq - pres.shape[0], axis=0)
                pres = np.concatenate([pres, reps], axis=0)
        prog_full = self.prognostic[start : start + seq + 1]
        if prog_full.shape[0] < seq + 1:  # long rollouts past data end
            fill = np.zeros(
                (seq + 1 - prog_full.shape[0], *prog_full.shape[1:]), np.float32
            )
            prog_full = np.concatenate([prog_full, fill], axis=0)

        target = prog_full[1:]
        prog = prog_full[:-1]
        if self.noise:
            prog = prog + np.float32(
                self._rng.standard_normal(prog.shape) * self.noise
            )
        return self.constants, pres, prog.astype(np.float32), target[
            self.context_size :
        ].astype(np.float32)

    def compute_statistics(self) -> dict:
        """Per-channel mean/std/min/max over the split (reference
        `datasets.py:419-453`)."""
        out = {}
        for role, arr in (("prognostic", self.prognostic), ("prescribed", self.prescribed),
                          ("constants", self.constants)):
            if arr is None:
                continue
            c_axis = 1 if arr.ndim >= 4 else 0
            axes = tuple(i for i in range(arr.ndim) if i != c_axis)
            out[role] = {
                "mean": np.nanmean(arr, axis=axes).tolist(),
                "std": np.nanstd(arr, axis=axes).tolist(),
                "min": np.nanmin(arr, axis=axes).tolist(),
                "max": np.nanmax(arr, axis=axes).tolist(),
            }
        return out

    def batches(self, batch_size: int, shuffle: bool = False, drop_last: bool = False,
                host_id: int = 0, n_hosts: int = 1, epoch: int | None = None) -> Iterator[tuple]:
        """Yield (constants, prescribed, prognostic, target) numpy arrays
        with a leading batch dim (the last batch may be short unless
        `drop_last`).

        `shuffle` permutes the windows with the dataset's own generator
        (`np.random.default_rng(seed)`); each native batch with noise then
        draws its noise seed from the same generator, so epoch after epoch
        the order and the noise match the JAX package's.

        Multi-host sharding (JAX `dataset.py:176-227`): with `n_hosts > 1`
        every host builds the SAME epoch permutation, seeded by (seed,
        epoch) alone (so `epoch` is required when shuffling), and host h
        takes the strided slice order[h::n_hosts], truncated so that all
        hosts yield equally many windows.  The union of the hosts' windows
        is the single-host epoch; the shards are disjoint."""
        order = np.arange(len(self))
        if shuffle:
            if n_hosts > 1:
                if epoch is None:
                    raise ValueError(
                        "multi-host shuffling needs `epoch` so every host "
                        "derives the same permutation"
                    )
                np.random.default_rng((self.seed, int(epoch))).shuffle(order)
            else:
                self._rng.shuffle(order)
        if n_hosts > 1:
            if not 0 <= host_id < n_hosts:
                raise ValueError(f"host_id {host_id} not in [0, {n_hosts})")
            usable = len(order) - len(order) % n_hosts  # hosts in lockstep
            order = order[host_id:usable:n_hosts]
        stop = len(order) - len(order) % batch_size if drop_last else len(order)
        for i in range(0, stop, batch_size):
            idxs = order[i : i + batch_size]
            starts = np.asarray([self.window_start(j) for j in idxs], np.int64)
            if (starts + self.sequence_length + 1 > self.prognostic.shape[0]).any():
                yield self._batch_items(idxs)  # zero-fill past the data end
            else:
                yield self._batch_native(starts)

    def _batch_items(self, idxs: np.ndarray) -> tuple:
        """A batch stacked item by item in numpy."""
        items = [self[j] for j in idxs]
        const = None if items[0][0] is None else np.stack([it[0] for it in items])
        pres = None if items[0][1] is None else np.stack([it[1] for it in items])
        return const, pres, np.stack([it[2] for it in items]), np.stack([it[3] for it in items])

    def _batch_native(self, starts: np.ndarray) -> tuple:
        """A batch of the windows at `starts` (all inside the data),
        gathered by the native batcher, with its fused noise seeded from the
        dataset's generator."""
        from dlwpbench_tpu_torch.data import native

        seq = self.sequence_length
        prog_full = native.assemble_windows(self.prognostic, starts, seq + 1)
        target = prog_full[:, 1:]
        prog = np.ascontiguousarray(prog_full[:, :-1])
        if self.noise:
            native.add_gaussian_noise(prog, float(self.noise), int(self._rng.integers(2**62)))
        pres = (
            None if self.prescribed is None
            else native.assemble_windows(self.prescribed, starts, seq)
        )
        const = (
            None if self.constants is None
            else np.broadcast_to(self.constants[None], (len(starts), *self.constants.shape)).copy()
        )
        return const, pres, prog, np.ascontiguousarray(target[:, self.context_size :])


def biweekly_init_indices(
    times: np.ndarray, start: np.datetime64, stop: np.datetime64
) -> np.ndarray:
    """Indices of biweekly Monday/Thursday 11:00 UTC inits in `times`
    (reference `datasets.py:457-479`), in numpy datetime arithmetic."""
    t = np.asarray(times, dtype="datetime64[h]")
    days = t.astype("datetime64[D]").astype(np.int64)
    weekday = (days + 3) % 7  # 1970-01-01 was a Thursday; Monday = 0
    hour = (t - t.astype("datetime64[D]")).astype(np.int64)
    sel = (
        (t >= np.datetime64(start, "h"))
        & (t <= np.datetime64(stop, "h"))
        & np.isin(weekday, (0, 3))
        & (hour == 11)
    )
    return np.nonzero(sel)[0]


def synthetic_weatherbench(
    n_time: int = 64,
    nlat: int = 32,
    nlon: int = 64,
    n_prognostic: int = 8,
    n_prescribed: int = 1,
    n_constants: int = 4,
    healpix_nside: int | None = None,
    seed: int = 0,
):
    """Deterministic synthetic ERA5-like arrays for tests and benchmarks.

    Smooth space-time random fields shaped like the WeatherBench
    5.625-degree data, or on the 12 HEALPix faces of `healpix_nside`:
    returns (constants [Cc,(F),H,W] | None, prescribed [T,Cp,...] | None,
    prognostic [T,Cq,...]), the spatial dims (12, nside, nside) on
    HEALPix, else (nlat, nlon).  The same seed gives the same arrays as
    the JAX package's generator.
    """
    rng = np.random.default_rng(seed)
    spatial = (12, healpix_nside, healpix_nside) if healpix_nside else (nlat, nlon)

    def smooth_field(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        # cheap spatial smoothing for realism (separable box filter)
        for ax in range(len(shape) - len(spatial), len(shape)):
            x = (x + np.roll(x, 1, ax) + np.roll(x, -1, ax)) / 3.0
        return x

    prog = np.cumsum(
        0.1 * smooth_field((n_time + 1, n_prognostic, *spatial)), axis=0
    ).astype(np.float32)
    pres = (
        smooth_field((n_time + 1, n_prescribed, *spatial)) if n_prescribed else None
    )
    const = smooth_field((n_constants, *spatial)) if n_constants else None
    return const, pres, prog
