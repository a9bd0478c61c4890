"""The port's WeatherBench zarr path against the JAX package's, on the CPU.

- `zarr_lite` reads every array of the committed fixture
  (`tests/fixtures/wb_zarr`) as the JAX reader does, and its writer,
  missing-chunk fill, corrupt-chunk error and CF time decoding behave
  alike;
- the port's native libraries (`data/native.py`, built from
  `src/native/*.cpp` into `build/native/`) compute what the JAX package's
  loader computes;
- `build_datasets` with `type: WeatherBenchZarr` gives every split's
  arrays, times, init indices and statistics of the JAX source;
- batches, shuffled and with input noise, equal the JAX package's for
  two epochs.

Tolerance: none anywhere.  The data path moves and normalises the same
float32 values in the same order on both sides, so every comparison is
bit for bit (`assert_array_equal`).
"""

import glob
import os
import zlib

import numpy as np
import pytest

from dlwpbench_tpu.data import native as jnative
from dlwpbench_tpu.data import sources as jsources
from dlwpbench_tpu.data import zarr_lite as jzarr
from dlwpbench_tpu.data.dataset import WindowedWeatherDataset as JDataset
from dlwpbench_tpu_torch.data import native as tnative
from dlwpbench_tpu_torch.data import sources as tsources
from dlwpbench_tpu_torch.data import zarr_lite as tzarr
from dlwpbench_tpu_torch.data.dataset import WindowedWeatherDataset as TDataset

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "wb_zarr")
FIXTURE_ARRAYS = sorted(
    os.path.relpath(os.path.dirname(p), FIXTURE)
    for p in glob.glob(os.path.join(FIXTURE, "**", ".zarray"), recursive=True)
)


def _wb_cfg(**over):
    """The JAX zarr tests' fixture config (`tests/test_zarr.py:89-108`)."""
    cfg = {
        "type": "WeatherBenchZarr",
        "data_path": FIXTURE,
        "train_start_date": "1979-01-01",
        "train_stop_date": "1979-01-07",
        "val_start_date": "1979-01-08",
        "val_stop_date": "1979-01-10",
        "test_start_date": "1980-01-01",
        "test_stop_date": "1980-01-08",
        "timedelta": 1,
        "normalize": True,
        "constant_names": ["orography", "lsm", "lat2d", "lon2d"],
        "prescribed_variable_names": ["tisr"],
        "prognostic_variable_names_and_levels": {
            "msl": [], "stream250": [], "z": [300, 500],
        },
    }
    cfg.update(over)
    return cfg


def _build(mod, data_cfg, train_seq=4, noise=0.0, test_seq=6):
    return mod.build_datasets(data_cfg, {"sequence_length": train_seq, "noise": noise},
                              {"sequence_length": 4}, {"sequence_length": test_seq},
                              context_size=1)


# ---------------------------------------------------------------- zarr_lite
def test_fixture_has_arrays():
    assert len(FIXTURE_ARRAYS) >= 30


@pytest.mark.parametrize("rel", FIXTURE_ARRAYS)
def test_reads_fixture_array_as_jax(rel):
    got, want = tzarr.ZarrArray.open(os.path.join(FIXTURE, rel)), jzarr.ZarrArray.open(
        os.path.join(FIXTURE, rel))
    assert got.dims == want.dims and got.attrs == want.attrs
    a, b = got.read(), want.read()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    if rel.endswith(os.sep + "time"):
        np.testing.assert_array_equal(tzarr.read_time_coord(got), jzarr.read_time_coord(want))


@pytest.mark.parametrize("dtype", ["<f4", "<f8", "<i8"])
@pytest.mark.parametrize("compressor", ["default", None, {"id": "zlib", "level": 1}])
def test_writer_round_trip(tmp_path, dtype, compressor):
    data = (100 * np.random.default_rng(0).standard_normal((5, 7, 11))).astype(dtype)
    p = str(tmp_path / "arr")
    tzarr.write_array(p, data, dims=("a", "b", "c"), chunks=(2, 3, 11), compressor=compressor)
    for reader in (tzarr, jzarr):
        arr = reader.ZarrArray.open(p)
        assert arr.dims == ("a", "b", "c") and arr.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(arr.read(), data)


def test_group_round_trip_reads_in_jax(tmp_path):
    p = str(tmp_path / "ds")
    data = np.random.default_rng(1).standard_normal((6, 4, 8)).astype("<f4")
    tzarr.write_dataset(
        p, {"msl": (("time", "lat", "lon"), data)},
        {"time": (("time",), np.arange(6, dtype="int64"), {"units": "hours since 1979-01-01"}),
         "lat": (("lat",), np.linspace(-80, 80, 4))},
    )
    for reader in (tzarr, jzarr):
        g = reader.ZarrGroup.open(p)
        assert g.array_keys() == ["lat", "msl", "time"]
        np.testing.assert_array_equal(g["msl"].read(), data)
        assert reader.read_time_coord(g["time"])[3] == np.datetime64("1979-01-01T03:00:00")


def test_missing_chunk_reads_fill_value(tmp_path):
    p = str(tmp_path / "holes")
    tzarr.write_array(p, np.ones((4, 4), np.float32), dims=("a", "b"), chunks=(2, 2))
    os.remove(os.path.join(p, "1.1"))
    out = tzarr.ZarrArray.open(p).read()
    assert out[2:, 2:].sum() == 0.0 and out[:2].sum() == 8.0
    np.testing.assert_array_equal(out, jzarr.ZarrArray.open(p).read())


@pytest.mark.parametrize("chunks, chunk, error, match", [
    ((4, 4), "0.1", ValueError, "corrupt or truncated"),  # several chunks: the native decoder
    ((8, 8), "0.0", zlib.error, "incomplete or truncated"),  # one chunk: stdlib zlib
])
def test_corrupt_chunk_raises(tmp_path, chunks, chunk, error, match):
    p = str(tmp_path / "bad")
    tzarr.write_array(p, np.ones((8, 8), np.float32), dims=("a", "b"), chunks=chunks)
    with open(os.path.join(p, chunk), "r+b") as f:
        f.truncate(3)
    for reader in (tzarr, jzarr):
        with pytest.raises(error, match=match):
            reader.ZarrArray.open(p).read()


@pytest.mark.parametrize("values, units", [
    ([0, 6, 30], "hours since 1979-01-01 00:00:00"),
    ([1], "days since 2000-01-01"),
    ([0, 500, 1500], "milliseconds since 1979-01-01"),
    ([1], "days since 2000-01-01 06:00:00"),
    ([-3, 7], "minutes since 1999-12-31 23:00"),
])
def test_cf_time_decodes_as_jax(values, units):
    got = tzarr.decode_cf_time(np.array(values), units)
    np.testing.assert_array_equal(got, jzarr.decode_cf_time(np.array(values), units))
    if units.startswith("hours"):
        assert got[2] == np.datetime64("1979-01-02T06:00:00")
    with pytest.raises(ValueError):
        tzarr.decode_cf_time(np.array([1]), "fortnights since 2000-01-01")


# ---------------------------------------------------------------- native libraries
def test_native_builds_into_build_dir_only():
    for name in ("window_batcher", "zarr_decoder"):
        lib = tnative.build(name)
        assert os.path.dirname(lib) == tnative.BUILD_DIR and os.path.exists(lib)
        assert not lib.startswith(tnative.SRC_DIR)
        assert lib == tnative.library_path(name)


def test_native_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "window_batcher.cpp").write_text("this is not C++ at all;\n")
    monkeypatch.setattr(tnative, "SRC_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for window_batcher.cpp") as err:
        tnative.build("window_batcher")
    assert "error" in str(err.value)
    assert os.listdir(tmp_path / "build") == []  # the temp file is gone


@pytest.mark.parametrize("shape, starts, seq", [
    ((40, 3, 4, 5), [0, 7, 35, 12], 5), ((9, 2), [8, 0], 1), ((30, 1, 2, 2), [], 4),
])
def test_assemble_windows_matches_jax(shape, starts, seq):
    assert jnative.available()
    data = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    starts = np.asarray(starts, np.int64)
    got = tnative.assemble_windows(data, starts, seq)
    np.testing.assert_array_equal(got, jnative.assemble_windows(data, starts, seq))
    for b, s in enumerate(starts):
        np.testing.assert_array_equal(got[b], data[s : s + seq])


def test_assemble_windows_bounds_checked():
    data = np.zeros((10, 3), np.float32)
    for starts in ([0, 6], [-1]):
        with pytest.raises(ValueError, match="out of bounds"):
            tnative.assemble_windows(data, np.asarray(starts), 5)


@pytest.mark.parametrize("n, std, seed", [(1, 0.1, 3), (4097, 0.1, 2**62 - 1), (1000, 2.5, 0)])
def test_gaussian_noise_matches_jax(n, std, seed):
    base = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got, want = base.copy(), base.copy()
    tnative.add_gaussian_noise(got, std, seed)
    jnative.add_gaussian_noise(want, std, seed)
    np.testing.assert_array_equal(got, want)
    assert n < 2 or not np.array_equal(got, base)
    with pytest.raises(ValueError):
        tnative.add_gaussian_noise(base.astype(np.float64), std, seed)


@pytest.mark.parametrize("compressor", ["default", None])
def test_decode_chunks_matches_jax(tmp_path, compressor):
    data = np.random.default_rng(5).standard_normal((50, 7, 9)).astype(np.float32)
    p = str(tmp_path / "arr")
    tzarr.write_array(p, data, dims=("t", "y", "x"), chunks=(16, 4, 9), compressor=compressor)
    os.remove(os.path.join(p, "1.0.0"))  # a hole: fill value
    paths = sorted(glob.glob(os.path.join(p, "[0-9]*")))
    paths.insert(2, os.path.join(p, "1.0.0"))
    nbytes = 16 * 4 * 9 * 4
    arena, ok = tnative.decode_chunks(paths, compressed=compressor is not None,
                                      chunk_nbytes=nbytes)
    jarena, jok = jnative.decode_chunks(paths, compressed=compressor is not None,
                                        chunk_nbytes=nbytes)
    np.testing.assert_array_equal(ok, jok)
    assert not ok[2] and ok.sum() == len(paths) - 1
    np.testing.assert_array_equal(arena[ok], jarena[jok])
    out = tzarr.ZarrArray.open(p).read()  # the native decoder, several chunks
    np.testing.assert_array_equal(out, jzarr.ZarrArray.open(p).read())
    assert out[16:32, :4].sum() == 0.0
    np.testing.assert_array_equal(out[:16], data[:16])


# ---------------------------------------------------------------- the source
SOURCE_CASES = {
    "default": {},
    "timedelta2": {"timedelta": 2},
    "downscale2": {"downscale_factor": 2},
    "start1940": {"train_start_date": "1940-01-01"},  # FULL_MANUAL
}


def _stats_dict(stats):
    return {k: (v.mean, v.std) for k, v in stats.items()}


@pytest.mark.parametrize("case", sorted(SOURCE_CASES))
def test_build_datasets_matches_jax(case):
    cfg = _wb_cfg(**SOURCE_CASES[case])
    *tsplits, tstats = _build(tsources, cfg)
    *jsplits, jstats = _build(jsources, cfg)
    assert list(tstats) == list(jstats) and _stats_dict(tstats) == _stats_dict(jstats)
    for t, j in zip(tsplits, jsplits):
        for role in ("constants", "prescribed", "prognostic", "times"):
            a, b = getattr(t, role), getattr(j, role)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert t.init_indices == j.init_indices and len(t) == len(j)
        assert (t.sequence_length, t.noise, t.seed) == (j.sequence_length, j.noise, j.seed)
        assert t.compute_statistics() == j.compute_statistics()
        for item in range(len(t)):
            np.testing.assert_array_equal(t.target_frame_indices(item),
                                          j.target_frame_indices(item))
    if case == "downscale2":
        assert tsplits[0].prognostic.shape[-2:] == (4, 8)


def test_missing_data_path_raises():
    with pytest.raises(FileNotFoundError):
        _build(tsources, _wb_cfg(data_path="/nonexistent"))


def _assert_batches_equal(tds, jds, batch_size, shuffle, epochs):
    for _ in range(epochs):
        tb, jb = list(tds.batches(batch_size, shuffle=shuffle)), list(
            jds.batches(batch_size, shuffle=shuffle))
        assert len(tb) == len(jb) > 0
        for tbatch, jbatch in zip(tb, jb):
            for a, b in zip(tbatch, jbatch):
                if b is None:
                    assert a is None
                    continue
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_noisy_shuffled_batches_match_jax_on_fixture():
    """Two epochs of shuffled training batches with input noise: the
    native batcher's fused noise, seeded from the dataset's generator
    after the shuffle, as the JAX package draws it."""
    cfg = _wb_cfg()
    tds = _build(tsources, cfg, train_seq=2, noise=0.1)[0]
    jds = _build(jsources, cfg, train_seq=2, noise=0.1)[0]
    assert len(tds) > 8
    _assert_batches_equal(tds, jds, 4, True, 2)


def test_noisy_shuffled_batches_match_jax_on_synthetic():
    """noise 0.1, seed 1, batch 8, shuffled, on a synthetic 8x16 set: the
    per-item numpy noise of the port's earlier batcher gave other inputs
    (max|diff| 0.577 in the first batch)."""
    from dlwpbench_tpu_torch.data.dataset import synthetic_weatherbench

    const, pres, prog = synthetic_weatherbench(n_time=200, nlat=8, nlon=16, seed=3)
    kw = dict(prognostic=prog, constants=const, prescribed=pres, sequence_length=3,
              noise=0.1, seed=1)
    _assert_batches_equal(TDataset(**kw), JDataset(**kw), 8, True, 2)


def test_windows_past_the_data_end_match_jax():
    """A test split whose longest windows run past the data end: those
    batches take the per-item path (zero fill, the last forcing frame
    repeated), the rest the native one."""
    cfg = _wb_cfg()
    tds = _build(tsources, cfg, test_seq=6)[2]
    jds = _build(jsources, cfg, test_seq=6)[2]
    for ds in (tds, jds):
        ds.sequence_length = 12
        ds.init_indices = [0, 10, 25, 28, 3]
    assert tds.prognostic.shape[0] == 32  # 25 and 28 run past the end
    _assert_batches_equal(tds, jds, 2, False, 1)
