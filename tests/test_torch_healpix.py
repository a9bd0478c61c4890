"""The port's HEALPix grid, neighbour padding, remap and HEALPix data
against the JAX package's, on the CPU.

Inputs come from numpy seeds and go to both sides.  Tolerances:
- the index maps, the padding tables and the remap tables: none, equal
  (the same numpy on the same integers and float64 angles);
- `healpix_pad` and `healpix_pad_channels_last`: none, bit for bit in
  fp32 (each padded value is w0 * a + w1 * b with w in {0, 0.5, 1}: the
  products are exact, and so is the sum of two, in either order);
- `HEALPixRemap.{ll2hpx,hpx2ll}`: atol 1e-6 on fields of order 1 (a
  4-tap weighted sum in fp32, summed in another order by XLA and ATen);
- synthetic HEALPix batches and the zarr source on a HEALPix tree: none,
  bit for bit (the same numpy and native batcher on the same arrays).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlwpbench_tpu.data import sources as jsources
from dlwpbench_tpu.data.dataset import WindowedWeatherDataset as JDataset
from dlwpbench_tpu.data.dataset import synthetic_weatherbench as jsynthetic
from dlwpbench_tpu.grids import healpix as jhpx
from dlwpbench_tpu.grids import remap as jremap
from dlwpbench_tpu.ops import padding as jpad
from dlwpbench_tpu_torch import remap_healpix
from dlwpbench_tpu_torch.data import sources as tsources
from dlwpbench_tpu_torch.data import stats_tables, zarr_lite
from dlwpbench_tpu_torch.data.dataset import WindowedWeatherDataset as TDataset
from dlwpbench_tpu_torch.data.dataset import synthetic_weatherbench as tsynthetic
from dlwpbench_tpu_torch.grids import healpix as thpx
from dlwpbench_tpu_torch.grids import remap as tremap
from dlwpbench_tpu_torch.ops import padding as tpad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REMAP_TOL = 1e-6


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- the grid
@pytest.mark.parametrize("nside", [1, 2, 4, 8])
def test_index_maps_and_pad_tables_match_jax(nside):
    for fn in ("nest_to_fhw", "fhw_to_nest", "ring_to_nest", "nest_to_ring"):
        np.testing.assert_array_equal(getattr(thpx, fn)(nside), getattr(jhpx, fn)(nside), fn)
    pix = np.arange(thpx.npix(nside))
    for fn in ("nest_pix2ang", "ring_pix2ang"):
        for got, want in zip(getattr(thpx, fn)(nside, pix), getattr(jhpx, fn)(nside, pix)):
            np.testing.assert_array_equal(got, want, fn)
    for p in range(1, min(nside, 2) + 1):
        (ti, tw), (ji, jw) = thpx.build_pad_indices(nside, p), jhpx.build_pad_indices(nside, p)
        assert ti.dtype == ji.dtype == np.int32 and tw.dtype == jw.dtype == np.float32
        assert ti.shape == (12, nside + 2 * p, nside + 2 * p, 2)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tw, jw)
    with pytest.raises(ValueError, match="exceeds nside"):
        thpx.build_pad_indices(nside, nside + 1)


# ---------------------------------------------------------------- the padding
@pytest.mark.parametrize("nside, p", [(4, 1), (4, 2), (8, 1), (8, 2)])
def test_healpix_pad_matches_jax_bit_for_bit(nside, p):
    x = _randn(nside + p, 2, 3, 12, nside, nside)
    want = np.asarray(jpad.healpix_pad(jnp.asarray(x), p))
    got = tpad.healpix_pad(torch.from_numpy(x), p).numpy()
    assert got.shape == (2, 3, 12, nside + 2 * p, nside + 2 * p)
    np.testing.assert_array_equal(got, want)

    xc = np.ascontiguousarray(np.moveaxis(x, 1, -1))  # [B, 12, n, n, C]
    want_c = np.asarray(jpad.healpix_pad_channels_last(jnp.asarray(xc), p))
    got_c = tpad.healpix_pad_channels_last(torch.from_numpy(xc), p).numpy()
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_c, np.moveaxis(got, 1, -1))


def test_healpix_pad_checks_its_input():
    with pytest.raises(ValueError, match="12, n, n"):
        tpad.healpix_pad(torch.zeros(2, 11, 4, 4), 1)
    with pytest.raises(ValueError, match="12, n, n, C"):
        tpad.healpix_pad_channels_last(torch.zeros(2, 12, 4, 5, 3), 1)


# ---------------------------------------------------------------- the remap
@pytest.mark.parametrize("nlat, nlon, nside", [(8, 8, 8), (32, 64, 8), (16, 32, 4)])
def test_remap_tables_and_apply_match_jax(nlat, nlon, nside):
    for build, args in (("build_ll2hpx", (nlat, nlon, nside)),
                        ("build_hpx2ll", (nside, nlat, nlon))):
        t, j = getattr(tremap, build)(*args), getattr(jremap, build)(*args)
        np.testing.assert_array_equal(t.idx, j.idx)
        np.testing.assert_array_equal(t.w, j.w)
    trm, jrm = tremap.HEALPixRemap(nlat, nlon, nside), jremap.HEALPixRemap(nlat, nlon, nside)
    ll = _randn(nside, 2, 3, nlat, nlon)
    hp = _randn(nlat, 2, 3, 12, nside, nside)
    for name, x in (("ll2hpx", ll), ("hpx2ll", hp)):
        want = np.asarray(getattr(jrm, name)(jnp.asarray(x)))
        got = getattr(trm, name)(x)  # numpy in, numpy out
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=REMAP_TOL)
        got_t = getattr(trm, name)(torch.from_numpy(x))  # a tensor in, a tensor out
        assert isinstance(got_t, torch.Tensor)
        np.testing.assert_array_equal(got_t.numpy(), got)


def test_remap_cli_matches_jax_script(tmp_path):
    """`python -m dlwpbench_tpu_torch.remap_healpix` both ways, against
    `scripts/remap_healpix.py` on the same file."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import remap_healpix as jcli  # scripts/remap_healpix.py

    np.save(tmp_path / "ll.npy", _randn(0, 2, 16, 32))
    for side, main, dev in (("torch", remap_healpix.main, ["--device", "cpu"]),
                            ("jax", jcli.main, [])):
        main(["ll2hpx", str(tmp_path / "ll.npy"), str(tmp_path / f"{side}_hpx.npy"),
              "--nside", "4", *dev])
        main(["hpx2ll", str(tmp_path / f"{side}_hpx.npy"), str(tmp_path / f"{side}_ll.npy"),
              "--nlat", "16", "--nlon", "32", *dev])
    for name, shape in (("hpx", (2, 12, 4, 4)), ("ll", (2, 16, 32))):
        got, want = np.load(tmp_path / f"torch_{name}.npy"), np.load(tmp_path / f"jax_{name}.npy")
        assert got.shape == want.shape == shape
        np.testing.assert_allclose(got, want, rtol=0, atol=REMAP_TOL)


def test_remap_cli_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    """With no `--device` the CLI asks for CUDA and raises where there is
    none, rather than remapping on the host."""
    np.save(tmp_path / "ll.npy", _randn(0, 8, 16))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        remap_healpix.main(["ll2hpx", str(tmp_path / "ll.npy"), str(tmp_path / "hpx.npy")])
    assert not (tmp_path / "hpx.npy").exists()


@pytest.mark.parametrize("faces", [False, True])
def test_to_latlon_remaps_only_face_forecasts(faces):
    """`evaluation.evaluate.to_latlon`, which both `evaluate` and
    `build_baselines` call: a [S, T, C, 12, n, n] forecast and its
    [S, C, 12, n, n] inits go to the data's height x width with the JAX
    remap (atol 1e-6); lat-lon arrays come back as they were."""
    from dlwpbench_tpu_torch.evaluation.evaluate import to_latlon

    shapes = [(2, 3, 2, 12, 4, 4), (2, 2, 12, 4, 4)] if faces else [(2, 3, 2, 8, 16), (2, 2, 8, 16)]
    arrays = [_randn(i, *sh) for i, sh in enumerate(shapes)]
    got = to_latlon({"height": 8, "width": 16}, *arrays)
    assert len(got) == 2
    for g, a in zip(got, arrays):
        if not faces:
            assert g is a
            continue
        want = np.asarray(jremap.HEALPixRemap(8, 16, 4).hpx2ll(jnp.asarray(a)))
        assert g.shape == a.shape[:-3] + (8, 16)
        np.testing.assert_allclose(g, want, rtol=0, atol=REMAP_TOL)


# ---------------------------------------------------------------- the data
def _assert_batches_equal(tds, jds, batch_size, shuffle):
    tb = list(tds.batches(batch_size, shuffle=shuffle))
    jb = list(jds.batches(batch_size, shuffle=shuffle))
    assert len(tb) == len(jb) > 0
    for tbatch, jbatch in zip(tb, jb):
        for a, b in zip(tbatch, jbatch):
            assert (a is None) == (b is None)
            if b is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_synthetic_healpix_matches_jax():
    """`synthetic_weatherbench(healpix_nside=...)`, the `synthetic` source
    with `healpix_nside` (`configs/data/synthetic_hpx8.yaml`'s roles), and
    its shuffled, noisy training batches: [B, T, C, 12, n, n]."""
    arrays = [gen(n_time=20, healpix_nside=4, seed=5) for gen in (tsynthetic, jsynthetic)]
    for a, b in zip(*arrays):
        np.testing.assert_array_equal(a, b)
    assert arrays[0][2].shape == (21, 8, 12, 4, 4)

    d = dict(type="synthetic", n_time=128, height=4, width=4, healpix_nside=4,
             constant_channels=4, prescribed_channels=1, prognostic_channels=3, seed=0)
    cfgs = ({"sequence_length": 3, "noise": 0.1}, {"sequence_length": 3}, {"sequence_length": 3})
    tsplits, jsplits = tsources.build_datasets(d, *cfgs), jsources.build_datasets(d, *cfgs)
    for t, j in zip(tsplits[:3], jsplits[:3]):
        for role in ("constants", "prescribed", "prognostic"):
            np.testing.assert_array_equal(getattr(t, role), getattr(j, role))
        assert t.init_indices == j.init_indices
    _assert_batches_equal(tsplits[0], jsplits[0], 2, True)
    const, pres, prog, target = next(tsplits[0].batches(2))
    assert const.shape == (2, 1, 4, 12, 4, 4) and prog.shape == (2, 3, 3, 12, 4, 4)
    assert target.shape == (2, 2, 3, 12, 4, 4) and pres.shape == (2, 3, 1, 12, 4, 4)


def _write_hpx_store(root, nside=2, seed=3):
    """A HEALPix WeatherBench tree (`configs/data/full_hpx8.yaml`'s layout:
    arrays [time, (level,) face, height, width]) written with `zarr_lite`,
    6-hourly over 1979-1980."""
    rng = np.random.default_rng(seed)
    t = np.arange(np.datetime64("1979-01-01T05:00"), np.datetime64("1981-01-01"),
                  np.timedelta64(6, "h"))
    hours = ((t - np.datetime64("1979-01-01T00:00")) // np.timedelta64(1, "h")).astype(np.int64)
    attrs = {"units": "hours since 1979-01-01 00:00:00", "calendar": "proleptic_gregorian"}
    face = {"face": (("face",), np.arange(12)), "height": (("height",), np.arange(nside)),
            "width": (("width",), np.arange(nside))}
    coords = {"time": (("time",), hours, attrs), **face}
    spatial = ("face", "height", "width")
    for var, levels in (("t", [850]), ("t2m", None), ("z", [500, 1000]), ("tisr", None)):
        dirname = stats_tables.file_name_for(stats_tables.HALF_MANUAL, var)
        store = os.path.join(root, dirname, f"{var}_1979-1980_hpx{nside}.zarr")
        c = dict(coords)
        if levels:
            c["level"] = (("level",), np.asarray(levels, np.int64))
            dims, shape = ("time", "level", *spatial), (len(t), len(levels), 12, nside, nside)
        else:
            dims, shape = ("time", *spatial), (len(t), 12, nside, nside)
        data = (rng.standard_normal(shape) * 10 + 280).astype(np.float32)
        zarr_lite.write_dataset(store, {var: (dims, data)}, c)
    zarr_lite.write_dataset(
        os.path.join(root, "constants", f"constants_hpx{nside}.zarr"),
        {k: (spatial, rng.standard_normal((12, nside, nside)).astype(np.float32))
         for k in ("orography", "lsm", "lat2d", "lon2d")},
        face)


def test_zarr_healpix_tree_matches_jax(tmp_path):
    """The zarr source on a HEALPix tree: every split's arrays [T, C, 12,
    n, n], times, inits and statistics, and shuffled noisy batches, equal
    to the JAX source's."""
    _write_hpx_store(str(tmp_path))
    d = dict(type="WeatherBenchZarr", data_path=str(tmp_path), healpix_nside=2, height=2,
             width=2, timedelta=1, normalize=True, train_start_date="1979-01-01",
             train_stop_date="1979-12-31", val_start_date="1980-01-01",
             val_stop_date="1980-06-30", test_start_date="1980-07-01",
             test_stop_date="1980-12-31", constant_names=["orography", "lsm", "lat2d", "lon2d"],
             prescribed_variable_names=["tisr"],
             prognostic_variable_names_and_levels={"t": [850], "t2m": [], "z": [500, 1000]})
    cfgs = ({"sequence_length": 3, "noise": 0.1}, {"sequence_length": 3}, {"sequence_length": 5})
    *tsplits, tstats = tsources.build_datasets(d, *cfgs)
    *jsplits, jstats = jsources.build_datasets(d, *cfgs)
    assert {k: (v.mean, v.std) for k, v in tstats.items()} == {
        k: (v.mean, v.std) for k, v in jstats.items()}
    for t, j in zip(tsplits, jsplits):
        for role in ("constants", "prescribed", "prognostic", "times"):
            np.testing.assert_array_equal(getattr(t, role), getattr(j, role))
        assert t.init_indices == j.init_indices
    assert tsplits[0].prognostic.shape[1:] == (4, 12, 2, 2)
    assert tsplits[0].constants.shape == (1, 4, 12, 2, 2)
    assert tsplits[2].init_indices
    _assert_batches_equal(tsplits[0], jsplits[0], 8, True)


def test_windowed_dataset_keeps_faces():
    """A dataset built by hand from [T, C, 12, n, n] fields batches them as
    the JAX one does, windows past the data end included."""
    prog, const = _randn(1, 12, 2, 12, 2, 2), _randn(2, 3, 12, 2, 2)
    kw = dict(prognostic=prog, constants=const, sequence_length=4, init_indices=[0, 6, 9])
    _assert_batches_equal(TDataset(**kw), JDataset(**kw), 2, False)
