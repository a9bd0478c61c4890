"""The port's data tools against the JAX package's: `data/preprocessing.py`
(`Preprocessor`, `temporal_power_spectrum`, `regrid_linear`,
`resample_mean`, `zonal_wave_analysis`) equal to
`dlwpbench_tpu/data/preprocessing.py` bit for bit on the cases of
`tests/test_aux.py`, the entry points `nc_to_zarr` and `ec46_regrid`
writing the same zarr trees as `scripts/nc_to_zarr.py` and
`scripts/ec46_regrid.py` on netCDF3 files the test writes, `climatology`
as the alias of `build_baselines`, and `utils/profiling.py`'s StepTimer
and trace.
"""

import os

import numpy as np
import pytest
import torch

from dlwpbench_tpu.data import preprocessing as JP
from dlwpbench_tpu_torch.data import preprocessing as TP


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def _daily(T, seed, shape=(4, 8)):
    times = np.datetime64("2000-01-01") + np.arange(T) * np.timedelta64(1, "D")
    rng = np.random.default_rng(seed)
    doy = (times - times.astype("datetime64[Y]")).astype(int)
    data = (0.01 * np.arange(T).reshape(-1, *[1] * len(shape))
            + np.sin(2 * np.pi * doy / 365.25).reshape(-1, *[1] * len(shape))
            + 0.1 * rng.standard_normal((T, *shape)))
    return data, times


PREPROCESSORS = {
    "linear": dict(detrend="linear", subtract_climatology=False),
    "linear_clim": dict(detrend="linear", rolling_window_size=25),
    "poly": dict(detrend="polynomial", poly_degree=3, rolling_window_size=None),
    "clim_only": dict(detrend=None, rolling_window_size=None),
}


@pytest.mark.parametrize("case", list(PREPROCESSORS))
def test_preprocessor_equals_jax(case):
    data, times = _daily(800, len(case))
    kw = PREPROCESSORS[case]
    j, t = JP.Preprocessor(**kw).fit(data, times), TP.Preprocessor(**kw).fit(data, times)
    anom_j, anom_t = j.transform(data, times), t.transform(data, times)
    _equal(anom_t, anom_j)
    _equal(t.inverse_transform(anom_t, times), j.inverse_transform(anom_j, times))
    _equal(TP.Preprocessor(**kw).fit_transform(data, times),
           JP.Preprocessor(**kw).fit_transform(data, times))
    if kw["detrend"]:
        _equal(t.trend, j.trend)
        _equal(t.get_trend_timeseries(50), j.get_trend_timeseries(50))
    if kw.get("subtract_climatology", True):
        _equal(t.climatology, j.climatology)


def test_linear_detrend_roundtrip():
    T = 400
    times = np.arange("2000-01-01", "2001-02-04", dtype="datetime64[D]")[:T]
    rng = np.random.default_rng(0)
    data = 0.01 * np.arange(T)[:, None, None] + rng.standard_normal((T, 4, 8)) * 0.1
    pp = TP.Preprocessor(detrend="linear", subtract_climatology=False).fit(data, times)
    anom = pp.transform(data, times)
    slope = np.polyfit(np.arange(T), anom.reshape(T, -1).mean(1), 1)[0]
    assert abs(slope) < 1e-4
    np.testing.assert_allclose(pp.inverse_transform(anom, times), data, atol=1e-4)
    with pytest.raises(ValueError, match="detrend"):
        TP.Preprocessor(detrend="cubic")


def test_spectrum_equals_jax():
    t = np.arange(256)
    sig = np.stack([np.sin(2 * np.pi * t / 16), np.cos(2 * np.pi * t / 7)], -1)
    f, p = TP.temporal_power_spectrum(sig, dt_hours=6.0)
    _equal((f, p), JP.temporal_power_spectrum(sig, dt_hours=6.0))
    assert p.shape == f.shape


@pytest.mark.parametrize("case", ["identity", "downscale", "upscale"])
def test_regrid_linear_equals_jax(case):
    grids = {"identity": ((16, 32), (16, 32)), "downscale": ((64, 128), (32, 64)),
             "upscale": ((8, 16), (32, 64))}
    (h1, w1), (h2, w2) = grids[case]
    lats1, lons1 = np.linspace(-89, 89, h1), np.linspace(0, 360, w1, endpoint=False)
    lats2, lons2 = np.linspace(-87, 87, h2), np.linspace(0, 360, w2, endpoint=False)
    if case == "identity":
        lats2, lons2 = lats1, lons1
    x = np.random.default_rng(h1).standard_normal((3, h1, w1)).astype(np.float32)
    got = TP.regrid_linear(x, lats1, lons1, lats2, lons2)
    _equal(got, JP.regrid_linear(x, lats1, lons1, lats2, lons2))
    if case == "identity":
        np.testing.assert_allclose(got, x, atol=1e-6)


def _waves(days=120, H=8, W=16):
    """`tests/test_aux.py`'s field: a wavenumber-3 wave of random amplitude
    in the 40-50N band plus a linear trend, 6-hourly."""
    times = np.datetime64("2015-01-01T00") + np.arange(days * 4) * np.timedelta64(6, "h")
    lats = np.linspace(-70, 70, H)
    lons = np.arange(W) * (360.0 / W)
    t = np.arange(len(times), dtype=float)
    amp = 5.0 * (1 + np.random.default_rng(0).standard_normal(len(times)))
    field = (amp[:, None, None] * np.sin(3 * np.deg2rad(lons))[None, None, :]
             * np.exp(-((lats[:, None] - 45.0) / 8.0) ** 2)[None] + 0.01 * t[:, None, None])
    return field.astype(np.float32), times, lats


@pytest.mark.parametrize("freq", ["D", "W"])
def test_resample_mean_equals_jax(freq):
    data, times, _ = _waves(days=400)
    got = TP.resample_mean(data, times, freq=freq)
    _equal(got, JP.resample_mean(data, times, freq=freq))
    if freq == "W":
        assert 56 <= len(got[1]) <= 59


@pytest.mark.parametrize("kw", [dict(freq="D", lat_band=(40, 50)),
                                dict(freq="W", lat_band=(30, 60)),
                                dict(freq="D", winter_mask=True, lat_band=(40, 50))],
                         ids=["daily", "weekly", "winter"])
def test_zonal_wave_analysis_equals_jax(kw):
    data, times, lats = _waves(days=400 if kw["freq"] == "W" or "winter_mask" in kw else 120)
    got = TP.zonal_wave_analysis(data, times, lats, **kw)
    _equal(got, JP.zonal_wave_analysis(data, times, lats, **kw))
    if kw == dict(freq="D", lat_band=(40, 50)):
        assert np.argmax(got["amplitude_spectrum"].mean(axis=0)[1:8]) + 1 == 3


# ---------------------------------------------------------------- the entry points
def _write_nc(path, seed, lon_convention_180=False, text_attrs=True):
    """A classic netCDF3 file: a (time, lat, lon) variable on a 2-degree
    grid and its coordinates, with text CF attributes when `text_attrs`
    (scipy reads numeric attributes as arrays, which neither package's zarr
    writer serialises)."""
    from scipy.io import netcdf_file

    rng = np.random.default_rng(seed)
    lats = np.linspace(-89.0, 89.0, 90)
    lons = np.arange(180) * 2.0 - (180.0 if lon_convention_180 else 0.0)
    with netcdf_file(path, "w") as f:
        f.createDimension("time", 3)
        f.createDimension("lat", lats.size)
        f.createDimension("lon", lons.size)
        t = f.createVariable("time", "f8", ("time",))
        t[:] = [0.0, 6.0, 12.0]
        la = f.createVariable("lat", "f4", ("lat",))
        la[:] = lats
        lo = f.createVariable("lon", "f4", ("lon",))
        lo[:] = lons
        v = f.createVariable("tisr", "f4", ("time", "lat", "lon"))
        v[:] = rng.standard_normal((3, lats.size, lons.size)).astype(np.float32)
        if text_attrs:
            t.units = "hours since 1979-01-01 00:00:00"
            v.long_name = "TOA incident solar radiation"


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            p = os.path.join(d, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_nc_to_zarr_writes_jax_scripts_tree(tmp_path):
    from dlwpbench_tpu_torch import nc_to_zarr
    from scripts import nc_to_zarr as jscript

    src = tmp_path / "nc"
    os.makedirs(src / "1979")
    _write_nc(str(src / "1979" / "tisr_1979.nc"), 0)
    _write_nc(str(src / "tisr_1980.nc"), 1)
    assert nc_to_zarr.main([str(src), str(tmp_path / "port")]) == 2
    jscript._convert_xarray = jscript._convert_scipy  # the script's netCDF3 branch
    jscript.main([str(src), str(tmp_path / "jax")])
    port, jax_tree = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert "1979/tisr_1979.zarr/tisr/.zarray" in port
    assert port == jax_tree


def test_nc_to_zarr_refuses_netcdf4(tmp_path):
    from dlwpbench_tpu_torch import nc_to_zarr

    os.makedirs(tmp_path / "nc")
    (tmp_path / "nc" / "x.nc").write_bytes(b"\x89HDF\r\n\x1a\n" + b"\x00" * 64)
    with pytest.raises(SystemExit, match="not a classic netCDF3 file"):
        nc_to_zarr.main([str(tmp_path / "nc"), str(tmp_path / "out")])


@pytest.mark.parametrize("lon_180", [False, True])
def test_ec46_regrid_writes_jax_scripts_tree(tmp_path, lon_180):
    """On a file without text attributes (JAX's script passes scipy's
    bytes attributes on to the zarr writer's JSON, which refuses them)."""
    from dlwpbench_tpu_torch import ec46_regrid
    from scripts import ec46_regrid as jscript

    src = tmp_path / "src"
    os.makedirs(src)
    _write_nc(str(src / "tisr_1979.nc"), 2, lon_convention_180=lon_180, text_attrs=False)
    assert ec46_regrid.main(["--src", str(src), "--dst", str(tmp_path / "port")]) == 1
    jscript.main(["--src", str(src), "--dst", str(tmp_path / "jax")])
    port = _tree(tmp_path / "port")
    assert "tisr_1979_5.625deg.zarr/tisr/.zarray" in port
    assert port == _tree(tmp_path / "jax")


def test_ec46_regrid_keeps_text_attributes(tmp_path):
    """The port decodes netCDF3 text attributes (as `nc_to_zarr` does), so
    a CF file with units and names regrids; JAX's script raises there."""
    from dlwpbench_tpu_torch import ec46_regrid
    from dlwpbench_tpu_torch.data import zarr_lite

    src = tmp_path / "src"
    os.makedirs(src)
    _write_nc(str(src / "tisr_1979.nc"), 3)
    assert ec46_regrid.main(["--src", str(src), "--dst", str(tmp_path / "out")]) == 1
    g = zarr_lite.ZarrGroup.open(str(tmp_path / "out" / "tisr_1979_5.625deg.zarr"))
    assert g["tisr"].read().shape == (3, 32, 64)
    assert dict(g["time"].attrs)["units"] == "hours since 1979-01-01 00:00:00"


def test_climatology_is_the_baselines_builder():
    from dlwpbench_tpu_torch import build_baselines, climatology

    assert climatology.main is build_baselines.main


# ---------------------------------------------------------------- profiling
def test_step_timer():
    from dlwpbench_tpu_torch.utils.profiling import StepTimer

    for sync in (False, True):
        t = StepTimer(skip=1, sync=sync)
        for _ in range(4):
            with t:
                pass
        s = t.summary()
        assert s["steps"] == 3 and s["mean_s"] >= 0 and s["p90_s"] >= s["median_s"] >= 0
    assert StepTimer().summary() == {"steps": 0}


def test_trace_writes_a_trace_with_the_annotation(tmp_path):
    import json

    from dlwpbench_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("rollout_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert "rollout_step" in names and "aten::mm" in names
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "rollout_step" for e in events)
