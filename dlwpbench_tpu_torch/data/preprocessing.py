"""Preprocessing on the host, numpy only (the port's copy of
`dlwpbench_tpu/data/preprocessing.py`; reference
`data/datasets/preprocessing.py:310-683`, an s2spy-style pipeline):

- `Preprocessor`: a linear or polynomial trend and the day-of-year
  climatology, removed and restored with a fit/transform API;
- `temporal_power_spectrum`, `regrid_linear` (bilinear lat-lon regridding,
  `python -m dlwpbench_tpu_torch.ec46_regrid`), `coarsen_mean` (the one
  function a source calls, `downscale_factor`), `resample_mean` and
  `zonal_wave_analysis`.

The reference works on xarray objects; these take numpy arrays with an
explicit datetime64 time coordinate.
"""

from __future__ import annotations

import numpy as np


class Preprocessor:
    """Removes a (linear|polynomial) trend and/or the day-of-year climatology.

    Usage (mirrors the reference's fit/transform API):
        pp = Preprocessor(rolling_window_size=25, detrend="linear")
        pp.fit(data, times)           # data: [T, ...]
        anom = pp.transform(data, times)
        data2 = pp.inverse_transform(anom, times)
    """

    def __init__(
        self,
        rolling_window_size: int | None = 25,
        detrend: str | None = "linear",
        subtract_climatology: bool = True,
        poly_degree: int = 2,
    ):
        if detrend not in (None, "linear", "polynomial"):
            raise ValueError(f"invalid detrend {detrend!r}")
        self.window = rolling_window_size
        self.detrend = detrend
        self.subtract_climatology = subtract_climatology
        self.poly_degree = poly_degree
        self._trend_coef = None
        self._clim = None

    # -- helpers ---------------------------------------------------------
    @staticmethod
    def _doy(times) -> np.ndarray:
        t = np.asarray(times, "datetime64[D]")
        years = t.astype("datetime64[Y]")
        return (t - years).astype(int)  # 0..365

    def _trend(self, tnum, shape):
        deg = 1 if self.detrend == "linear" else self.poly_degree
        powers = np.stack([tnum**k for k in range(deg + 1)], -1)  # [T, deg+1]
        coef = self._trend_coef  # [deg+1, ...]
        return np.tensordot(powers, coef, axes=(1, 0)).reshape(-1, *shape)

    # -- API -------------------------------------------------------------
    def fit(self, data: np.ndarray, times) -> "Preprocessor":
        data = np.asarray(data, np.float64)
        T = data.shape[0]
        tnum = np.arange(T, dtype=np.float64)

        if self.detrend:
            deg = 1 if self.detrend == "linear" else self.poly_degree
            flat = data.reshape(T, -1)
            coef = np.polynomial.polynomial.polyfit(tnum, flat, deg)  # [deg+1, P]
            self._trend_coef = coef.reshape(deg + 1, *data.shape[1:])
            data = data - self._trend(tnum, data.shape[1:]).reshape(data.shape)

        if self.subtract_climatology:
            doy = self._doy(times)
            clim = np.zeros((366, *data.shape[1:]))
            counts = np.zeros(366)
            for d in range(366):
                m = doy == d
                if m.any():
                    clim[d] = data[m].mean(axis=0)
                    counts[d] = m.sum()
            # fill missing days (e.g. no Feb 29) from neighbors
            for d in np.nonzero(counts == 0)[0]:
                clim[d] = clim[(d - 1) % 366]
            if self.window and self.window > 1:
                w = self.window
                kernel = np.ones(w) / w
                pad = np.concatenate([clim[-w:], clim, clim[:w]], axis=0)
                sm = np.apply_along_axis(
                    lambda v: np.convolve(v, kernel, mode="same"), 0, pad
                )
                clim = sm[w : w + 366]
            self._clim = clim
        return self

    def transform(self, data: np.ndarray, times) -> np.ndarray:
        data = np.asarray(data, np.float64)
        T = data.shape[0]
        if self.detrend:
            if self._trend_coef is None:
                raise RuntimeError("call fit() first")
            tnum = np.arange(T, dtype=np.float64)
            data = data - self._trend(tnum, data.shape[1:]).reshape(data.shape)
        if self.subtract_climatology:
            if self._clim is None:
                raise RuntimeError("call fit() first")
            data = data - self._clim[self._doy(times)]
        return data.astype(np.float32)

    def fit_transform(self, data: np.ndarray, times) -> np.ndarray:
        """Reference `Preprocessor.fit_transform` (`preprocessing.py:421`)."""
        return self.fit(data, times).transform(data, times)

    def get_trend_timeseries(self, n_steps: int) -> np.ndarray:
        """The fitted trend evaluated over `n_steps` (reference
        `get_trend_timeseries`, `preprocessing.py:435`)."""
        if self._trend_coef is None:
            raise RuntimeError("call fit() first")
        tnum = np.arange(n_steps, dtype=np.float64)
        shape = self._trend_coef.shape[1:]
        return self._trend(tnum, shape).reshape(n_steps, *shape)

    @property
    def trend(self) -> np.ndarray:
        """Fitted trend coefficients [deg+1, ...] (reference `Preprocessor.trend`,
        `preprocessing.py:460-470`)."""
        if self._trend_coef is None:
            raise RuntimeError("call fit() first")
        return self._trend_coef

    @property
    def climatology(self) -> np.ndarray:
        """Fitted day-of-year climatology [366, ...] (reference
        `Preprocessor.climatology`, `preprocessing.py:472-484`)."""
        if self._clim is None:
            raise RuntimeError("call fit() first")
        return self._clim

    def inverse_transform(self, data: np.ndarray, times) -> np.ndarray:
        data = np.asarray(data, np.float64)
        T = data.shape[0]
        if self.subtract_climatology and self._clim is not None:
            data = data + self._clim[self._doy(times)]
        if self.detrend and self._trend_coef is not None:
            tnum = np.arange(T, dtype=np.float64)
            data = data + self._trend(tnum, data.shape[1:]).reshape(data.shape)
        return data.astype(np.float32)


def temporal_power_spectrum(data: np.ndarray, dt_hours: float = 6.0):
    """Spectral diagnostics (reference `preprocessing.py:507-683`): mean power
    spectrum over the time axis.  Returns (freq_per_day, power[..., F])."""
    T = data.shape[0]
    f = np.fft.rfftfreq(T, d=dt_hours / 24.0)
    spec = np.abs(np.fft.rfft(data, axis=0)) ** 2 / T
    # average over all non-time axes
    power = spec.reshape(spec.shape[0], -1).mean(axis=1)
    return f, power


def regrid_linear(
    data: np.ndarray, src_lats, src_lons, dst_lats, dst_lons
) -> np.ndarray:
    """Bilinear lat-lon regridding (reference `data/processing/regridding.py`
    and `EC46_regridding.py`): periodic in longitude, clamped in latitude.

    data: [..., H, W] on (src_lats, src_lons) -> [..., H', W']."""
    src_lats = np.asarray(src_lats)
    src_lons = np.asarray(src_lons)
    H, W = data.shape[-2:]

    fy = np.interp(dst_lats, src_lats, np.arange(H))
    y0 = np.clip(np.floor(fy).astype(int), 0, H - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    wy = np.clip(fy - y0, 0, 1)

    dlon = 360.0 / W
    fx = (np.asarray(dst_lons) - src_lons[0]) % 360.0 / dlon
    x0 = np.floor(fx).astype(int) % W
    x1 = (x0 + 1) % W
    wx = fx - np.floor(fx)

    d = data
    out = (
        d[..., y0[:, None], x0[None, :]] * ((1 - wy)[:, None] * (1 - wx)[None, :])
        + d[..., y0[:, None], x1[None, :]] * ((1 - wy)[:, None] * wx[None, :])
        + d[..., y1[:, None], x0[None, :]] * (wy[:, None] * (1 - wx)[None, :])
        + d[..., y1[:, None], x1[None, :]] * (wy[:, None] * wx[None, :])
    )
    return out.astype(data.dtype)


def coarsen_mean(data: np.ndarray, factor: int) -> np.ndarray:
    """Block-mean downscaling (reference `datasets.py:303-305` coarsen)."""
    *lead, H, W = data.shape
    x = data.reshape(*lead, H // factor, factor, W // factor, factor)
    return x.mean(axis=(-3, -1))


def resample_mean(data: np.ndarray, times, freq: str = "D"):
    """Time-bin mean (xarray `.resample(time=...).mean()` equivalent).

    freq: "D" (daily) or "W" (weekly).  Returns (binned_data, bin_times).
    """
    t = np.asarray(times, "datetime64[s]")
    if freq == "D":
        keys = t.astype("datetime64[D]")
    elif freq == "W":
        days = t.astype("datetime64[D]")
        epoch = np.datetime64("1970-01-01")  # a Thursday; weeks since epoch
        keys = epoch + ((days - epoch).astype(int) // 7) * np.timedelta64(7, "D")
    else:
        raise ValueError(f"unsupported freq {freq!r}")
    uniq, inv = np.unique(keys, return_inverse=True)
    out = np.zeros((len(uniq), *data.shape[1:]), np.float64)
    np.add.at(out, inv, np.asarray(data, np.float64))
    counts = np.bincount(inv, minlength=len(uniq)).reshape(
        -1, *([1] * (data.ndim - 1))
    )
    return (out / counts).astype(np.float32), uniq


def zonal_wave_analysis(
    data: np.ndarray,
    times,
    lats: np.ndarray,
    freq: str = "D",
    winter_mask: bool = False,
    lat_band: tuple[float, float] | None = (40.0, 50.0),
    rolling_window_size: int = 10,
):
    """Stationary/transient zonal-wave diagnostic (reference
    `daily_preprocessing`/`weekly_preprocessing`, `preprocessing.py:507-594`):
    deseasonalize (linear detrend + day-of-year climatology), resample to
    daily/weekly means, optionally keep only DJF, average the latitude band,
    then FFT along longitude.

    data: [T, H, W] single variable; returns a dict with the band series,
    zonal amplitude spectrum [T', W], positive wavenumbers, temporal
    frequencies [1/s], and the frequency x wavenumber phase-speed table.
    """
    pp = Preprocessor(rolling_window_size=rolling_window_size,
                      detrend="linear", subtract_climatology=True)
    anom = pp.fit_transform(np.asarray(data, np.float64), times)
    binned, bin_times = resample_mean(anom, times, freq)

    if winter_mask:
        months = (bin_times.astype("datetime64[M]").astype(int) % 12) + 1
        keep = np.isin(months, (12, 1, 2))
        binned, bin_times = binned[keep], bin_times[keep]

    lats = np.asarray(lats)
    if lat_band is not None:
        sel = (lats >= min(lat_band)) & (lats <= max(lat_band))
        if not sel.any():
            raise ValueError(f"no latitudes inside {lat_band}")
        band = binned[:, sel].mean(axis=1)  # [T', W]
    else:
        band = binned.mean(axis=1)

    fft = np.fft.fft(band, axis=-1)
    amplitude = np.abs(fft)
    n_lon = band.shape[-1]
    wavenumbers = np.fft.fftfreq(n_lon, d=1.0)[: n_lon // 2]
    if len(bin_times) > 1:
        dt_s = float(np.diff(bin_times.astype("datetime64[s]")).mean()
                     / np.timedelta64(1, "s"))
    else:
        dt_s = 86400.0
    frequencies = np.fft.fftfreq(len(bin_times), d=dt_s)
    # wavenumber 0 has no phase speed: 1/0 -> inf and 0*inf -> nan by design
    with np.errstate(divide="ignore", invalid="ignore"):
        phase_speed = np.outer(frequencies, 1.0 / wavenumbers)
    return {
        "series": band,
        "times": bin_times,
        "amplitude_spectrum": amplitude,
        "wavenumbers": wavenumbers,
        "frequencies": frequencies,
        "phase_speed": phase_speed,
    }
