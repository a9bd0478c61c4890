"""The port's plots (`evaluation/plots.py`), the evaluator's frames and
mp4 (`evaluation/evaluate.py`) and the evaluate CLI's comparison plot and
`--video`, against the JAX package's.

`tests/test_plots.py`'s eight cases in the port (every plot function
writes a non-trivial PNG from plain numpy inputs), then: each port figure
equal byte for byte to the JAX function's on the same inputs (the same
matplotlib calls on the same Agg backend), `plot_rmse_over_time` and
`render_forecast_frames` likewise, `generate_mp4` returning False without
ffmpeg, and the CLI: with matplotlib it writes the comparison plot, with
matplotlib made unimportable it prints that it skipped the plot and the
video and still returns its results (the JAX CLI raises ImportError
there).
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from dlwpbench_tpu.evaluation import evaluate as JE
from dlwpbench_tpu.evaluation import plots as jplots
from dlwpbench_tpu_torch.data.preprocessing import Preprocessor, zonal_wave_analysis
from dlwpbench_tpu_torch.evaluation import evaluate as TE
from dlwpbench_tpu_torch.evaluation import plots as tplots


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _png_ok(path):
    return os.path.exists(path) and os.path.getsize(path) > 2000


def test_multi_x_over_params(tmp_path):
    p = str(tmp_path / "a.png")
    tplots.multi_x_over_params_plot(
        {"unet": {50_000: 1.0, 1_000_000: 0.8}, "swin": {50_000: 1.2}}, "RMSE", p)
    assert _png_ok(p)


def test_metric_over_params_with_broken_runs(tmp_path):
    p = str(tmp_path / "b.png")
    tplots.metric_over_params_plot(
        {"unet": {50_000: 1.0, 1_000_000: 0.8, 16_000_000: 0.7},
         "fcn": {50_000: 1.4, 1_000_000: 2.5}},
        p, broken={"fcn": [1_000_000]}, title="Z500, 3 days")
    assert _png_ok(p)


def test_end_conditions_plot(tmp_path):
    rng = np.random.default_rng(0)
    p = str(tmp_path / "c.png")
    tplots.end_conditions_plot(
        {"unet": rng.standard_normal((16, 32)), "sfno": rng.standard_normal((16, 32))},
        rng.standard_normal((16, 32)), p, day=96, var_name="z500")
    assert _png_ok(p)


def test_long_rollout_mean_std(tmp_path):
    rng = np.random.default_rng(1)
    p = str(tmp_path / "d.png")
    tplots.long_rollout_mean_std_plot({"unet": rng.standard_normal((20, 8, 16))},
                                      rng.standard_normal((20, 8, 16)), p,
                                      timedelta_hours=24.0, var_name="z500")
    assert _png_ok(p)


def test_gridpoint_and_panels(tmp_path):
    rng = np.random.default_rng(2)
    out = rng.standard_normal((2, 5, 8, 16))
    tar = rng.standard_normal((2, 5, 8, 16))
    p1, p2 = str(tmp_path / "e.png"), str(tmp_path / "f.png")
    tplots.rmse_per_gridpoint_plot(out, tar, p1)
    tplots.output_vs_target_plot(out[0, 0], tar[0, 0], p2)
    assert _png_ok(p1) and _png_ok(p2)


def test_zonal_and_spectrum(tmp_path):
    rng = np.random.default_rng(3)
    p1, p2 = str(tmp_path / "g.png"), str(tmp_path / "h.png")
    tplots.zonal_mean_plot({"unet": rng.standard_normal((8, 16))}, np.linspace(-80, 80, 8),
                           "u10", p1)
    tplots.kinetic_energy_spectrum_plot({"unet": np.abs(rng.standard_normal(16))}, p2)
    assert _png_ok(p1) and _png_ok(p2)


def test_zonal_wave_figure_family(tmp_path):
    """Reference preprocessing.py:595-683: Hovmoller, per-time zonal FFT
    amplitude overlay, per-wavenumber amplitude distribution, GIF."""
    rng = np.random.default_rng(4)
    T, H, W = 40, 8, 16
    times = np.datetime64("2015-01-01T00") + np.arange(T) * np.timedelta64(6, "h")
    lats = np.linspace(-87.5, 87.5, H)
    data = rng.standard_normal((T, H, W)).astype(np.float32)
    res = zonal_wave_analysis(data, times, lats, freq="D", lat_band=(30.0, 60.0))
    assert res["series"].shape[-1] == W
    assert res["amplitude_spectrum"].shape == res["series"].shape
    p1, p2, p3 = (str(tmp_path / n) for n in ("hov.png", "amp.png", "dist.png"))
    tplots.hovmoller_plot(res["series"], np.arange(W) * 22.5, p1, var="z500")
    tplots.zonal_fft_amplitude_plot(res["amplitude_spectrum"], p2, time_indices=(0, 1))
    tplots.zonal_wavenumber_distribution_plot(res["amplitude_spectrum"], p3)
    assert _png_ok(p1) and _png_ok(p2) and _png_ok(p3)
    g = str(tmp_path / "anim.gif")
    tplots.make_gif(data[:4], g, fps=2, var="z500")
    with open(g, "rb") as f:
        assert f.read(6) in (b"GIF87a", b"GIF89a")


def test_preprocessor_accessors():
    rng = np.random.default_rng(5)
    T = 30
    times = np.datetime64("2015-01-01") + np.arange(T) * np.timedelta64(1, "D")
    data = rng.standard_normal((T, 4, 6)).astype(np.float32)
    pp = Preprocessor(rolling_window_size=None, detrend="linear")
    with pytest.raises(RuntimeError):
        _ = pp.trend
    pp.fit(data, times)
    assert pp.trend.shape == (2, 4, 6)
    assert pp.climatology.shape == (366, 4, 6)


# ---------------------------------------------------------------- against JAX's figures
def _figure_args(name, rng):
    f = lambda *s: rng.standard_normal(s)  # noqa: E731
    return {
        "multi_x_over_params_plot": (({"unet": {50_000: 1.0, 10**6: 0.8}}, "RMSE"), {}),
        "rmse_per_gridpoint_plot": ((f(2, 5, 8, 16), f(2, 5, 8, 16)), {}),
        "output_vs_target_plot": ((f(8, 16), f(8, 16)), {"title": "t"}),
        "zonal_mean_plot": (({"unet": f(8, 16)}, np.linspace(-80, 80, 8), "u10"), {}),
        "metric_over_params_plot": (({"fcn": {50_000: 1.4, 10**6: 2.5}},),
                                    {"broken": {"fcn": [10**6]}}),
        "end_conditions_plot": (({"unet": f(16, 32)}, f(16, 32)), {"var_name": "z500"}),
        "long_rollout_mean_std_plot": (({"unet": f(20, 8, 16)}, f(20, 8, 16)), {}),
        "hovmoller_plot": ((f(10, 16), np.arange(16) * 22.5), {}),
        "zonal_fft_amplitude_plot": ((np.abs(f(10, 16)),), {"time_indices": (0, 3)}),
        "zonal_wavenumber_distribution_plot": ((np.abs(f(10, 16)),), {}),
        "kinetic_energy_spectrum_plot": (({"unet": np.abs(f(16))},), {}),
    }[name]


@pytest.mark.parametrize("name", [
    "multi_x_over_params_plot", "rmse_per_gridpoint_plot", "output_vs_target_plot",
    "zonal_mean_plot", "metric_over_params_plot", "end_conditions_plot",
    "long_rollout_mean_std_plot", "hovmoller_plot", "zonal_fft_amplitude_plot",
    "zonal_wavenumber_distribution_plot", "kinetic_energy_spectrum_plot"])
def test_figures_equal_jax_byte_for_byte(name, tmp_path):
    args, kwargs = _figure_args(name, np.random.default_rng(len(name)))
    want, got = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    getattr(jplots, name)(*args, want, **kwargs)
    getattr(tplots, name)(*args, got, **kwargs)
    assert _png_ok(got)
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


def test_plot_rmse_over_time_equals_jax(tmp_path):
    rng = np.random.default_rng(6)
    results = {m: {"rmse": {v: rng.random(8).tolist() for v in ("z500", "t850")}}
               for m in ("unet", "swin")}
    want, got = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    JE.plot_rmse_over_time(results, ["z500", "t850"], want)
    TE.plot_rmse_over_time(results, ["z500", "t850"], got)
    assert _png_ok(got)
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("with_targets", [True, False])
def test_render_forecast_frames_equal_jax(with_targets, tmp_path):
    rng = np.random.default_rng(7)
    out = rng.standard_normal((3, 8, 16)).astype(np.float32)
    tar = rng.standard_normal((3, 8, 16)).astype(np.float32) if with_targets else None
    n_j = JE.render_forecast_frames(out, str(tmp_path / "jax"), targets=tar, var_name="z500")
    n_t = TE.render_forecast_frames(out, str(tmp_path / "port"), targets=tar, var_name="z500")
    assert n_j == n_t == 3
    assert sorted(os.listdir(tmp_path / "port")) == ["f0000.png", "f0001.png", "f0002.png"]
    for f in os.listdir(tmp_path / "port"):
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes()


def test_generate_mp4_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    out = str(tmp_path / "f.mp4")
    assert TE.generate_mp4(np.zeros((2, 4, 8)), out) is False
    assert not os.path.exists(out)


# ---------------------------------------------------------------- the evaluate CLI
@pytest.fixture
def run_dir(tmp_path):
    from dlwpbench_tpu_torch import train

    path = str(tmp_path / "unet_run")
    train.main(["model=unet", "data=synthetic", "data.height=8", "data.width=16",
                "model.hidden_channels=[4]", "training.epochs=1", "training.batch_size=4",
                "validation.sequence_length=3", f"run_dir={path}", "--device", "cpu"])
    return path


def _evaluate(run_dir):
    from dlwpbench_tpu_torch import evaluate

    return evaluate.main(["-c", run_dir, "--sequence-length", "3", "--batch-size", "4",
                          "--video", "--device", "cpu"])


def test_cli_writes_the_comparison_plot(run_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: None)  # no ffmpeg, as here
    res = _evaluate(run_dir)
    out = capsys.readouterr().out
    assert "unet_run" in res
    assert _png_ok(str(tmp_path / "outputs" / "rmse_over_time.png"))
    assert "Comparison plot -> outputs/rmse_over_time.png" in out
    assert "video: ffmpeg unavailable, skipped" in out


@pytest.mark.parametrize("ffmpeg", [False, True])
def test_cli_skips_plot_and_video_without_matplotlib(run_dir, tmp_path, monkeypatch, capsys,
                                                     ffmpeg):
    """matplotlib unimportable (as on the card's machine): the CLI says it
    skipped the plot and the video, and returns its results; nothing of
    matplotlib is imported."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(shutil, "which", lambda name: "/usr/bin/ffmpeg" if ffmpeg else None)
    res = _evaluate(run_dir)
    out = capsys.readouterr().out
    assert np.isfinite(res["unet_run"]["rmse"]["var0"]).all()
    assert "Comparison plot skipped: matplotlib unavailable" in out
    assert not os.path.exists(tmp_path / "outputs" / "rmse_over_time.png")
    if ffmpeg:
        assert "video: matplotlib unavailable" in out and "skipped" in out
    else:
        assert "video: ffmpeg unavailable, skipped" in out
    assert not os.path.exists(os.path.join(run_dir, "evaluation", "forecast.mp4"))
