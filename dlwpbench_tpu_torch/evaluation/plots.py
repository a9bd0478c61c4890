"""Result plotting (counterpart of `dlwpbench_tpu/evaluation/plots.py`;
reference `scripts/plot_results.py` and `scripts/additional_plot.py`).

The same figure families over the metrics files:
- metric-over-parameters curves per model (RMSE/ACC/runtime/memory ladders);
- RMSE/ACC over lead time overlays;
- per-gridpoint RMSE maps and output-vs-target panels (train-time images);
- zonal kinetic-energy / physical-soundness bar charts;
- the zonal-wave diagnostics and an animated GIF of a field.

All functions take plain numpy + dicts and save PNG (GIF) files.  Each
imports matplotlib (Agg backend) when called, never at import time, so the
port imports where matplotlib is not installed (the card's machine); a
call there raises ImportError.
"""

from __future__ import annotations

import numpy as np


def pyplot():
    """matplotlib's pyplot on the file-only Agg backend, imported at the
    call."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def multi_x_over_params_plot(
    results: dict[str, dict[int, float]],
    ylabel: str,
    out_path: str,
    logx: bool = True,
    logy: bool = False,
):
    """results[model][n_params] = value (reference `multi_x_over_params_plot`)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(5, 3.5))
    for model, ladder in results.items():
        ps = sorted(ladder)
        ax.plot(ps, [ladder[p] for p in ps], marker="o", label=model)
    if logx:
        ax.set_xscale("log")
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("#parameters")
    ax.set_ylabel(ylabel)
    ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def rmse_per_gridpoint_plot(
    outputs: np.ndarray, targets: np.ndarray, out_path: str, title: str = ""
):
    """Time/sample-mean RMSE map (reference `additional_plot.py:6-26`)."""
    plt = pyplot()
    rmse = np.sqrt(((outputs - targets) ** 2).mean(axis=tuple(range(outputs.ndim - 2))))
    fig, ax = plt.subplots(figsize=(5, 2.6))
    im = ax.imshow(rmse, origin="lower", cmap="viridis")
    fig.colorbar(im, ax=ax, shrink=0.8)
    ax.set_title(title or "RMSE per gridpoint")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def output_vs_target_plot(
    output: np.ndarray, target: np.ndarray, out_path: str, title: str = ""
):
    """Side-by-side output/target/diff panels (reference `additional_plot.py:28-54`)."""
    plt = pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(9, 2.4))
    vmin, vmax = np.percentile(target, [2, 98])
    for ax, (arr, name) in zip(
        axes,
        [(output, "output"), (target, "target"), (output - target, "difference")],
    ):
        im = ax.imshow(arr, origin="lower", cmap="RdBu_r",
                       vmin=vmin if name != "difference" else None,
                       vmax=vmax if name != "difference" else None)
        ax.set_title(name, fontsize=8)
        ax.set_axis_off()
        fig.colorbar(im, ax=ax, shrink=0.7)
    fig.suptitle(title, fontsize=9)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def zonal_mean_plot(
    fields: dict[str, np.ndarray], lats: np.ndarray, ylabel: str, out_path: str
):
    """Zonal-mean profiles per model (physical-soundness figures,
    reference `plot_results.py:318,651`)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(4, 3))
    for name, f in fields.items():
        ax.plot(lats, f.mean(axis=-1) if f.ndim > 1 else f, label=name)
    ax.set_xlabel("latitude")
    ax.set_ylabel(ylabel)
    ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def metric_over_params_plot(
    scores: dict[str, dict[int, float]],
    out_path: str,
    metric: str = "RMSE",
    broken: dict[str, list[int]] | None = None,
    title: str = "",
):
    """Skill over the parameter ladder (reference
    `plot_results.py:158-316`): one curve per model family over #params,
    log-y, with diverged/broken runs marked as diamonds at their param
    count (the reference's `broken_idcs` scatter, `plot_results.py:470`)."""
    plt = pyplot()
    broken = broken or {}
    fig, ax = plt.subplots(figsize=(5, 3.5))
    for model, ladder in scores.items():
        ps = sorted(ladder)
        line, = ax.plot(ps, [ladder[p] for p in ps], marker="o", lw=2,
                        markersize=4, label=model)
        bad = broken.get(model)
        if bad:
            ax.scatter(bad, [ladder[p] for p in bad], c=line.get_color(),
                       marker="d", s=50, zorder=3)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("#parameters")
    ax.set_ylabel(metric)
    ax.grid(visible=True, which="minor", color="silver")
    ax.grid(visible=True, which="major", color="grey")
    if title:
        ax.set_title(title)
    ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def end_conditions_plot(
    fields: dict[str, np.ndarray],
    verification: np.ndarray,
    out_path: str,
    day: int = 96,
    var_name: str = "",
):
    """End-of-rollout state snapshots per model next to the verification
    (reference `plot_results.py:572-649`, default day 96): one filled
    contour panel per model at a shared color range."""
    plt = pyplot()
    names = ["verification"] + list(fields)
    n = len(names)
    ncol = min(4, n)
    nrow = -(-n // ncol)
    vmin, vmax = np.percentile(verification, [1, 99])
    fig, axes = plt.subplots(nrow, ncol, figsize=(3.2 * ncol, 2.0 * nrow),
                             squeeze=False)
    for i, name in enumerate(names):
        ax = axes[i // ncol][i % ncol]
        arr = verification if name == "verification" else fields[name]
        im = ax.contourf(arr, levels=20, vmin=vmin, vmax=vmax, cmap="RdBu_r")
        ax.set_title(name, fontsize=8)
        ax.set_xticks([])
        ax.set_yticks([])
    for j in range(n, nrow * ncol):
        axes[j // ncol][j % ncol].set_axis_off()
    fig.colorbar(im, ax=axes, shrink=0.8)
    fig.suptitle(f"{var_name} state at day {day}", fontsize=10)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def long_rollout_mean_std_plot(
    series: dict[str, np.ndarray],
    verification: np.ndarray,
    out_path: str,
    timedelta_hours: float = 24.0,
    var_name: str = "",
):
    """Global-mean and global-std drift over a long rollout per model vs
    the verification (reference `plot_results.py:785-923`
    long_rollout_mean_plot/long_rollout_std_plot): the year-long stability
    diagnostic — a sound model's statistics stay near the verification's.

    series[model]: [T, H, W] forecast fields; verification: [T, H, W].
    """
    plt = pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 3))
    days = np.arange(verification.shape[0]) * timedelta_hours / 24.0

    def stats(a):
        flat = a.reshape(a.shape[0], -1)
        return flat.mean(axis=1), flat.std(axis=1)

    vm, vs = stats(verification)
    ax1.plot(days, vm, "k--", lw=2, label="verification")
    ax2.plot(days, vs, "k--", lw=2, label="verification")
    for name, arr in series.items():
        m, s = stats(arr)
        d = np.arange(arr.shape[0]) * timedelta_hours / 24.0
        ax1.plot(d, m, label=name)
        ax2.plot(d, s, label=name)
    ax1.set_ylabel(f"global mean {var_name}")
    ax2.set_ylabel(f"global std {var_name}")
    for ax in (ax1, ax2):
        ax.set_xlabel("lead time [days]")
        ax.grid(color="silver", lw=0.5)
    ax1.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def hovmoller_plot(
    series: np.ndarray,
    lons: np.ndarray,
    out_path: str,
    var: str = "z500",
    title_suffix: str = "",
):
    """Time x longitude Hovmoller of a latitude-band mean (reference
    `preprocessing.py:595-619` `plot_val_at_lat`): rows = longitude,
    columns = time step.  `series` is the [T, W] band-mean series from
    `zonal_wave_analysis`."""
    plt = pyplot()
    series = np.asarray(series)
    fig, ax = plt.subplots(figsize=(9, 4.5))
    im = ax.imshow(
        series.T, aspect="auto", cmap="viridis", origin="lower",
        extent=[0, series.shape[0], float(np.min(lons)), float(np.max(lons))],
    )
    fig.colorbar(im, ax=ax, label=var)
    ax.set_title(f"{var} latitude-band mean {title_suffix}".strip())
    ax.set_xlabel("time step")
    ax.set_ylabel("longitude")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def zonal_fft_amplitude_plot(
    amplitude: np.ndarray,
    out_path: str,
    time_indices: tuple[int, ...] = (0,),
    var: str = "z500",
):
    """Zonal FFT amplitude spectrum at selected time steps (reference
    `preprocessing.py:626-652` `plot_latitude`, which overlays latitudes;
    here the band mean is already taken, so the overlay is over the
    selected time steps).  `amplitude` is [T, W] from
    `zonal_wave_analysis`."""
    plt = pyplot()
    amplitude = np.asarray(amplitude)
    n_lon = amplitude.shape[-1]
    k = np.arange(n_lon // 2)
    fig, ax = plt.subplots(figsize=(7, 3.5))
    for t in time_indices:
        ax.plot(k, amplitude[t, : n_lon // 2], label=f"t={t}")
    ax.set_xlabel("zonal wavenumber")
    ax.set_ylabel("amplitude")
    ax.set_title(f"Zonal FFT amplitude spectrum {var}")
    ax.legend(fontsize=6)
    ax.grid(True, linestyle="--", alpha=0.5)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def zonal_wavenumber_distribution_plot(
    amplitude: np.ndarray,
    out_path: str,
    max_wavenumber: int = 14,
    var: str = "z500",
):
    """Amplitude distribution per zonal wavenumber over all time steps
    (reference `preprocessing.py:653-683` `plot_wavenumbers`, a seaborn
    boxplot; rendered with matplotlib's boxplot — same statistic)."""
    plt = pyplot()
    amplitude = np.asarray(amplitude)
    ks = range(1, min(max_wavenumber, amplitude.shape[-1] // 2) + 1)
    data = [amplitude[:, k] for k in ks]
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.boxplot(data, tick_labels=[str(k) for k in ks])
    ax.set_xlabel("wavenumber")
    ax.set_ylabel("amplitude")
    ax.set_title(f"Zonal FFT amplitude distribution, {var}")
    ax.grid(True, linestyle="--", alpha=0.5)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def kinetic_energy_spectrum_plot(
    spectra: dict[str, np.ndarray], out_path: str
):
    """Zonal kinetic-energy spectra overlay (reference `plot_results.py:925`)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(4, 3))
    for name, p in spectra.items():
        ax.loglog(np.arange(1, len(p)), p[1:], label=name)
    ax.set_xlabel("zonal wavenumber")
    ax.set_ylabel("energy")
    ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def make_gif(frames: np.ndarray, out_path: str, fps: int = 4,
             cmap: str = "viridis", var: str = ""):
    """Animated GIF of a [T, H, W] field (reference `preprocessing.py:620-624`
    `make_gif`, which wraps geogif; here rendered frame-by-frame with
    matplotlib and PIL)."""
    plt = pyplot()
    from PIL import Image

    frames = np.asarray(frames)
    vmin, vmax = float(np.nanmin(frames)), float(np.nanmax(frames))
    images = []
    for t in range(frames.shape[0]):
        fig, ax = plt.subplots(figsize=(4, 2.2), dpi=80)
        ax.imshow(frames[t], origin="lower", cmap=cmap, vmin=vmin, vmax=vmax)
        ax.set_title(f"{var} t={t}".strip())
        ax.axis("off")
        fig.tight_layout(pad=0.1)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        images.append(Image.fromarray(buf.copy()))
        plt.close(fig)
    images[0].save(out_path, save_all=True, append_images=images[1:],
                   duration=int(1000 / fps), loop=0)
    return out_path
