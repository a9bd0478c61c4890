"""The reference's runtime and memory tables from a measured ladder
(counterpart of `scripts/ladder_tables.py`).

The reference hard-codes its measured arrays in `plot_results.py:483-570`
(one value per 50k -> 128M rung per family, batch 1).  This entry builds
the same tables from a ladder file (`benchmark_ladder`'s, or a JAX
`results/ladder.json`: the keys are the same), compares each row with the
reference's GPU numbers and draws the runtime- and memory-over-parameters
figure where matplotlib is installed.

    python -m dlwpbench_tpu_torch.ladder_tables [--ladder outputs/ladder.json]
        [--out-md outputs/ladder_tables.md] [--out-png outputs/ladder_over_params.png]

The header names the device and power limit the file records (entries
from JAX's script record none: "not recorded").  Memory is each entry's
`peak_mb`, or JAX's `xla_plan_mb` where that is all it holds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

RUNG_ORDER = ["50k", "500k", "1m", "2m", "4m", "8m", "16m", "32m", "64m", "128m"]

# The reference's measured tables (s/epoch and MB over the parameter
# ladder), from its `plot_results.py:487-545`.
nan = float("nan")
REF_RUNTIME = {
    "convlstm": [14.39, 14.84, 14.94, 15.17, 15.25, 19.73, 28.45, 56.40, 117.45, nan],
    "unet": [20.54, 21.95, 20.94, 22.30, 21.30, 21.70, 23.02, 24.16, 25.87, 31.61],
    "swin": [30.68, 57.02, 58.79, 60.17, 62.10, 69.35, 81.83, 83.61, nan, nan],
    "pangu": [nan, 77.36, 78.86, 79.11, 78.52, 77.07, 79.10, 81.54, 95.52, nan],
    "fourcastnet": [19.30, 19.20, 34.64, 35.55, 52.39, 52.28, 68.68, 82.17, 127.32, 211.93],
    "sfno2d": [20.58, 19.53, 21.23, 20.72, 20.24, 21.48, 20.84, 23.27, 44.03, 79.80],
    "fno2d": [13.38, 13.28, 13.48, 13.78, 13.67, 13.86, 15.67, 20.43, 40.77, 83.66],
    "tfno2d": [22.89, 22.58, 22.56, 23.07, 22.68, 22.91, 24.01, 26.28, 32.24, 48.16],
    "mgn": [19.22, 19.61, 21.12, 27.75, 40.90, 60.89, 104.04, 175.79, nan, nan],
    "graphcast": [25.10, 25.95, 26.41, 27.15, 27.40, 37.01, 53.74, 87.32, nan, nan],
}
REF_MEMORY_MB = {
    "convlstm": [370, 420, 460, 516, 614, 770, 1060, 1576, 2490, nan],
    "unet": [350, 360, 366, 388, 426, 518, 672, 1038, 1584, 2902],
    "swin": [1324, 2062, 2100, 2246, 2374, 2328, 2376, 2772, nan, nan],
    "pangu": [nan, 672, 832, 1240, 1726, 2098, 2516, 3412, 4466, nan],
    "fourcastnet": [438, 570, 748, 920, 1314, 1784, 2660, 3642, 5156, 7988],
    "sfno2d": [378, 408, 426, 484, 524, 618, 820, 1156, 1780, 3212],
    "fno2d": [410, 420, 434, 466, 490, 604, 712, 1046, 1702, 2868],
    "tfno2d": [412, 432, 450, 474, 544, 642, 862, 1274, 2418, 4236],
    "mgn": [572, 1066, 1346, 1798, 2326, 3124, 4388, 6100, nan, nan],
    "graphcast": [494, 802, 998, 1270, 1674, 2238, 3138, 4328, nan, nan],
}
LABEL = {
    "convlstm": "ConvLSTM", "unet": "U-Net", "swin": "SwinTransformer",
    "pangu": "Pangu-Weather", "fourcastnet": "FourCastNet p=1x1",
    "sfno2d": "SFNO", "fno2d": "FNO2D", "tfno2d": "TFNO2D",
    "mgn": "MeshGraphNet", "graphcast": "GraphCast",
    # extensions (no reference GPU row): the windowed Swin, and DISTANA
    # (the reference ships only a config for it, no implementation)
    "swin_win8": "SwinTransformer w8x8 (extension)",
    "distana": "DISTANA (extension)",
}


def memory_mb(e: dict):
    """The entry's peak memory: the port's `peak_mb`, else JAX's plan."""
    return e.get("peak_mb") or e.get("xla_plan_mb")


def recorded_devices(ladder: dict) -> str:
    """The devices and power limits the file's entries record, or "not
    recorded" (JAX's entries)."""
    seen = sorted({(e["device"], e.get("power_limit_w")) for e in ladder.values()
                   if e.get("device")}, key=str)
    if not seen:
        return "not recorded"
    return "; ".join(f"{d}, power limit {'not recorded' if w is None else f'{w:.2f} W'}"
                     for d, w in seen)


def table_lines(ladder: dict, grid: str = "32x64") -> tuple[list[str], dict]:
    """(the markdown's lines: the header, one section per family on `grid`,
    the bf16 section, one section per other grid; the rows on `grid` by
    family and rung, for the figure)."""
    fam_rows, extra_grids, bf16_rows = {}, {}, {}
    for key, e in ladder.items():
        if "error" in e:
            continue
        if key.endswith("@bf16"):
            # bucket by (family, grid): the fp32 partner must come from the
            # same grid or the gain column pairs different problems
            bf16_rows.setdefault((e["family"], e["grid"]), {})[e["rung"]] = e
        elif e["grid"] == grid:
            fam_rows.setdefault(e["family"], {})[e["rung"]] = e
        else:
            extra_grids.setdefault(e["grid"], {}).setdefault(e["family"], {})[e["rung"]] = e

    lines = [
        "# Benchmark ladder",
        "",
        f"Device: {recorded_devices(ladder)}.",
        "",
        "Protocol: remat training step (fwd+bwd+AdamW), batch_size=1,",
        "sequence_length=15, 5.625-degree shapes (32x64, 8 prognostic",
        "channels); `epoch(2014)` = 96 windows, the reference's measurement",
        "command (`plot_results.py:504`: one year of 6-hourly data at",
        "batch 1).  Reference GPU values from `plot_results.py:487-545`.",
        "Memory: the entry's `peak_mb` (the allocator's peak over the timed",
        "steps), or `xla_plan_mb` (XLA's compiled allocation plan) where the",
        "entry holds only that.  TFLOP/s = the entry's `flops_per_step` /",
        "measured step time: an eager `FlopCounterMode` count of the",
        "products and convolutions (forward, remat recompute, backward) in",
        "the port's entries, XLA's cost model in JAX's; batch 1 is",
        "latency-bound by protocol design.",
        "",
        "Graph families (mgn/graphcast): where an entry also holds",
        "`algorithmic_tflops` (`backfill_graph_flops`: the FLOPs of the",
        "gather/edge-list movement), the TFLOP/s column shows `executed",
        "(algorithmic)`.  Wall-clock columns describe the executed program.",
        "",
    ]
    for fam in LABEL:
        rows = fam_rows.get(fam)
        if not rows:
            continue
        lines += [f"## {LABEL[fam]}", "",
                  "| rung | params | step ms | epoch(2014) s | ref GPU s/epoch | speedup | "
                  "mem MB | ref GPU MB | TFLOP/s |",
                  "|---|---|---|---|---|---|---|---|---|"]
        for i, rung in enumerate(RUNG_ORDER):
            e = rows.get(rung)
            if e is None:
                continue
            ref_rt = REF_RUNTIME.get(fam, [nan] * 10)[i]
            ref_mb = REF_MEMORY_MB.get(fam, [nan] * 10)[i]
            spd = ref_rt / e["epoch_s_2014_protocol"] if ref_rt == ref_rt else nan
            mem = memory_mb(e)
            tf = e.get("achieved_tflops")
            alg = e.get("algorithmic_tflops")
            if tf is not None and alg is not None:
                tf = f"{tf:.2f} ({alg:.2f})"
            elif tf is not None:
                tf = f"{tf:.2f}"
            lines.append(
                f"| {rung} | {e['params'] / 1e6:.2f}M | {e['step_s'] * 1e3:.1f} "
                f"| {e['epoch_s_2014_protocol']:.2f} "
                f"| {'' if ref_rt != ref_rt else f'{ref_rt:.2f}'} "
                f"| {'' if spd != spd else f'{spd:.1f}x'} "
                f"| {'' if mem is None else f'{mem:.0f}'} "
                f"| {'' if ref_mb != ref_mb else f'{ref_mb:.0f}'} "
                f"| {'' if tf is None else tf} |"
            )
        lines.append("")

    if bf16_rows:
        lines += ["## Mixed precision (bf16 compute, fp32 master params)", "",
                  "| family | rung | grid | params | step ms | fp32 step ms | gain |",
                  "|---|---|---|---|---|---|---|"]
        for (fam, g), rows in sorted(bf16_rows.items()):
            f32_rows = (fam_rows if g == grid else extra_grids.get(g, {})).get(fam, {})
            for rung in RUNG_ORDER:
                e = rows.get(rung)
                if e is None:
                    continue
                f32 = f32_rows.get(rung, {}).get("step_s")
                gain = f"{f32 / e['step_s']:.2f}x" if f32 else ""
                lines.append(
                    f"| {fam} | {rung} | {g} | {e['params'] / 1e6:.2f}M "
                    f"| {e['step_s'] * 1e3:.1f} "
                    f"| {'' if not f32 else f'{f32 * 1e3:.1f}'} | {gain} |"
                )
        lines.append("")

    for g, fams in sorted(extra_grids.items()):
        lines += [f"## Resolution rung: {g}", "",
                  "| family | rung | params | step ms | mem MB |",
                  "|---|---|---|---|---|"]
        for fam, rows in sorted(fams.items()):
            for rung in RUNG_ORDER:
                e = rows.get(rung)
                if e is None:
                    continue
                mem = memory_mb(e)
                lines.append(
                    f"| {fam} | {rung} | {e['params'] / 1e6:.2f}M "
                    f"| {e['step_s'] * 1e3:.1f} "
                    f"| {'' if mem is None else f'{mem:.0f}'} |"
                )
        lines.append("")
    return lines, fam_rows


def figure(fam_rows: dict, out_png: str) -> None:
    """Runtime and memory over parameters (the reference's figure layout)."""
    from dlwpbench_tpu_torch.evaluation.plots import pyplot

    plt = pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for fam, rows in fam_rows.items():
        xs = [rows[r]["params"] for r in RUNG_ORDER if r in rows]
        y1 = [rows[r]["epoch_s_2014_protocol"] for r in RUNG_ORDER if r in rows]
        y2 = [memory_mb(rows[r]) for r in RUNG_ORDER if r in rows]
        ax1.plot(xs, y1, marker="o", label=LABEL.get(fam, fam))
        if all(v is not None for v in y2):
            ax2.plot(xs, y2, marker="o", label=LABEL.get(fam, fam))
    for ax, ylab in ((ax1, "Seconds per epoch (2014 protocol)"), (ax2, "Memory [MB]")):
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.set_xlabel("#parameters")
        ax.set_ylabel(ylab)
        ax.grid(True, which="both", color="silver", lw=0.5)
    ax1.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ladder", default="outputs/ladder.json")
    ap.add_argument("--out-md", default="outputs/ladder_tables.md")
    ap.add_argument("--out-png", default="outputs/ladder_over_params.png")
    ap.add_argument("--grid", default="32x64")
    args = ap.parse_args(argv)

    with open(args.ladder) as f:
        ladder = json.load(f)
    lines, fam_rows = table_lines(ladder, args.grid)
    os.makedirs(os.path.dirname(args.out_md) or ".", exist_ok=True)
    with open(args.out_md, "w") as f:
        f.write("\n".join(lines))
    print(f"-> {args.out_md}")
    try:
        figure(fam_rows, args.out_png)
        print(f"-> {args.out_png}")
    except ImportError as e:  # the card's machine has no matplotlib
        print(f"ladder figure skipped: matplotlib unavailable ({e})")
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
