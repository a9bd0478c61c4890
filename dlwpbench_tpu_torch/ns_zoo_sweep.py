"""Train and evaluate the model families on the Navier-Stokes track
(counterpart of `scripts/ns_zoo_sweep.py`).

The synthetic Navier-Stokes benchmark (`configs/data/navier_stokes.yaml`;
the solver `data/ns2d.py`) generates its own data on the device, so it
drives each architecture's whole train -> checkpoint -> evaluate chain
without external data.  For each family this sweep runs, from the
repository root,

    python -m dlwpbench_tpu_torch.train model=<group> model.name=ns_<family> \\
        data=navier_stokes training.epochs=<epochs> ... --device <device>
    python -m dlwpbench_tpu_torch.build_baselines -c outputs/ns_<family> \\
        --sequence-length <seq-eval> --device <device>
    python -m dlwpbench_tpu_torch.evaluate -c outputs/ns_<family> \\
        --sequence-length <seq-eval> --batch-size 8 --device <device>

with JAX's overrides (`FAMILIES`, `COMMON`), and snapshots
`train_tail.log`, `eval.log`, `metrics.json` and
`persistence_metrics.json` into `<root>/ns_<family>/` (default
`outputs/`, the run directory itself; JAX writes them under `results/`),
then prints whether the model beats persistence.

    python -m dlwpbench_tpu_torch.ns_zoo_sweep [--families fno,sfno,...] [--epochs 25]
        [--seq-eval 8] [--root outputs] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAMILIES = {
    # family -> (model config group, extra overrides)
    "fno": ("fno", []),
    "sfno": ("sfno", []),
    "fourcastnet": ("fourcastnet", []),
    "swin": ("swintransformer", []),
    # 64x64 NS has 8x Pangu's token count at 5.625 degrees; batch 8 keeps
    # the remat attention temporaries small
    "pangu": ("panguweather", ["training.batch_size=8"]),
    "mgn": ("meshgraphnet", []),
    "modernunet": ("modernunet", []),
    "fcnv2": ("fourcastnetv2", []),
    # the PDE-Refiner diffusion track: v-prediction training needs
    # sequence_length == context_size + 1 = 3; evaluation runs the whole
    # DDPM refinement loop a lead step.  The 80M denoiser wants more data
    # and epochs than the deterministic families, and sparse checkpoints
    "diffusion": ("diffusion_modernunet", [
        "training=diffusion",
        "training.sequence_length=3",
        "validation.sequence_length=3",
        "data.n_trajectories=64",
        "training.epochs=250",
        "training.checkpoint_every=25",
    ]),
    # the WeatherBench-scale default (512 hidden x 16 layers) is oversized
    # for the 64x64 single-channel track; the other families' scale
    "graphcast": ("graphcast", ["model.hidden_dim=128", "model.processor_layers=6"]),
}

COMMON = [
    "data=navier_stokes",
    "training.epochs={epochs}",
    "training.batch_size=16",
    "training.sequence_length=4",
    "validation.sequence_length=4",
    "testing.sequence_length=8",
]


def run(cmd) -> str:
    """Run `cmd` from the repository root; its output, or RuntimeError."""
    print("+", " ".join(cmd), flush=True)
    res = subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        print(res.stdout[-4000:])
        raise RuntimeError(f"{cmd} failed rc={res.returncode}")
    return res.stdout


def overrides_of(family: str, epochs: int) -> list[str]:
    """The train entry's overrides for a family: JAX's, in JAX's order."""
    group, extra = FAMILIES[family]
    return ([f"model={group}", f"model.name=ns_{family}"]
            + [o.format(epochs=epochs) for o in COMMON] + extra)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--seq-eval", type=int, default=8)
    ap.add_argument("--root", default="outputs",
                    help="where the snapshots go, under the repository root")
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    args = ap.parse_args(argv)

    py = sys.executable
    for fam in args.families.split(","):
        name = f"ns_{fam}"
        res_dir = os.path.join(REPO, args.root, name)
        os.makedirs(res_dir, exist_ok=True)

        out = run([py, "-m", "dlwpbench_tpu_torch.train", *overrides_of(fam, args.epochs),
                   "--device", args.device])
        tail = "\n".join(out.strip().splitlines()[-12:])
        with open(os.path.join(res_dir, "train_tail.log"), "w") as f:
            f.write(tail + "\n")

        run_dir = os.path.join(REPO, "outputs", name)
        out = run([py, "-m", "dlwpbench_tpu_torch.build_baselines", "-c", run_dir,
                   "--sequence-length", str(args.seq_eval), "--device", args.device])
        out2 = run([py, "-m", "dlwpbench_tpu_torch.evaluate", "-c", run_dir,
                    "--sequence-length", str(args.seq_eval), "--batch-size", "8",
                    "--device", args.device])
        with open(os.path.join(res_dir, "eval.log"), "w") as f:
            f.write(out + "\n" + out2)

        for src, dst in [
            (os.path.join(run_dir, "evaluation", "metrics.json"),
             os.path.join(res_dir, "metrics.json")),
            (os.path.join(REPO, "outputs", "persistence", "evaluation", "metrics.json"),
             os.path.join(res_dir, "persistence_metrics.json")),
        ]:
            if os.path.exists(src) and os.path.abspath(src) != os.path.abspath(dst):
                shutil.copy(src, dst)

        # one line of skill for the sweep's log
        try:
            with open(os.path.join(res_dir, "metrics.json")) as f:
                m = json.load(f)
            with open(os.path.join(res_dir, "persistence_metrics.json")) as f:
                p = json.load(f)
            v = sorted(m["rmse"])[0]
            mean_m = sum(m["rmse"][v]) / len(m["rmse"][v])
            mean_p = sum(p["rmse"][v]) / len(p["rmse"][v])
            print(f"[{fam}] mean RMSE {mean_m:.4f} vs persistence {mean_p:.4f} -> "
                  f"{'BEATS' if mean_m < mean_p else 'DOES NOT BEAT'}", flush=True)
        except (OSError, KeyError, ValueError, IndexError, ZeroDivisionError) as e:
            print(f"[{fam}] skill summary unavailable: {e}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
