"""Training throughput of the benchmark zoo, comparable to the reference's
measured runtime and memory tables (counterpart of
`scripts/benchmark_training.py`).

Measures the remat train step (forward, backward, AdamW; the ladder's
harness, `benchmark_ladder.measure`) at the reference's training protocol
(sequence length 15 -> 14 predicted frames) at batch 32 and reports the
equivalent seconds an epoch of the 1979-2014 split (3,505 windows), the
card's peak memory and the step's FLOPs.

    python -m dlwpbench_tpu_torch.benchmark_training [--models unet,...] [--batch 32]
        [--dtype bfloat16] [--repeats 4] [--iters 3] [--out-dir outputs] [--device cpu]

Writes `<out-dir>/benchmark_training.json` (`_bf16.json` with `--dtype
bfloat16`): {"batch", "seq", "results"}, each model's `params`,
`train_step_s`, `epoch_equivalent_s`, `compile_s` (the first eager call's
seconds), `peak_mb` on the card, `flops_per_step` and `achieved_tflops`,
merged with the models the file already holds.  A model that fails is
recorded as `{"error": ...}`.  The diffusion model takes its training
protocol, one v-prediction `single_forward` step (`measure_diffusion`).
`--device` is the card unless it is `cpu`; without a card the default
raises.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

WINDOWS_PER_EPOCH = 3505  # 1979-2014, 6-hourly, non-overlapping seq-15 windows
NUM_TIMESTEPS, MIN_NOISE_STD = 1000, 4e-4  # JAX's schedule for this step


def prepare_diffusion_step(model, arrays, device, compute_dtype=None, params=None, draws=None):
    """A function `chained(repeats)` running `repeats` diffusion train
    steps (JAX's `measure_diffusion` body, `scripts/benchmark_training.py:
    24-118`) and returning their summed loss: each step the residual target
    noised at a timestep k, denoised by `single_forward` from the context
    window, the MSE against the v target, AdamW (lr 1e-3, weight decay
    1e-5, no clipping) on the fp32 masters.  `draws` is a list of (k,
    noise) for the steps in order (as JAX draws them, so a test can pass
    them in); without it the trainer draws k on the host and the noise on
    `device` from its seeded generators.  `params` a flax tree to start
    from.  The refiner schedule has JAX's 1,000 steps and 4e-4 noise floor."""
    from dlwpbench_tpu_torch.benchmark_ladder import LR, WEIGHT_DECAY
    from dlwpbench_tpu_torch.training.trainer import Trainer

    model.to(device).train()
    const, pres, prog, _ = (torch.as_tensor(np.asarray(a), device=device) for a in arrays)
    ctx = model.context_size
    prog_w = prog[:, : ctx + 1]  # the diffusion window: the context and one target
    pres_w = pres[:, :ctx] if pres.shape[2] else None
    batch = (const, pres_w, prog_w, prog_w[:, ctx:])
    trainer = Trainer(model, learning_rate=LR, weight_decay=WEIGHT_DECAY, clip_gradients=False,
                      compute_dtype=compute_dtype, training_type="diffusion",
                      num_refinement_steps=NUM_TIMESTEPS, min_noise_std=MIN_NOISE_STD)
    state = trainer.init(params)
    state.ema = None  # the step updates no EMA (JAX's measures none)
    step = iter(draws or ())

    def chained(repeats: int) -> torch.Tensor:
        total = torch.zeros((), device=device)
        for _ in range(repeats):
            k, noise = next(step, (None, None))
            if noise is not None:
                noise = torch.as_tensor(np.array(noise), device=device)
            total = total + trainer.train_step(state, batch, LR, k=k, noise=noise)
        return total

    return chained


def measure_diffusion(model, arrays, device, compute_dtype=None, repeats=4, iters=3,
                      params=None, draws=None):
    """The diffusion model's train step at its real protocol (one
    v-prediction `single_forward` and AdamW a step, not the refinement
    rollout, which is inference only), timed as `benchmark_ladder.measure`
    times its steps: (seconds a step, the first call's seconds, memory,
    parameters)."""
    from dlwpbench_tpu_torch.benchmark_ladder import count_params, time_chained

    chained = prepare_diffusion_step(model, arrays, device, compute_dtype, params, draws)
    step_s, first_s, mem = time_chained(chained, device, repeats, iters)
    return step_s, first_s, mem, count_params(model)


def main(argv=None) -> dict:
    from dlwpbench_tpu_torch.benchmark_ladder import count_params, measure, synthetic_arrays
    from dlwpbench_tpu_torch.benchmark_models import merge_into, model_zoo
    from dlwpbench_tpu_torch.utils.device import entry_device, no_tf32

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default="unet,modernunet,fno2d,fourcastnet,sfno2d")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=15)
    ap.add_argument("--dtype", default=None, choices=(None, "bfloat16"),
                    help="mixed-precision compute dtype (bf16 compute, fp32 master params — "
                         "the trainer's recipe); results go to benchmark_training_bf16.json")
    ap.add_argument("--repeats", type=int, default=4,
                    help="train steps between two synchronisations (JAX's scan length)")
    ap.add_argument("--iters", type=int, default=3, help="timed groups of --repeats steps")
    ap.add_argument("--out-dir", default="outputs")
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    args = ap.parse_args(argv)

    device = entry_device(args.device, "benchmark_training")
    no_tf32()
    card = device.type == "cuda"
    B, T = args.batch, args.seq
    H, W, Cc, Cp, Cq = 32, 64, 4, 1, 8
    keep = set(args.models.split(","))
    zoo = {k: v for k, v in model_zoo(B, H, W, Cc, Cp, Cq).items() if k in keep}
    arrays = synthetic_arrays(B, T, (H, W), Cc, Cp, Cq)

    results = {}
    for name, make in zoo.items():
        try:
            model = make()
            if name == "diffusion":  # the training protocol: one denoiser step, no rollout
                dt, compile_s, mem, n_params = measure_diffusion(
                    model, arrays, device, args.dtype, args.repeats, args.iters)
            else:
                n_params = count_params(model)
                dt, compile_s, mem = measure(model, arrays, device, args.repeats, args.iters,
                                             args.dtype)
            epoch_s = dt * (WINDOWS_PER_EPOCH / B)
            results[name] = {"params": n_params, "train_step_s": round(dt, 4),
                             "epoch_equivalent_s": round(epoch_s, 2),
                             "compile_s": round(compile_s, 1), **mem}
            if name == "diffusion":
                results[name]["note"] = (
                    "v-prediction single_forward train step (reference train.py:226-258 "
                    "protocol); inference pays the DDPM refinement loop instead — see "
                    "benchmark_matrix.json")
            peak = mem.get("peak_mb")
            print(f"{name:12s} {n_params / 1e6:6.2f}M  step {dt * 1e3:7.1f} ms (batch {B})  "
                  f"~{epoch_s:7.1f} s/epoch" + (f"  mem {peak:.0f} MB" if peak else ""),
                  flush=True)
            del model
        except Exception as e:  # a failing model is a row, as in JAX
            results[name] = {"error": f"{type(e).__name__}: {e}"}
            print(f"{name:12s} FAILED: {type(e).__name__}: {e}", flush=True)
        if card:
            torch.cuda.empty_cache()

    out = os.path.join(args.out_dir, "benchmark_training_bf16.json" if args.dtype
                       else "benchmark_training.json")
    payload = {"batch": B, "seq": T,
               "device": torch.cuda.get_device_name(device) if card else "cpu",
               "results": results}
    if args.dtype:
        payload["compute_dtype"] = args.dtype
    payload = merge_into(out, payload)
    print(f"-> {out}")
    return payload


if __name__ == "__main__":
    main(sys.argv[1:])
