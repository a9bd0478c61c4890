"""Training CLI of the port (counterpart of `scripts/train.py`):

    python -m dlwpbench_tpu_torch.train model=swintransformer data=synthetic \
        [key=value ...] [--device cuda]

Composes `configs/` with Hydra-style overrides, builds the model from the
registry (seeded random init from the config's `seed`; per-step
rematerialisation on unless `model.remat=false`), builds the datasets (a
Navier-Stokes source solves on the same device) and
the latitude weights, and trains with TF32 off (AdamW, cosine LR, gradient
clipping to the LR): in fp32, or with `training.compute_dtype=bfloat16`
in bf16 compute over fp32 master parameters (the forward and backward in
bf16; the loss, gradients, optimizer state, validation and checkpoints in
fp32).  `training=diffusion` trains a diffusion model (`model=
diffusion_modernunet`) on the v-prediction objective with an EMA of its
parameters, checkpointed beside them.  Writes `config.yaml`, `metrics.jsonl` and,
with `training.save_model`, best/last checkpoints under `run_dir`;
`training.continue_training` resumes from the last checkpoint.  Prints the
JAX CLI's line per epoch.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dlwpbench_tpu_torch import resolve_device
from dlwpbench_tpu_torch.data.sources import build_datasets
from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.training.config import load_config, save_config
from dlwpbench_tpu_torch.training.losses import latitude_weights
from dlwpbench_tpu_torch.training.trainer import Trainer, load_checkpoint

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs"
)


def _check_scope(cfg) -> None:
    """Raise on training features this port does not have yet."""
    if int(cfg.training.get("data_parallel", 0) or 0) > 1:
        raise NotImplementedError(
            "training.data_parallel > 1 is not ported to PyTorch yet "
            "(ROADMAP queue A, item 16)"
        )
    if bool(cfg.training.get("multihost", False)):
        raise NotImplementedError(
            "training.multihost is not ported to PyTorch yet (ROADMAP queue A, item 16)"
        )


def train(overrides: list[str], device: str = "cuda") -> dict:
    """Run the training; returns the final `state`, per-epoch `train_loss`
    and `val_loss`, the per-step `step_seconds` [(samples, seconds)] and
    the `device`."""
    dev = resolve_device(device)
    # fp32 means fp32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = load_config(CONFIG_DIR, overrides=overrides)
    if not int(cfg.training.sequence_length) > int(cfg.model.context_size):
        raise ValueError("No time steps to predict, increase the prediction window.")
    _check_scope(cfg)
    # rematerialise rollout steps in training (activation memory O(step)
    # instead of O(rollout)); override with model.remat=false
    if "remat" not in cfg.model:
        cfg.model["remat"] = True
    model = registry.build_model(cfg.model, seed=int(cfg.get("seed", 1234)),
                                 grid_shape=registry.data_grid_shape(cfg.data)).to(dev)
    ctx = int(cfg.model.context_size)
    train_ds, val_ds, _, _ = build_datasets(
        cfg.data, cfg.training, cfg.validation, cfg.get("testing"), ctx, device=dev
    )

    lat_w = None  # lat-weighted validation on the lat-lon grids
    if (
        cfg.data.get("type") != "NavierStokes"
        and cfg.data.get("healpix_nside") in (None, "null")
        and "height" in cfg.data
    ):
        h = int(cfg.data.height)
        lats = np.linspace(-90 + 180 / h / 2, 90 - 180 / h / 2, h)
        lat_w = latitude_weights(lats)[:, None]

    trainer = Trainer(
        model,
        learning_rate=float(cfg.training.learning_rate),
        weight_decay=float(cfg.training.optimizer_weight_decay),
        epochs=int(cfg.training.epochs),
        clip_gradients=bool(cfg.training.clip_gradients),
        gradient_accumulation_steps=int(cfg.training.gradient_accumulation_steps),
        lat_weights=lat_w,
        training_type=str(cfg.training.get("type", "regular")),
        compute_dtype=cfg.training.get("compute_dtype"),
        seed=int(cfg.get("seed", 1234)),
        num_refinement_steps=int(cfg.training.get("num_refinement_steps", 5)),
        min_noise_std=float(cfg.training.get("min_noise_std", 4e-4)),
        ema_decay=float(cfg.training.get("ema_decay", 0.995)),
    )
    state = trainer.init()
    if cfg.verbose:
        print(f"Model {cfg.model.name} has {trainer.n_params(state)} trainable "
              f"parameters (device {dev})")

    run_dir = cfg.get("run_dir") or os.path.join("outputs", cfg.model.name)
    os.makedirs(run_dir, exist_ok=True)
    save_config(cfg, os.path.join(run_dir, "config.yaml"))
    if cfg.training.continue_training:
        state = load_checkpoint(run_dir, cfg.model.name, state, kind="last")
        print(f"Restored epoch {state.epoch}")

    history: dict[str, list] = {"train_loss": [], "val_loss": []}

    def record(_state, train_loss, val_loss, _per_lead):
        history["train_loss"].append(train_loss)
        history["val_loss"].append(val_loss)

    trainer.fit(
        state,
        train_ds,
        val_ds,
        batch_size=int(cfg.training.batch_size),
        val_batch_size=int(cfg.validation.batch_size),
        run_dir=run_dir if cfg.training.save_model else None,
        model_name=cfg.model.name,
        verbose=bool(cfg.verbose),
        on_epoch_end=record,
        checkpoint_every=int(cfg.training.get("checkpoint_every", 1)),
    )
    return {**history, "state": state, "step_seconds": trainer.timings,
            "run_dir": run_dir, "device": str(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m dlwpbench_tpu_torch.train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("overrides", nargs="*",
                    help="config overrides: group=name or a.b.c=value")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return train(args.overrides, args.device)


if __name__ == "__main__":
    main()
