"""DDPM noise scheduler of the PDE-Refiner diffusion track (counterpart of
`dlwpbench_tpu/ops/ddpm.py`; the JAX package's stand-in for diffusers'
`DDPMScheduler`):

- `make_refiner_schedule`: the betas `min_noise_std ** (k / K)` for k in
  reversed(range(K + 1)); `make_linear_schedule`: linear betas.  Both are
  computed in fp64 numpy and cast to fp32 once, so the tables equal the
  JAX package's bit for bit;
- `add_noise`: sqrt(acp_t) * sample + sqrt(1 - acp_t) * noise;
- `v_prediction_target`: sqrt(acp_t) * noise - sqrt(1 - acp_t) * sample;
- `subsampled_timesteps`: diffusers' `set_timesteps`, e.g. [800, 600,
  400, 200, 0] for 1000 train timesteps and 5 inference steps;
- `step`: one reverse step with v-prediction and `clip_sample=False`, to
  an explicit previous timestep.

The tables live on the tensors' device (`utils.device.device_constant`,
one copy per schedule and device).  Timesteps are Python ints on the host
(or index tensors on the device), so indexing a table reads nothing back
from the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from dlwpbench_tpu_torch.utils.device import device_constant

Timestep = Union[int, torch.Tensor]


class DDPMSchedule(NamedTuple):
    betas: torch.Tensor  # [T] fp32
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    num_timesteps: int


def _refiner_betas(num_refinement_steps: int, min_noise_std: float) -> np.ndarray:
    K = num_refinement_steps
    return np.array([min_noise_std ** (k / K) for k in reversed(range(K + 1))], np.float64)


def _linear_betas(num_timesteps: int, beta_start: float, beta_end: float) -> np.ndarray:
    return np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64)


def _tables(betas_fn, *args) -> np.ndarray:
    """[3, T] fp32: betas, alphas and their cumulative product, each
    computed in fp64 and then cast."""
    betas = betas_fn(*args)
    alphas = 1.0 - betas
    return np.stack([betas, alphas, np.cumprod(alphas)]).astype(np.float32)


def _schedule(betas_fn, *args, device) -> DDPMSchedule:
    t = device_constant(_tables, betas_fn, *args, device=torch.device(device))
    return DDPMSchedule(t[0], t[1], t[2], int(t.shape[1]))


def make_refiner_schedule(num_refinement_steps: int, min_noise_std: float,
                          device="cpu") -> DDPMSchedule:
    """PDE-Refiner beta schedule (reference `train.py:74-82`)."""
    return _schedule(_refiner_betas, int(num_refinement_steps), float(min_noise_std),
                     device=device)


def make_linear_schedule(num_timesteps: int, beta_start: float = 1e-4, beta_end: float = 0.02,
                         device="cpu") -> DDPMSchedule:
    return _schedule(_linear_betas, int(num_timesteps), float(beta_start), float(beta_end),
                     device=device)


def _extract(arr: torch.Tensor, t: Timestep, ndim: int) -> torch.Tensor:
    """arr[t] shaped to broadcast over an ndim-dim sample: a 0-d tensor for
    an int, [B, 1, ...] for per-sample timesteps [B]."""
    v = arr[t]
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


def add_noise(sched: DDPMSchedule, sample: torch.Tensor, noise: torch.Tensor,
              t: Timestep) -> torch.Tensor:
    acp = _extract(sched.alphas_cumprod, t, sample.ndim)
    return torch.sqrt(acp) * sample + torch.sqrt(1.0 - acp) * noise


def v_prediction_target(sched: DDPMSchedule, sample: torch.Tensor, noise: torch.Tensor,
                        t: Timestep) -> torch.Tensor:
    """v = sqrt(acp) * noise - sqrt(1 - acp) * sample (diffusers v-prediction)."""
    acp = _extract(sched.alphas_cumprod, t, sample.ndim)
    return torch.sqrt(acp) * noise - torch.sqrt(1.0 - acp) * sample


def subsampled_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """diffusers `DDPMScheduler.set_timesteps`: step_ratio = T // K,
    timesteps = (arange(K) * step_ratio)[::-1].  The top level T - 1 is
    never visited (a reference quirk, kept)."""
    step_ratio = num_train_timesteps // num_inference_steps
    return (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int32)


def step(sched: DDPMSchedule, model_output: torch.Tensor, t: int, sample: torch.Tensor,
         generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None,
         prev_t: Optional[int] = None) -> torch.Tensor:
    """One reverse-diffusion step (DDPM ancestral sampling, v-prediction,
    clip_sample=False) from timestep `t` (a Python int) to `prev_t` (t - 1
    by default; t - T // K when inference subsamples K of T timesteps;
    below 0 for the final step, alpha_cumprod_prev = 1).  Adds
    sqrt(posterior variance) x `noise` unless t == 0; with neither `noise`
    nor `generator` it adds nothing at any t: the posterior mean."""
    t = int(t)
    prev_t = t - 1 if prev_t is None else int(prev_t)
    ndim = sample.ndim
    acp_t = _extract(sched.alphas_cumprod, t, ndim)
    acp_prev = (_extract(sched.alphas_cumprod, prev_t, ndim) if prev_t >= 0
                else torch.ones_like(acp_t))
    beta_t = 1.0 - acp_t / acp_prev
    alpha_t = 1.0 - beta_t

    # v-prediction -> predicted x0, then the DDPM posterior mean
    pred_x0 = torch.sqrt(acp_t) * sample - torch.sqrt(1.0 - acp_t) * model_output
    coef_x0 = torch.sqrt(acp_prev) * beta_t / (1.0 - acp_t)
    coef_xt = torch.sqrt(alpha_t) * (1.0 - acp_prev) / (1.0 - acp_t)
    mean = coef_x0 * pred_x0 + coef_xt * sample
    if t <= 0 or (noise is None and generator is None):
        return mean
    if noise is None:
        noise = torch.randn(sample.shape, generator=generator, device=sample.device,
                            dtype=sample.dtype)
    var = torch.clamp(beta_t * (1.0 - acp_prev) / (1.0 - acp_t), min=1e-20)
    return mean + torch.sqrt(var) * noise
