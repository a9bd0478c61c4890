"""The ladder's step harness (`benchmark_ladder.prepare_step`,
`benchmark_training.prepare_diffusion_step`) and its FLOP count against
JAX's `scripts/benchmark_ladder.py` and `scripts/benchmark_training.py`, on
the CPU (the entry points' CLIs: `tests/test_torch_ladder.py`).

- the chained remat train steps on JAX's init (`weights.load_flax_params`)
  give the summed loss of JAX's `_prepare_step` chained over 2 steps, at
  batch 1, sequence length 4 on a 16 x 32 grid: within 1e-4 relative in
  fp32 (the forward and backward sum in another order), 2e-3 in bf16
  compute (`LOSS_RTOL`: bf16 products rounded in another order).  JAX's
  Swin runs its plain attention (the flash kernel's parity has its own
  tests), as the port does on the CPU;
- the diffusion step with JAX's draws of k and the noise (`jax.random` as
  `measure_diffusion` splits its key) passed to both sides;
- FLOPs of `unet@50k`'s train step: JAX's `step_flops` (XLA's cost model
  times the trips) holds the rollout's forward products only (the
  backward loop's body is not in the count: within 1% of the forward's
  count).  So the port's count is held in two parts: its forward within
  `FWD_RTOL` of JAX's forward (the two count different elementwise ops:
  XLA's cost model adds activations, bias adds and pads, which at the 50k
  rung's width 10 are a few percent of the convolutions), and its train
  step at 3.5 .. 4.0 forwards (the remat recompute, and the backward's two
  products per convolution, less the first layer's input gradient).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_ref as jax_ref
from dlwpbench_tpu_torch import benchmark_ladder as TL
from dlwpbench_tpu_torch import benchmark_training as TB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import benchmark_ladder as JL  # noqa: E402  (the JAX script)

Cc, Cp, Cq = 4, 1, 8
FP32_RTOL = 1e-4
LOSS_RTOL = 2e-3
FWD_RTOL = 0.05
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the ops here are small, and the
    suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(T=4, spatial=(16, 32)):
    return TL.synthetic_arrays(1, T, spatial, Cc, Cp, Cq)


@pytest.mark.parametrize("family,width,dtype", [
    ("unet", 4, None), ("swin", 8, None), ("convlstm", 8, None),
    ("unet", 4, "bfloat16"), ("swin", 8, "bfloat16"), ("convlstm", 8, "bfloat16"),
])
def test_chained_step_loss_equals_jax(family, width, dtype):
    """Two chained remat train steps from JAX's init: the summed losses.
    The second step's loss follows the first AdamW update, so the sum
    holds the optimizer too."""
    arrays = _arrays()
    H, W = arrays[0].shape[-2:]
    jmodel = JL.build(family, width, H, W, Cc, Cp, Cq)
    if family == "swin":
        jmodel = jmodel.clone(use_flash_attention=False)
    cpu = jax.devices("cpu")[0]
    chained, args = JL._prepare_step(jmodel, arrays, cpu, cpu, dtype, repeats=2)
    want = float(jax.jit(chained)(*args))
    tmodel = TL.build(family, width, H, W, Cc, Cp, Cq)
    if family == "swin":
        assert tmodel.embed_dim == 8 and tuple(tmodel.num_heads) == (1, 2)
    got = float(TL.prepare_step(tmodel, arrays, CPU, dtype,
                                params=jax.tree.map(np.asarray, args[0]))(2))
    assert tmodel.remat
    rtol = LOSS_RTOL if dtype else FP32_RTOL
    print(f"{family} {dtype or 'float32'}: port {got:.7f} JAX {want:.7f} "
          f"rel {abs(got - want) / abs(want):.2e}")
    assert abs(got - want) <= rtol * abs(want)


def _jax_diffusion_losses(model, arrays, repeats):
    """JAX's `measure_diffusion` step (`scripts/benchmark_training.py:37-90`)
    chained `repeats` times from its init and key 1: (summed loss, params,
    the draws (k, noise) in order)."""
    import optax

    from dlwpbench_tpu.ops import ddpm as ddpm_ops

    const, pres, prog, _ = (jnp.asarray(a) for a in arrays)
    ctx = model.context_size
    prog_w, pres_w = prog[:, : ctx + 1], pres[:, :ctx]
    target = prog_w[:, ctx:]
    sched = ddpm_ops.make_refiner_schedule(1000, 4e-4)
    params = jax_ref.init(model, jax.random.PRNGKey(0), const, pres_w, prog_w[:, :ctx],
                          jnp.zeros_like(target), jnp.zeros((1,), jnp.int32),
                          method="single_forward")
    tx = optax.adamw(1e-3, weight_decay=1e-5)
    opt_state = tx.init(params)

    @jax.jit
    def step(p, o, k, noise):
        res = target - prog_w[:, ctx - 1: ctx]
        y = ddpm_ops.add_noise(sched, res, noise, k)
        v_t = ddpm_ops.v_prediction_target(sched, res, noise, k)

        def loss_fn(pp):
            out = model.apply(pp, const, pres_w, prog_w[:, :ctx], y, jnp.full((1,), k),
                              method="single_forward")
            return ((out[:, None] - v_t) ** 2).mean()

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    rng, draws, total = jax.random.PRNGKey(1), [], 0.0
    p, o = params, opt_state
    for _ in range(repeats):
        rng, kk, kn = jax.random.split(rng, 3)
        k = jax.random.randint(kk, (), 0, sched.num_timesteps - 1)
        noise = jax.random.normal(kn, target.shape, target.dtype)
        p, o, loss = step(p, o, k, noise)
        total += float(loss)
        draws.append((int(k), np.array(noise)))
    return total, params, draws


def test_diffusion_step_loss_with_jax_draws():
    arrays = _arrays()
    jmodel = JL.build("diffusion", 8, 16, 32, Cc, Cp, Cq)
    want, params, draws = _jax_diffusion_losses(jmodel, arrays, 2)
    tmodel = TL.build("diffusion", 8, 16, 32, Cc, Cp, Cq)
    got = float(TB.prepare_diffusion_step(tmodel, arrays, CPU,
                                          params=jax.tree.map(np.asarray, params),
                                          draws=draws)(2))
    print(f"diffusion: port {got:.7f} JAX {want:.7f} rel {abs(got - want) / abs(want):.2e}; "
          f"k {[k for k, _ in draws]}")
    assert abs(got - want) <= FP32_RTOL * abs(want)


def test_step_flops_of_unet_50k_against_jax():
    arrays = _arrays(T=3, spatial=(32, 64))
    w, _ = TL.solve_width("unet", TL.RUNGS["50k"], 32, 64, Cc, Cp, Cq, None)
    jmodel = JL.build("unet", w, 32, 64, Cc, Cp, Cq)
    trips = 3 - jmodel.context_size
    cpu = jax.devices("cpu")[0]
    want = JL.step_flops(jmodel, arrays, cpu, None, trips)
    const, pres, prog = (jnp.asarray(a) for a in arrays[:3])
    params = jax_ref.init(jmodel, jax.random.PRNGKey(0), const, pres, prog)
    cost = jax.jit(lambda p: jmodel.apply(p, const, pres, prog)).lower(params).compile(
    ).cost_analysis()
    jax_fwd = float((cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"]) * trips
    assert abs(want / jax_fwd - 1.0) <= 0.01  # JAX's step count: the forward's alone

    from torch.utils.flop_counter import FlopCounterMode

    tmodel = TL.build("unet", w, 32, 64, Cc, Cp, Cq)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        tmodel(*(torch.from_numpy(a) for a in arrays[:3]))
    fwd = counter.get_total_flops()
    got, attention = TL.step_flops(TL.prepare_step(tmodel, arrays, CPU))
    print(f"unet@50k (width {w}): port step {got:.0f}, port forward {fwd:.0f}, JAX step "
          f"{want:.0f}, JAX forward {jax_fwd:.0f}; step/forward {got / fwd:.4f}")
    assert attention == 0
    assert abs(fwd / jax_fwd - 1.0) <= FWD_RTOL
    assert 3.5 <= got / fwd <= 4.0
