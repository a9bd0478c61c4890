"""The port's DDPM scheduler and diffusion ModernUNet against the JAX
package's, on the CPU.

- the schedule tables and `subsampled_timesteps`: exactly equal (both
  compute in fp64 and cast to fp32 once);
- `add_noise`, `v_prediction_target` and `step` (v-prediction, explicit
  and default previous timestep, with noise and as the posterior mean):
  within 1e-6 of the result's max (fp32 products of the same table
  values, in other orders);
- `DiffModernUNet.single_forward` and its parameter gradients, lat-lon and
  HEALPix: within 1e-4 of each tensor's max (the time embedding at t up
  to 2e5 is bit for bit JAX's at dim 8; `models/modern_unet.py`);
- the rollout fed JAX's own draws (the initial y of each lead step and,
  for the "reference" sampler, one per refinement), for both samplers:
  within 1e-4 of max|JAX's `DiffModernUNet.__call__`| (2 lead steps x 5
  refinements through the denoiser).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_ref as jax_ref
from dlwpbench_tpu.models import modern_unet as jmu
from dlwpbench_tpu.ops import ddpm as jddpm
from dlwpbench_tpu_torch import weights
from dlwpbench_tpu_torch.models import modern_unet as tmu
from dlwpbench_tpu_torch.ops import ddpm as tddpm


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the suite's workers share the
    cores, and a test's extra threads only wait on the other workers."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


OP_RTOL = 1e-6
MODEL_TOL = 1e-4


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(params, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32),
        params)


def _close(got, want, rtol=OP_RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------- the scheduler
@pytest.mark.parametrize("make, args", [
    ("make_refiner_schedule", (1000, 4e-4)),
    ("make_refiner_schedule", (5, 4e-4)),
    ("make_linear_schedule", (1000,)),
    ("make_linear_schedule", (50, 1e-3, 0.05)),
])
def test_schedule_tables_equal_jax(make, args):
    got, want = getattr(tddpm, make)(*args), getattr(jddpm, make)(*args)
    assert got.num_timesteps == want.num_timesteps
    for field in ("betas", "alphas", "alphas_cumprod"):
        t, j = getattr(got, field), np.asarray(getattr(want, field))
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(), j), field


@pytest.mark.parametrize("T, K", [(1001, 5), (1000, 5), (1001, 3), (11, 4), (6, 6)])
def test_subsampled_timesteps_equal_jax(T, K):
    got = tddpm.subsampled_timesteps(T, K)
    assert np.array_equal(got, jddpm.subsampled_timesteps(T, K)) and got.dtype == np.int32
    if (T, K) == (1001, 5):
        assert got.tolist() == [800, 600, 400, 200, 0]


SCHED = (1000, 4e-4)


@pytest.mark.parametrize("t", [0, 137, 999, "per-sample"])
def test_add_noise_and_v_target_match_jax(t):
    sample, noise = _randn(0, 3, 1, 2, 4, 8), _randn(1, 3, 1, 2, 4, 8)
    jt = np.array([0, 500, 999], np.int32) if t == "per-sample" else t
    tt = torch.from_numpy(jt).long() if t == "per-sample" else t
    ts, js = tddpm.make_refiner_schedule(*SCHED), jddpm.make_refiner_schedule(*SCHED)
    a, b = torch.from_numpy(sample), torch.from_numpy(noise)
    _close(tddpm.add_noise(ts, a, b, tt), jddpm.add_noise(js, sample, noise, jt))
    _close(tddpm.v_prediction_target(ts, a, b, tt),
           jddpm.v_prediction_target(js, sample, noise, jt))


@pytest.mark.parametrize("t, prev_t, with_noise", [
    (800, 600, True), (800, 600, False), (200, 0, True), (0, -200, True), (0, -200, False),
    (500, None, True), (1, None, False),
])
def test_step_matches_jax(t, prev_t, with_noise):
    """v-prediction reverse step; without noise (and no generator) the
    posterior mean at every t, as JAX's step with no key."""
    out, sample, noise = _randn(0, 2, 1, 2, 4, 8), _randn(1, 2, 1, 2, 4, 8), _randn(2, 2, 1, 2, 4, 8)
    ts, js = tddpm.make_refiner_schedule(*SCHED), jddpm.make_refiner_schedule(*SCHED)
    want = jddpm.step(js, out, t, sample, noise=noise if with_noise else None, prev_t=prev_t)
    got = tddpm.step(ts, torch.from_numpy(out), t, torch.from_numpy(sample),
                     noise=torch.from_numpy(noise) if with_noise else None, prev_t=prev_t)
    _close(got, want)


def test_step_draws_from_the_generator_only_above_zero():
    ts = tddpm.make_refiner_schedule(*SCHED)
    out, sample = torch.from_numpy(_randn(0, 1, 1, 2, 4)), torch.from_numpy(_randn(1, 1, 1, 2, 4))
    mean = tddpm.step(ts, out, 400, sample, prev_t=200)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    drawn = tddpm.step(ts, out, 400, sample, generator=g1, prev_t=200)
    z = torch.randn(sample.shape, generator=g2)
    explicit = tddpm.step(ts, out, 400, sample, noise=z, prev_t=200)
    assert torch.equal(drawn, explicit) and not torch.equal(drawn, mean)
    g = torch.Generator().manual_seed(5)
    assert torch.equal(tddpm.step(ts, out, 0, sample, generator=g, prev_t=-200),
                       tddpm.step(ts, out, 0, sample, prev_t=-200))
    assert torch.equal(g.get_state(), torch.Generator().manual_seed(5).get_state())


# ---------------------------------------------------------------- the diffusion model
SMALL = dict(constant_channels=2, prescribed_channels=1, prognostic_channels=2,
             hidden_channels=(8, 16), context_size=2, norm=True, num_refinement_step=5)


def _inputs(spatial, B=2, T=4, seed=0):
    return (_randn(seed, B, 1, 2, *spatial), _randn(seed + 1, B, T, 1, *spatial),
            _randn(seed + 2, B, T, 2, *spatial))


def _pair(mesh, spatial, sampler="mean"):
    """(JAX model, its perturbed params, the port model on them), the JAX
    params from an init through `single_forward` (no rollout traced)."""
    const, pres, prog = _inputs(spatial, B=1)
    jcls, tcls = ((jmu.DiffMUNetHPX, tmu.DiffMUNetHPX) if mesh == "healpix"
                  else (jmu.DiffModernUNet, tmu.DiffModernUNet))
    jm = jcls(**SMALL, sampler=sampler)
    params = jax_ref.init(jm, jax.random.PRNGKey(0), const, pres[:, :2], prog[:, :2],
                          prog[:, 2:3], jnp.zeros((1,), jnp.int32), method=jm.single_forward)
    params = _perturbed(_np_tree(params))
    tm = tcls(**SMALL, sampler=sampler)
    weights.load_flax_params(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("mesh, spatial", [("equirectangular", (8, 16)), ("healpix", (12, 4, 4))])
def test_single_forward_and_grads_match_jax(mesh, spatial):
    """The denoiser at timesteps 800 and 999 (t = 1.6e5 and 2.0e5 in the
    embedding), its output and every parameter gradient."""
    jm, params, tm = _pair(mesh, spatial)
    const, pres, prog = _inputs(spatial)
    y, w = _randn(7, 2, 1, 2, *spatial), _randn(8, 2, 2, *spatial)
    k = np.array([800, 999], np.int32)

    def loss_fn(p):
        out = jm.apply(p, const, pres[:, :2], prog[:, :2], y, k, method=jm.single_forward)
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    out = tm.single_forward(*map(torch.from_numpy, (const, pres[:, :2], prog[:, :2], y)),
                            torch.from_numpy(k).long())
    assert out.shape == j_out.shape == (2, 2, *spatial)
    assert np.abs(out.detach().numpy() - j_out).max() <= MODEL_TOL * np.abs(j_out).max()
    (out * torch.from_numpy(w)).sum().backward()
    got = weights.flatten_tree(weights.to_flax_tree(
        tm, {n: p.grad for n, p in tm.named_parameters()}))
    want = weights.flatten_tree(_np_tree(j_grads["params"]))
    assert got.keys() == want.keys()
    for path, g in got.items():
        scale = max(float(np.abs(want[path]).max()), 1e-6)
        assert np.abs(g - want[path]).max() <= MODEL_TOL * scale, path


def _jax_draws(sampler, steps, shape, K=5, T=1001):
    """The draws of JAX's rollout with no rng (PRNGKey(0)): per lead step
    the initial y from a split of the carried key, and for "reference" one
    normal per refinement from fold_in(key, k) (`modern_unet.py:499-536`)."""
    ts = jddpm.subsampled_timesteps(T, K)
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(steps):
        key, knoise = jax.random.split(key)
        step = [jax.random.normal(knoise, shape, jnp.float32)]
        if sampler == "reference":
            step += [jax.random.normal(jax.random.fold_in(key, int(k)), shape, jnp.float32)
                     for k in ts]
        draws.append([torch.from_numpy(np.array(d)) for d in step])
    return draws


@pytest.mark.parametrize("sampler", ["mean", "reference"])
def test_rollout_with_jax_draws_matches_jax(sampler):
    """Two lead steps of 5 refinements each on 8 x 16, batch 2."""
    spatial = (8, 16)
    jm, params, tm = _pair("equirectangular", spatial, sampler)
    const, pres, prog = _inputs(spatial)
    want = np.asarray(jax.jit(jm.apply)(params, const, pres, prog))
    got = tm(*map(torch.from_numpy, (const, pres, prog)),
             noise=_jax_draws(sampler, 2, (2, 1, 2, *spatial)))
    assert got.shape == want.shape == (2, 2, 2, *spatial)
    assert np.abs(got.detach().numpy() - want).max() <= MODEL_TOL * np.abs(want).max()


def test_rollout_draws_are_seeded_and_the_sampler_checked():
    """With no generator and no noise, every call draws from a generator
    seeded 0 (deterministic, as JAX's PRNGKey(0) fallback); a generator
    changes the draws; an unknown sampler raises when called, as in JAX."""
    const, pres, prog = map(torch.from_numpy, _inputs((4, 8), B=1))
    tm = tmu.DiffModernUNet(**SMALL, sampler="reference", seed=1)
    with torch.no_grad():
        for p in tm.parameters():  # a net that is not zero at init
            p.add_(0.01)
        a, b = tm(const, pres, prog), tm(const, pres, prog)
        c = tm(const, pres, prog, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()
    tm.sampler = "ddim"
    with pytest.raises(ValueError, match="sampler='ddim'"):
        tm(const, pres, prog)


def test_bf16_denoiser_runs_in_fp32_from_the_first_block():
    """JAX's promotion rule: with bf16 parameters and inputs the fp32 time
    embedding makes the trunk fp32, so `single_forward` returns fp32 (as
    flax's does); the plain ModernUNet stays bf16."""
    const, pres, prog = _inputs((8, 16), B=1)
    tm = tmu.DiffModernUNet(**SMALL).to(torch.bfloat16)
    args = [torch.from_numpy(a).bfloat16() for a in (const, pres[:, :2], prog[:, :2], prog[:, 2:3])]
    assert tm.single_forward(*args, torch.tensor([400])).dtype == torch.float32
    jm = jmu.DiffModernUNet(**SMALL)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (const, pres[:, :2], prog[:, :2], prog[:, 2:3])]
    jp = jm.init(jax.random.PRNGKey(0), *jargs, jnp.array([400]), method=jm.single_forward)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    assert jm.apply(jp, *jargs, jnp.array([400]), method=jm.single_forward).dtype == jnp.float32
    mu = tmu.ModernUNet(**{k: v for k, v in SMALL.items() if k != "num_refinement_step"})
    with torch.no_grad():
        out = mu.to(torch.bfloat16)(*[torch.from_numpy(a).bfloat16() for a in (const, pres, prog)])
    assert out.dtype == torch.bfloat16
