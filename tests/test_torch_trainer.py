"""The port's trainer against the JAX package's, on the CPU.

Both sides start from one JAX init (loaded into the port through
`load_flax_params`) and take the same numpy batches.  The model is a small
Swin on a 4x8 grid with plain attention on both sides (the kernels have
their own tests); what is held here is the trainer: the loss, AdamW, the
cosine LR, clipping to the LR, accumulation with a remainder, validation,
checkpoints and the CLI.

Tolerances, fp32:
- per-step losses: rtol 1e-5 (the forward sums in another order);
- parameters after 3 steps: max|diff| per tensor under 1e-5 = lr / 100.
  Adam moves each parameter by about lr a step, so a wrong update to any
  one tensor (a wrong sign, a missed decay, a skipped leaf) fails.  Adam
  divides by |g|, and an element whose gradient were at rounding level in
  both frameworks could move by up to +-lr in either direction; this
  model has none (the worst tensor differs by 5e-7 after 3 steps), so no
  element gets that allowance;
- validation errors per lead and channel: rtol 1e-5.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_ref as jax_ref
from dlwpbench_tpu.data.dataset import WindowedWeatherDataset as JDataset
from dlwpbench_tpu.models import swin as jswin
from dlwpbench_tpu.training import trainer as jtr
from dlwpbench_tpu_torch import weights
from dlwpbench_tpu_torch.data.dataset import WindowedWeatherDataset as TDataset
from dlwpbench_tpu_torch.models import swin as tswin
from dlwpbench_tpu_torch.training import trainer as ttr
from dlwpbench_tpu_torch.training.losses import latitude_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(img_height=4, img_width=8, constant_channels=2, prescribed_channels=1,
           prognostic_channels=2, embed_dim=8, depths=(2, 2), num_heads=(2, 2),
           use_flash_attention=False)
LR = 1e-3
PARAM_ATOL = LR / 100


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the ops here are small, and the
    suite's workers share the cores (each extra thread only waits on the
    others)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(T=64, seed=0):
    rng = np.random.default_rng(seed)
    H, W = CFG["img_height"], CFG["img_width"]
    prog = np.cumsum(0.3 * rng.standard_normal((T, CFG["prognostic_channels"], H, W)),
                     axis=0).astype(np.float32)
    pres = rng.standard_normal((T, CFG["prescribed_channels"], H, W)).astype(np.float32)
    const = rng.standard_normal((CFG["constant_channels"], H, W)).astype(np.float32)
    return dict(prognostic=prog, prescribed=pres, constants=const, sequence_length=3,
                context_size=1, seed=4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lat_w():
    h = CFG["img_height"]
    return latitude_weights(np.linspace(-90 + 180 / h / 2, 90 - 180 / h / 2, h))[:, None]


@functools.lru_cache(maxsize=None)
def _jax_init():
    """JAX's trainer init of the Swin (its seed, the first batch), once for
    the tests that start from it."""
    jt = jtr.Trainer(jswin.SwinTransformer(**CFG), lat_weights=_lat_w())
    return _np_tree(jt.init(next(iter(JDataset(**_arrays()).batches(1)))).params)


def _pair(accum=1):
    """(JAX trainer, its state, port trainer, its state) from one init."""
    jmodel = jswin.SwinTransformer(**CFG)
    jt = jtr.Trainer(jmodel, learning_rate=LR, epochs=5, gradient_accumulation_steps=accum,
                     lat_weights=_lat_w())
    params = jax.tree_util.tree_map(jnp.asarray, _jax_init())
    jstate = jtr.TrainState(params=params, opt_state=jt.tx.init(params), ema_params=None)
    tt = ttr.Trainer(tswin.SwinTransformer(**CFG), learning_rate=LR, epochs=5,
                     gradient_accumulation_steps=accum, lat_weights=_lat_w())
    tstate = tt.init(params=_jax_init())
    return jt, jstate, tt, tstate


def test_cosine_lr_matches_jax():
    # JAX takes the cosine in fp32: 1 + cos rounds to ~1e-7 of 2, times
    # base_lr / 2, so atol 1e-10 absolute beside rtol 1e-6
    for epoch in (0, 1, 7, 29, 30):
        np.testing.assert_allclose(ttr.cosine_lr(epoch, 1e-3, 30),
                                   float(jtr.cosine_lr(epoch, 1e-3, 30)),
                                   rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("max_norm", [1e-3, 1e3])  # clipping, and none
def test_clip_grads_to_matches_jax(max_norm):
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want, want_norm = jtr.clip_grads_to([jnp.asarray(g) for g in grads], max_norm)
    ts = [torch.from_numpy(g.copy()) for g in grads]
    norm = ttr.clip_grads_to(ts, max_norm)
    np.testing.assert_allclose(norm.item(), float(want_norm), rtol=1e-6)
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6, atol=1e-12)


def test_shuffled_batches_match_jax_index_for_index():
    jds, tds = JDataset(**_arrays()), TDataset(**_arrays())
    for _ in range(2):  # two epochs: the generator carries over
        for jb, tb in zip(jds.batches(4, shuffle=True), tds.batches(4, shuffle=True)):
            for a, b in zip(jb, tb):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("accum, batch", [(1, 4), (2, 5)], ids=["accum1", "accum2-rem"])
def test_three_steps_match_jax(accum, batch):
    jt, jstate, tt, tstate = _pair(accum)
    ds = TDataset(**_arrays())
    batches = list(ds.batches(batch))[:3]
    lr = ttr.cosine_lr(0, LR, 5)
    params, opt_state = jstate.params, jstate.opt_state
    j_losses, t_losses = [], []
    for b in batches:
        params, opt_state, loss = jt._train_step(
            params, opt_state, *(None if x is None else jnp.asarray(x) for x in b),
            jnp.float32(lr), jax.random.PRNGKey(0))
        j_losses.append(float(loss))
        t_losses.append(tt.train_step(tstate, tt._to_device(b), lr).item())
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)

    got = weights.flatten_tree(weights.to_flax_tree(tstate.model))
    want = weights.flatten_tree(_np_tree(params["params"]))
    assert got.keys() == want.keys()
    for path, g in got.items():
        d = np.abs(g - want[path]).max()
        assert d <= PARAM_ATOL, (path, float(d))


def test_validate_matches_jax():
    jt, jstate, tt, tstate = _pair()
    ds = TDataset(**{**_arrays(), "sequence_length": 4})
    jds = JDataset(**{**_arrays(), "sequence_length": 4})
    j_loss, j_plc = jt.validate(jstate, jds, 5)
    t_loss, t_plc = tt.validate(tstate, ds, 5)
    assert t_plc.shape == j_plc.shape == (3, CFG["prognostic_channels"])
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    np.testing.assert_allclose(t_plc, j_plc, rtol=1e-5)


def test_fit_checkpoints_and_resume(tmp_path):
    ds = TDataset(**_arrays(T=40))
    tt = ttr.Trainer(tswin.SwinTransformer(**CFG, seed=2), epochs=2)
    state = tt.init()
    tt.fit(state, ds, ds, batch_size=4, run_dir=str(tmp_path), model_name="m", verbose=False)
    assert state.epoch == 2 and state.iteration == 2 * len(list(ds.batches(4)))
    for kind in ("best", "last"):
        assert (tmp_path / "checkpoints" / f"m_{kind}.ckpt").exists()
    assert (tmp_path / "metrics.jsonl").read_text().count("\n") == 2

    tt2 = ttr.Trainer(tswin.SwinTransformer(**CFG, seed=9), epochs=3)
    restored = ttr.load_checkpoint(str(tmp_path), "m", tt2.init(), kind="last")
    assert restored.epoch == 2 and np.isfinite(restored.best_val_error)
    for a, b in zip(restored.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    tt2.fit(restored, ds, ds, batch_size=4, run_dir=str(tmp_path), model_name="m",
            verbose=False)
    assert restored.epoch == 3


def test_submitted_checkpoint_holds_values_before_an_in_place_update(tmp_path):
    tt = ttr.Trainer(tswin.SwinTransformer(**CFG, seed=1), epochs=1)
    state = tt.init()
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    writer = ttr.AsyncCheckpointWriter()
    writer.submit(str(tmp_path), "m", state, kind="last")
    with torch.no_grad():  # what optimizer.step() does while the thread writes
        for p in state.model.parameters():
            p.add_(1.0)
    writer.join()
    payload = torch.load(tmp_path / "checkpoints" / "m_last.ckpt", weights_only=True)
    for n, t in before.items():
        assert torch.equal(payload["model"][n], t), n
    # a later submit stores the updated values
    writer.submit(str(tmp_path), "m", state, kind="best")
    writer.join()
    fresh = ttr.Trainer(tswin.SwinTransformer(**CFG, seed=7)).init()
    restored = ttr.load_checkpoint(str(tmp_path), "m", fresh, kind="best")
    for n, p in restored.model.named_parameters():
        assert torch.equal(p, before[n] + 1.0), n


@pytest.mark.parametrize("kw, match", [
    (dict(training_type="diffusion"), "single_forward"),
    (dict(training_type="ddim"), "training.type"),
    (dict(compute_dtype="int8"), "floating"),
])
def test_out_of_scope_options_raise(kw, match):
    """What the trainer cannot honour raises: diffusion training of a model
    with no denoiser, an unknown training type, a non-float compute dtype."""
    with pytest.raises(ValueError, match=match):
        ttr.Trainer(tswin.SwinTransformer(**CFG), **kw)


TINY = ["model=swintransformer", "data=synthetic", "data.height=4", "data.width=8",
        "data.n_time=200", "model.embed_dim=8", "model.depths=[2,2]",
        "model.num_heads=[2,2]", "training.epochs=1", "training.batch_size=8",
        "validation.batch_size=4"]


def test_cli_trains_on_cpu_without_jax(tmp_path):
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'dlwpbench_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import runpy\n"
        "runpy.run_module('dlwpbench_tpu_torch.train', run_name='__main__')\n"
    )
    argv = [*TINY, f"run_dir={tmp_path}", "--device", "cpu"]
    proc = subprocess.run([sys.executable, "-c", code, *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "epoch   1  train" in proc.stdout
    assert (tmp_path / "config.yaml").exists()
    for kind in ("best", "last"):
        assert (tmp_path / "checkpoints" / f"swin_{kind}.ckpt").exists()


def test_cli_honours_remat_and_refuses_what_is_not_ported(tmp_path, monkeypatch):
    from dlwpbench_tpu_torch import train

    built = []
    real = train.registry.build_model
    monkeypatch.setattr(train.registry, "build_model",
                        lambda cfg, **kw: built.append(real(cfg, **kw)) or built[-1])
    res = train.main([*TINY, f"run_dir={tmp_path}", "training.save_model=false",
                      "--device", "cpu"])
    assert built[-1].remat is True
    assert not (tmp_path / "checkpoints").exists()
    assert len(res["train_loss"]) == 1 and np.isfinite(res["train_loss"][0])
    assert len(res["step_seconds"]) > 0
    train.main([*TINY, f"run_dir={tmp_path}", "model.remat=false", "training.save_model=false",
                "--device", "cpu"])
    assert built[-1].remat is False
    # data_parallel needs a job of that many ranks (`tests/test_torch_parallel.py`)
    with pytest.raises(ValueError, match="torchrun"):
        train.main([*TINY, f"run_dir={tmp_path}", "training.data_parallel=2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train.main([*TINY, f"run_dir={tmp_path}"])


# 60 frames: 13 training windows (2 steps of batch 8) and 2 validation
# windows, so the epoch validates and writes both checkpoints
PANGU_TINY = ["model=panguweather", "data=synthetic", "data.height=8", "data.width=16",
              "data.n_time=60", "model.embed_dim=16", "model.num_heads=[1,2,2,1]",
              "model.window_size=[2,3,4]", "training.epochs=1", "training.batch_size=8",
              "validation.batch_size=4", "validation.sequence_length=3"]


def test_cli_trains_pangu_on_cpu_without_jax(tmp_path):
    """The train CLI in a fresh interpreter that cannot import JAX, with
    one intra-op thread (the suite's workers share the cores; more threads
    only contend)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'dlwpbench_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import runpy\n"
        "runpy.run_module('dlwpbench_tpu_torch.train', run_name='__main__')\n"
    )
    argv = [*PANGU_TINY, f"run_dir={tmp_path}", "--device", "cpu"]
    proc = subprocess.run([sys.executable, "-c", code, *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert "Model pangu has" in proc.stdout and "epoch   1  train" in proc.stdout
    for kind in ("best", "last"):
        assert (tmp_path / "checkpoints" / f"pangu_{kind}.ckpt").exists()


def test_prefetch_yields_the_same_batches_in_order():
    """On the CPU the prefetch hands the batches through as tensors, in
    order, the short last batch included."""
    ds = TDataset(**_arrays(T=30))
    want = list(ds.batches(4))
    assert want[-1][2].shape[0] < 4  # a short last batch
    got = list(ttr.prefetch_to_device(ds.batches(4), "cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert (a is None and b is None) or np.array_equal(a.numpy(), b)


def test_step_seconds_keep_one_entry_per_step():
    ds = TDataset(**_arrays(T=30))
    tt = ttr.Trainer(tswin.SwinTransformer(**CFG, seed=3), epochs=2)
    state = tt.init()
    sizes = [b[2].shape[0] for b in ds.batches(4)]
    for _ in range(2):
        tt.train_epoch(state, ds, 4)
    assert [n for n, _ in tt.timings] == sizes * 2
    assert all(s > 0 for _, s in tt.timings)


def test_cli_trains_the_unet_in_bf16(tmp_path):
    """`model=unet training.compute_dtype=bfloat16` on the CPU: finite
    losses, and checkpoints that hold the fp32 master state."""
    from dlwpbench_tpu_torch import train

    res = train.main(["model=unet", "data=synthetic", "data.height=8", "data.width=16",
                      "data.n_time=120", "model.hidden_channels=[4,8]",
                      "training.compute_dtype=bfloat16", "training.epochs=1",
                      "training.batch_size=8", "validation.batch_size=4",
                      "validation.sequence_length=3", f"run_dir={tmp_path}", "--device", "cpu"])
    assert np.isfinite(res["train_loss"] + res["val_loss"]).all()
    assert res["state"].model.GeoConv_0.Conv_0.weight.dtype == torch.float32
    payload = torch.load(tmp_path / "checkpoints" / "unet_last.ckpt", weights_only=True)
    assert {t.dtype for t in payload["model"].values()} == {torch.float32}


# ---------------------------------------------------------------- diffusion training
# A small DiffModernUNet on the 4x8 grid, context 2, one residual target
# frame.  JAX draws k and the noise from its own keys; the port is fed the
# same draws.  Tolerances, fp32: the losses rtol 1e-5; the parameters and
# the EMA after the steps within PARAM_ATOL = lr / 100 (see the module's
# docstring); bf16 compute: the loss within 2e-3 relative of JAX's bf16
# loss (bf16 rounds at other points in the two frameworks).
DCFG = dict(constant_channels=2, prescribed_channels=1, prognostic_channels=2,
            hidden_channels=(8, 16), context_size=2, norm=True, sampler="mean")
SEED = 1234


def _diff_arrays(T=24):
    return {**_arrays(T), "context_size": 2, "sequence_length": 3}


@functools.lru_cache(maxsize=None)
def _diff_init():
    """The diffusion model's JAX init through `single_forward`, perturbed
    (the zero-initialised convs carry signal), once for the tests that
    start from it."""
    from dlwpbench_tpu.models import modern_unet as jmu

    jmodel = jmu.DiffModernUNet(**DCFG)
    c, p, g, t = next(iter(JDataset(**_diff_arrays()).batches(1)))
    params = jax_ref.init(jmodel, jax.random.PRNGKey(0), c, p[:, :2], g[:, :2], t,
                          jnp.zeros((1,), jnp.int32), method=jmodel.single_forward)
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


def _diff_pair(accum=1, compute_dtype=None):
    """(JAX trainer, its state, port trainer, its state) on one init; the
    JAX params come from an init through `single_forward`."""
    from dlwpbench_tpu.models import modern_unet as jmu
    from dlwpbench_tpu_torch.models import modern_unet as tmu

    jmodel = jmu.DiffModernUNet(**DCFG)
    jt = jtr.Trainer(jmodel, learning_rate=LR, epochs=5, gradient_accumulation_steps=accum,
                     training_type="diffusion", num_refinement_steps=1000, seed=SEED,
                     compute_dtype=compute_dtype)
    params = jax.tree_util.tree_map(jnp.asarray, _diff_init())
    jstate = jtr.TrainState(params=params, opt_state=jt.tx.init(params),
                            ema_params=jax.tree_util.tree_map(jnp.copy, params))
    tt = ttr.Trainer(tmu.DiffModernUNet(**DCFG), learning_rate=LR, epochs=5,
                     gradient_accumulation_steps=accum, training_type="diffusion",
                     num_refinement_steps=1000, seed=SEED, compute_dtype=compute_dtype)
    tstate = tt.init(params=_diff_init())
    return jt, jstate, tt, tstate


def _jax_draws(key, shape, T=1001):
    """JAX's k and noise of one step from its key (`trainer.py:184-187`)."""
    kk, kn = jax.random.split(key)
    k = int(jax.random.randint(kk, (), 0, T - 1))
    return k, torch.from_numpy(np.array(jax.random.normal(kn, shape, jnp.float32)))


def _assert_params_close(got_model_or_tree, want, atol=PARAM_ATOL):
    got = weights.flatten_tree(got_model_or_tree)
    want = weights.flatten_tree(_np_tree(want))
    assert got.keys() == want.keys()
    for path, g in got.items():
        d = np.abs(g - want[path]).max()
        assert d <= atol, (path, float(d))


def test_diffusion_step_matches_jax_with_accumulation():
    """One optimizer step on a batch of 3 in 2 micro-batches and a
    remainder, all of one shape, so all take JAX's one noise draw and k."""
    jt, jstate, tt, tstate = _diff_pair(accum=2)
    batch = next(TDataset(**_diff_arrays()).batches(3))
    key = jax.random.PRNGKey(11)
    k, noise = _jax_draws(key, (1, 1, 2, 4, 8))
    lr = ttr.cosine_lr(0, LR, 5)
    params, _, j_loss = jt._train_step(jstate.params, jstate.opt_state,
                                       *(jnp.asarray(x) for x in batch), jnp.float32(lr), key)
    t_loss = tt.train_step(tstate, tt._to_device(batch), lr, k=k, noise=noise)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
    _assert_params_close(weights.to_flax_tree(tstate.model), params["params"])


def test_diffusion_ema_matches_jax_after_two_steps(monkeypatch):
    """Two steps of each trainer's own epoch loop (the same shuffled
    batches); the port draws JAX's k and noise.  The EMA starts as the
    parameters and follows e * d + p * (1 - d) after each step."""
    jt, jstate, tt, tstate = _diff_pair()
    jds, tds = JDataset(**_diff_arrays(T=12)), TDataset(**_diff_arrays(T=12))
    sizes = [b[2].shape[0] for b in tds.batches(2)]
    assert sizes == [2, 1]
    key, draws = jax.random.PRNGKey(SEED), []
    for n in sizes:
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub, (n, 1, 2, 4, 8)))
    monkeypatch.setattr(tt, "_draw_k", lambda: draws[0][0])
    monkeypatch.setattr(tt, "_draw_noise", lambda shape: draws.pop(0)[1])
    jt.train_epoch(jstate, jds, 2)
    tt.train_epoch(tstate, tds, 2)
    assert not draws and tstate.iteration == 2
    _assert_params_close(weights.to_flax_tree(tstate.model), jstate.params["params"])
    _assert_params_close(weights.to_flax_tree(tt.model, tstate.ema), jstate.ema_params["params"])


def test_bf16_diffusion_step_matches_jax():
    """bf16 compute: the denoiser's output is fp32 (JAX's promotion from
    the fp32 time embedding), and the step's loss is JAX's bf16 loss."""
    jt, jstate, tt, tstate = _diff_pair(compute_dtype="bfloat16")
    batch = next(TDataset(**_diff_arrays()).batches(2))
    key = jax.random.PRNGKey(5)
    k, noise = _jax_draws(key, (2, 1, 2, 4, 8))
    c, p, g, t = tt._to_device(batch)
    with tt._compute_params(tstate.model):
        out = tstate.model.single_forward(c.bfloat16(), p[:, :2].bfloat16(), g[:, :2].bfloat16(),
                                          t.bfloat16(), torch.tensor([k, k]))
    assert out.dtype == torch.float32
    lr = ttr.cosine_lr(0, LR, 5)
    _, _, j_loss = jt._train_step(jstate.params, jstate.opt_state,
                                  *(jnp.asarray(x) for x in batch), jnp.float32(lr), key)
    t_loss = tt.train_step(tstate, (c, p, g, t), lr, k=k, noise=noise)
    assert abs(t_loss.item() - float(j_loss)) <= 2e-3 * abs(float(j_loss))
    assert tstate.model.time_mlp1.weight.dtype == torch.float32


def test_diffusion_checkpoint_carries_the_ema(tmp_path):
    """fit writes the EMA beside the parameters; load_checkpoint restores it
    (continue_training's path), and refuses a checkpoint without one."""
    from dlwpbench_tpu_torch.models import modern_unet as tmu

    ds = TDataset(**_diff_arrays(T=20))
    tt = ttr.Trainer(tmu.DiffModernUNet(**DCFG, seed=2), epochs=1, training_type="diffusion")
    state = tt.init()
    tt.fit(state, ds, ds, batch_size=4, run_dir=str(tmp_path), model_name="d", verbose=False)
    ema = {n: t.clone() for n, t in state.ema.items()}
    assert any(not torch.equal(ema[n], p) for n, p in state.model.named_parameters())
    fresh = ttr.Trainer(tmu.DiffModernUNet(**DCFG, seed=5), epochs=2, training_type="diffusion")
    restored = ttr.load_checkpoint(str(tmp_path), "d", fresh.init(), kind="last")
    assert restored.epoch == 1 and restored.ema is not None
    for n, t in restored.ema.items():
        assert torch.equal(t, ema[n]), n
    fresh.fit(restored, ds, ds, batch_size=4, run_dir=str(tmp_path), model_name="d", verbose=False)
    assert restored.epoch == 2 and not torch.equal(restored.ema["time_mlp1.weight"],
                                                   ema["time_mlp1.weight"])
    regular = ttr.Trainer(tmu.DiffModernUNet(**DCFG), epochs=1)
    regular.fit(regular.init(), ds, ds, batch_size=4, run_dir=str(tmp_path / "r"),
                model_name="d", verbose=False)
    with pytest.raises(KeyError, match="no EMA"):
        ttr.load_checkpoint(str(tmp_path / "r"), "d", fresh.init(), kind="last")


@pytest.mark.parametrize("argv", [
    ["model=modernunet", "data=synthetic", "data.height=8", "data.width=16"],
    ["model=modernunet_inverted_hpx", "data=synthetic_hpx8"],
    ["model=diffusion_modernunet", "model.type=DiffMUNetHPX", "model.mesh=healpix",
     "data=synthetic_hpx8", "training=diffusion"],
], ids=["modernunet", "inverted_hpx", "diffusion_hpx"])
def test_cli_trains_the_modern_unets_on_cpu(tmp_path, argv):
    """The shipped ModernUNet configs at hidden (8, 16) through the train
    CLI: finite losses, best and last checkpoints (the diffusion run's with
    its EMA)."""
    from dlwpbench_tpu_torch import train

    res = train.main([*argv, "data.n_time=120", "model.hidden_channels=[8,16]",
                      "training.epochs=1", "training.batch_size=8", "validation.batch_size=4",
                      "validation.sequence_length=4", "verbose=false", f"run_dir={tmp_path}",
                      "--device", "cpu"])
    assert np.isfinite(res["train_loss"] + res["val_loss"]).all()
    name = res["state"].model.__class__.__name__
    payload = torch.load(next((tmp_path / "checkpoints").glob("*_last.ckpt")), weights_only=True)
    assert bool(payload["ema"]) == name.startswith("Diff")
    # remat per rollout step, as the CLI sets it; the diffusion models drop the key
    assert getattr(res["state"].model, "remat", None) is (None if name.startswith("Diff") else True)
