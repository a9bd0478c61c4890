"""The port's ModernUNet family against the JAX package's, on the CPU.

Inputs and a perturbation of every JAX parameter (so that the
zero-initialised convs carry signal) come from numpy seeds and go to both
sides; JAX parameters reach the port through `weights.load_flax_params`.
No Pallas kernel is on these paths.  Tolerances, fp32:
- the `ModernUNet` / `MUNetHPX` rollouts (2 closed-loop steps through two
  levels, the middle blocks and the decoder) and every parameter
  gradient: max|diff| <= 1e-4 x max|that tensor|.  A gradient that is zero
  in exact arithmetic (a bias in front of a per-channel GroupNorm, the
  attention's key bias, which the softmax ignores) is rounding noise on
  both sides and has no scale of its own: such a tensor (its JAX max under
  1e-6 of the largest gradient) is held to 1e-4 x the largest gradient;
- the blocks (`GroupNormCL`, the plain strided conv, the k4 / s2 / p1
  transpose against flax's "SAME" and the cropped VALID one,
  `AttentionBlock`, `ConvNeXtLSTMBlock`): atol 1e-5, or 1e-4 of each
  gradient's max.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from dlwpbench_tpu.models import build_model as jbuild
from dlwpbench_tpu.models import modern_unet as jmu
from dlwpbench_tpu.ops import conv as jconv
from dlwpbench_tpu_torch import weights
from dlwpbench_tpu_torch.models import modern_unet as tmu
from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.ops import conv as tconv
from dlwpbench_tpu_torch.training.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = 1e-5
MODEL_TOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _perturbed(params, seed=0, scale=0.05):
    """Every leaf plus seeded noise: the zero-initialised convs then carry
    signal, so every gradient is exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32),
        params)


def assert_grads_close(got: dict, want: dict, tol: float = MODEL_TOL):
    """Per tensor within tol x its max; tensors whose exact gradient is 0
    (max under 1e-6 of the largest) within tol x the largest."""
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        w = np.asarray(w)
        assert got[path].shape == w.shape, path
        scale = float(np.abs(w).max())
        if scale < 1e-6 * top:
            scale = top
        err = float(np.abs(got[path] - w).max())
        assert err <= tol * scale, (path, err, scale)


def _torch_grads(model):
    return weights.flatten_tree(weights.to_flax_tree(
        model, {n: p.grad for n, p in model.named_parameters()}))


# ---------------------------------------------------------------- blocks
@pytest.mark.parametrize("shape, groups", [((2, 8, 16, 6), 4), ((2, 12, 4, 4, 8), 8)],
                         ids=["latlon-clamped", "faces"])
def test_group_norm_cl_matches_jax(shape, groups):
    """GroupNorm over channels-last, faces flattened with space; 4 groups
    on 6 channels clamp to 3."""
    x = 3.0 + _randn(1, *shape)
    jm = jmu.GroupNormCL(groups)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = tmu.GroupNormCL(shape[-1], groups)
    weights.load_flax_params(tm, _np_tree(params))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (2, 12, 4, 4, 3)], ids=["odd", "faces"])
def test_plain_conv_and_transpose_match_jax(shape):
    """The strided zero-padded downsampling (`_plain_conv`) and the k4 / s2
    / p1 transpose against flax's "SAME" transpose and `_up4` (the VALID
    transpose cropped by 1), on an odd grid and on the faces."""
    mesh = "healpix" if len(shape) == 5 else "equirectangular"
    x = _randn(2, *shape)

    def faces(layer, x):  # `_plain_conv` and `_up4` fold the faces the same way
        return jconv.unfold_faces(layer(jconv.fold_faces(x))) if mesh == "healpix" else layer(x)

    class Down(fnn.Module):  # `_plain_conv` (`modern_unet.py:239-247`)
        @fnn.compact
        def __call__(self, x):
            return faces(fnn.Conv(4, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1))), x)

    class Up(fnn.Module):  # flax "SAME", or `_up4` (`:249-258`)
        same: bool

        @fnn.compact
        def __call__(self, x):
            up = fnn.ConvTranspose(4, (4, 4), strides=(2, 2),
                                   padding="SAME" if self.same else "VALID")
            y = faces(up, x)
            return y if self.same else y[..., 1:-1, 1:-1, :]

    for jm, tm in ((Down(), tconv.PlainConv(3, 4, 3, stride=2, mesh=mesh)),
                   (Up(same=False), tconv.PlainConvTranspose(3, 4, 4, 2, 1, mesh=mesh)),
                   (Up(same=True), tconv.PlainConvTranspose(3, 4, 4, 2, 1, mesh=mesh))):
        params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
        want = np.asarray(jm.apply(params, jnp.asarray(x)))
        leaves = weights.flatten_tree(_np_tree(params["params"]))
        kernel = next(v for k, v in leaves.items() if k.endswith("kernel"))
        bias = next(v for k, v in leaves.items() if k.endswith("bias"))
        weights.load_flax_params(tm, {"kernel": kernel, "bias": bias})
        got = tm(torch.from_numpy(x)).detach().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)


def test_attention_block_matches_jax():
    """LayerNorm (flax's eps 1e-6) and flax's multi-head attention over all
    tokens, 4 heads of 4; the input's and every parameter's gradient."""
    x = _randn(4, 2, 4, 6, 16)
    jm = jmu.AttentionBlock(16)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=1, scale=0.2)
    w = _randn(5, *x.shape)

    def loss_fn(p, x):
        return jnp.sum(jm.apply(p, x) * w)

    j_grads, j_dx = jax.jit(jax.grad(loss_fn, argnums=(0, 1)))(params, jnp.asarray(x))
    tm = tmu.AttentionBlock(16)
    weights.load_flax_params(tm, _np_tree(params))
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jm.apply(params, x)), rtol=0,
                               atol=OP_TOL)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_dx), rtol=0,
                               atol=MODEL_TOL * float(np.abs(j_dx).max()))
    assert_grads_close(_torch_grads(tm), weights.flatten_tree(_np_tree(j_grads["params"])))


@pytest.mark.parametrize("mesh, spatial", [("equirectangular", (8, 16)), ("healpix", (12, 4, 4))])
def test_conv_next_lstm_block_matches_jax(mesh, spatial):
    """The depthwise k7 geo-conv (cylinder pad, or the faces' neighbours),
    the GroupNorms, the 1x1 conv (a Dense on the 5-D HEALPix field) and
    the gates: h' and c' and the parameter gradients."""
    x, h, c = (_randn(s, 2, *spatial, 4) for s in (1, 2, 3))
    jm = jmu.ConvNeXtLSTMBlock(4, mesh=mesh)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), x, h, c), seed=2)
    w_h, w_c = _randn(6, *x.shape), _randn(7, *x.shape)

    def loss_fn(p):
        hn, cn = jm.apply(p, x, h, c)
        return jnp.sum(hn * w_h) + jnp.sum(cn * w_c), (hn, cn)

    (_, (j_h, j_c)), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tm = tmu.ConvNeXtLSTMBlock(4, mesh=mesh)
    weights.load_flax_params(tm, _np_tree(params))
    t_h, t_c = tm(*map(torch.from_numpy, (x, h, c)))
    np.testing.assert_allclose(t_h.detach().numpy(), np.asarray(j_h), rtol=0, atol=OP_TOL)
    np.testing.assert_allclose(t_c.detach().numpy(), np.asarray(j_c), rtol=0, atol=OP_TOL)
    ((t_h * torch.from_numpy(w_h)).sum() + (t_c * torch.from_numpy(w_c)).sum()).backward()
    assert_grads_close(_torch_grads(tm), weights.flatten_tree(_np_tree(j_grads["params"])))


# ---------------------------------------------------------------- the models
SMALL = dict(constant_channels=2, prescribed_channels=1, prognostic_channels=2,
             hidden_channels=(8, 16), context_size=2, norm=True)
# (variant, mesh, spatial, attention, hidden); on 6 x 12 three levels go
# 6 -> 3 -> 2 rows, so the decoder's 4 rows are cropped to the skip's 3
CASES = {
    "upstream-8x16-attention": ("upstream", "equirectangular", (8, 16), True, (8, 16)),
    "upstream-nside4": ("upstream", "healpix", (12, 4, 4), False, (8, 16)),
    "reference-odd-6x12": ("reference", "equirectangular", (6, 12), False, (8, 16, 32)),
    "reference-nside4": ("reference", "healpix", (12, 4, 4), False, (8, 16)),
    "diffusion-odd-6x12": ("diffusion", "equirectangular", (6, 12), False, (8, 16, 32)),
    "diffusion-nside4": ("diffusion", "healpix", (12, 4, 4), False, (8, 16)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_modern_unet_rollout_and_grads_match_jax(case):
    """Batch 2, context 2, 2 closed-loop steps; the port with per-step
    remat (its values and gradients are those without)."""
    variant, mesh, spatial, attention, hidden = CASES[case]
    B, T = 2, 4
    const, pres = _randn(1, B, 1, 2, *spatial), _randn(2, B, T, 1, *spatial)
    prog, target = _randn(3, B, T, 2, *spatial), _randn(4, B, T - 2, 2, *spatial)
    kw = dict(SMALL, variant=variant, attention=attention, hidden_channels=hidden)
    jcls, tcls = ((jmu.MUNetHPX, tmu.MUNetHPX) if mesh == "healpix"
                  else (jmu.ModernUNet, tmu.ModernUNet))
    jmodel = jcls(**kw)
    params = _perturbed(jmodel.init(jax.random.PRNGKey(0), const, pres, prog))

    def loss_fn(p):
        out = jmodel.apply(p, const, pres, prog)
        return jnp.mean((out - target) ** 2), out

    (j_loss, j_out), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tmodel = tcls(**kw, remat=True)
    assert tmodel.mesh == mesh
    weights.load_flax_params(tmodel, _np_tree(params))
    out = tmodel(*map(torch.from_numpy, (const, pres, prog)))
    assert out.shape == j_out.shape == (B, T - 2, 2, *spatial)
    assert np.abs(out.detach().numpy() - j_out).max() <= MODEL_TOL * np.abs(j_out).max()
    loss = torch.mean((out - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    assert_grads_close(_torch_grads(tmodel), weights.flatten_tree(_np_tree(j_grads["params"])))


# the Fourier block at level 0 (16 x 16 modes): on 8 x 16 the grid keeps
# 8 x 9 of them and the bands overlap (the fft branch), 8 channels in and
# 12 out (its Dense shortcut); on 32 x 64 all 16 x 16, on the matmul branch
FOURIER_CASES = {"upstream-fourier-8x16": ("upstream", (8, 16), (12, 16)),
                 "reference-fourier-32x64": ("reference", (32, 64), (8, 16))}


@pytest.mark.parametrize("case", sorted(FOURIER_CASES))
def test_fourier_modern_unet_rollout_and_grads_match_jax(case):
    """`use_fourier` on the lat-lon mesh: batch 2, context 2, 2 closed-loop
    steps through the `FourierResidualBlock` at level 0, the port with
    per-step remat, built for the grid (`grid_shape`)."""
    variant, spatial, hidden = FOURIER_CASES[case]
    B, T = 2, 4
    const, pres = _randn(1, B, 1, 2, *spatial), _randn(2, B, T, 1, *spatial)
    prog, target = _randn(3, B, T, 2, *spatial), _randn(4, B, T - 2, 2, *spatial)
    kw = dict(SMALL, variant=variant, use_fourier=True, hidden_channels=hidden)
    jmodel = jmu.ModernUNet(**kw)
    params = _perturbed(jmodel.init(jax.random.PRNGKey(0), const, pres, prog))
    assert "FourierResidualBlock_0" in params["params"]["ModernUNetCore_0"]

    def loss_fn(p):
        out = jmodel.apply(p, const, pres, prog)
        return jnp.mean((out - target) ** 2), out

    (j_loss, j_out), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tmodel = tmu.ModernUNet(**kw, grid_shape=spatial, remat=True)
    weights.load_flax_params(tmodel, _np_tree(params))
    out = tmodel(*map(torch.from_numpy, (const, pres, prog)))
    assert out.shape == j_out.shape == (B, T - 2, 2, *spatial)
    assert np.abs(out.detach().numpy() - j_out).max() <= MODEL_TOL * np.abs(j_out).max()
    loss = torch.mean((out - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    assert_grads_close(_torch_grads(tmodel), weights.flatten_tree(_np_tree(j_grads["params"])))


def test_modern_unet_starts_as_persistence():
    """The zero-initialised head: a fresh model predicts a zero residual,
    so its rollout repeats the last context frame."""
    prog = _randn(0, 1, 4, 2, 8, 16)
    model = tmu.ModernUNet(**SMALL, seed=3)
    with torch.no_grad():
        out = model(torch.from_numpy(_randn(1, 1, 1, 2, 8, 16)),
                    torch.from_numpy(_randn(2, 1, 4, 1, 8, 16)), torch.from_numpy(prog))
    assert torch.equal(out, torch.from_numpy(prog[:, 1:2]).expand(1, 2, 2, 8, 16))


@pytest.mark.parametrize("overrides, cls, n_params", [
    (["model=modernunet"], tmu.ModernUNet, 89_568_046),
    (["model=modernunet_inverted_hpx", "data=synthetic_hpx8"], tmu.ModernUNet, 1_491_875),
    (["model=diffusion_modernunet", "model.type=DiffMUNetHPX", "model.mesh=healpix",
      "data=synthetic_hpx8", "training=diffusion"], tmu.DiffMUNetHPX, 80_664_899),
], ids=["modernunet", "inverted_hpx", "diffusion_hpx"])
def test_shipped_configs_build_the_jax_layout(overrides, cls, n_params):
    """The shipped configs build the same net on either side: the same
    flax parameter paths and shapes (the JAX side traced, not run); the
    diffusion classes drop the train CLI's `remat` key, as JAX's
    `build_model` does."""
    cfg = load_config(os.path.join(REPO, "configs"), overrides=overrides)
    tmodel = registry.build_model({**cfg.model, "remat": True}, seed=1)
    assert type(tmodel) is cls
    assert sum(p.numel() for p in tmodel.parameters()) == n_params
    hpx = cfg.data.get("healpix_nside")
    sp = (12, 8, 8) if hpx else (32, 64)
    d = cfg.data
    const = np.empty((1, 1, d.constant_channels, *sp), np.float32)
    pres = np.empty((1, 3, d.prescribed_channels, *sp), np.float32)
    prog = np.empty((1, 3, d.prognostic_channels, *sp), np.float32)
    jparams = jax.eval_shape(jbuild({**cfg.model, "remat": True}).init, jax.random.PRNGKey(0),
                             const, pres, prog)
    jshapes = {k: v.shape for k, v in weights.flatten_tree(jax.tree_util.tree_map(
        lambda a: np.empty(a.shape, a.dtype), jparams["params"])).items()}
    tshapes = {k: v.shape for k, v in weights.flatten_tree(weights.to_flax_tree(tmodel)).items()}
    assert tshapes == jshapes


def test_fourier_blocks_raise_naming_their_item():
    """`use_fourier` on the lat-lon mesh builds JAX's layout (the
    `FourierResidualBlock_0` at level 0, the residual blocks numbered from
    level 1), and without the data's grid it raises; on HEALPix the JAX
    core ignores it, and so does the port; an unknown variant still
    raises."""
    def shapes(tree):
        return {k: v.shape for k, v in weights.flatten_tree(tree).items()}

    x = [_randn(i, 1, 3, c, 8, 16) for i, c in enumerate((2, 1, 2))]
    x[0] = x[0][:, :1]
    kw = dict(SMALL, use_fourier=True, hidden_channels=(16, 16))
    jtree = jax.eval_shape(jmu.ModernUNet(**kw).init, jax.random.PRNGKey(0), *x)["params"]
    tmodel = tmu.ModernUNet(**kw, grid_shape=(8, 16))
    assert shapes(weights.to_flax_tree(tmodel)) == shapes(jax.tree_util.tree_map(
        lambda a: np.empty(a.shape, a.dtype), jtree))
    blk = tmodel.ModernUNetCore_0.FourierResidualBlock_0
    assert blk.SpectralConv2d_0.weights1.shape == (8, 16, 8, 9, 2)  # 16 modes kept as 8 x 9
    assert hasattr(blk, "Dense_2") and not hasattr(tmodel.ModernUNetCore_0, "ResidualBlock_5")
    with pytest.raises(ValueError, match="grid_shape"):
        tmu.ModernUNet(**kw)
    hpx = tmu.MUNetHPX(**SMALL, use_fourier=True)
    assert hpx.mesh == "healpix" and not any(
        "Fourier" in n for n, _ in hpx.named_modules())
    with pytest.raises(ValueError, match="variant"):
        tmu.ModernUNet(**SMALL, variant="dense")


def test_attention_weights_round_trip():
    """DenseGeneral and GroupNorm leaves: flax tree -> port -> flax tree is
    the identity, and a leaf that does not land raises."""
    x = _randn(0, 1, 4, 4, 16)
    params = _np_tree(jmu.ModernUNetCore((16,), 2, attention=True, norm=True).init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    tm = tmu.ModernUNetCore(16, (16,), 2, attention=True, norm=True)
    weights.load_flax_params(tm, _perturbed(params))
    back = weights.flatten_tree(weights.to_flax_tree(tm))
    want = weights.flatten_tree(_perturbed(params)["params"])
    assert back.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(back[k], v), k
    bad = weights.unflatten_tree({**want, "AttentionBlock_0/LayerNorm_0/gamma": want[
        "AttentionBlock_0/LayerNorm_0/scale"]})
    with pytest.raises(KeyError):
        weights.load_flax_params(tm, bad)
