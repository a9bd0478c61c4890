"""The port's geometry ops and U-Net against the JAX package's, on the CPU.

Inputs come from numpy seeds and go to both sides; JAX parameters reach
the port through `weights.load_flax_params`.  Neither side reaches a
Pallas kernel: the U-Net's convs, pools and activations are XLA ops in
JAX and ATen ops here.

Tolerances, fp32:
- the ops (`cylinder_pad`, `GeoConv`, `GeoConvTranspose`, `avg_pool_2x`,
  the activations): atol 1e-5 (the pad and pool are exact; a conv sums
  at most 9 x 16 products in another order);
- the U-Net's rollout and every parameter gradient: max|diff| <= 1e-4 x
  max|that tensor| (two closed-loop steps through up to 13 convs each;
  rounding grows with depth, and a tensor's small entries carry its
  largest entry's absolute error).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_ref as jax_ref
from dlwpbench_tpu.models import unet as junet
from dlwpbench_tpu.ops import conv as jconv
from dlwpbench_tpu.ops import padding as jpad
from dlwpbench_tpu_torch import weights
from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.models import unet as tunet
from dlwpbench_tpu_torch.ops import conv as tconv
from dlwpbench_tpu_torch.ops import padding as tpad


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the suite's workers share the
    cores, and a test's extra threads only wait on the other workers."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = 1e-5
MODEL_TOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- geometry ops
@pytest.mark.parametrize("p", [0, 1, 2])
def test_cylinder_pad_matches_jax(p):
    x = _randn(p, 2, 3, 6, 10)
    want = np.asarray(jpad.cylinder_pad(jnp.asarray(x), p))
    got = tpad.cylinder_pad(torch.from_numpy(x), p).numpy()
    assert got.shape == (2, 3, 6 + 2 * p, 10 + 2 * p)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh, k, dilation", [
    ("equirectangular", 3, 1), ("equirectangular", 1, 1), ("equirectangular", 3, 2),
    ("plain", 3, 1), ("plain", 5, 1), ("torus", 3, 1), ("torus", 3, 2),
])
def test_geoconv_matches_jax(mesh, k, dilation):
    x = _randn(k * dilation, 2, 7, 12, 5)
    jm = jconv.GeoConv(6, k, mesh=mesh, dilation=dilation)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = tconv.GeoConv(5, 6, k, mesh=mesh, dilation=dilation)
    weights.load_flax_params(tm, _np_tree(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 7, 12, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)


@pytest.mark.parametrize("k, s", [(2, 2), (3, 2), (4, 2)])
def test_geoconv_transpose_matches_jax(k, s):
    x = _randn(k, 2, 4, 6, 5)
    jm = jconv.GeoConvTranspose(3, k, s)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = tconv.GeoConvTranspose(5, 3, k, s)
    weights.load_flax_params(tm, _np_tree(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)


@pytest.mark.parametrize("H, W", [(8, 16), (7, 13)])
def test_avg_pool_2x_matches_jax(H, W):
    x = _randn(H, 2, H, W, 3)
    want = np.asarray(jconv.avg_pool_2x(jnp.asarray(x)))
    got = tconv.avg_pool_2x(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, H // 2, W // 2, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)


def test_geometry_ops_refuse_what_is_not_ported():
    """No mesh beyond the four of the JAX module: the HEALPix faces are
    ported (`tests/test_torch_unet_hpx.py` holds them against JAX), an
    icosahedral or unknown mesh raises."""
    assert tconv.GeoConv(2, 2, 3, mesh="healpix")(torch.zeros(1, 12, 4, 4, 2)).shape == (
        1, 12, 4, 4, 2)
    assert tconv.avg_pool_2x(torch.zeros(1, 12, 4, 4, 2), mesh="healpix").shape == (
        1, 12, 2, 2, 2)
    for mesh in ("icosahedral", "sphere"):
        with pytest.raises(ValueError, match="unknown mesh"):
            tconv.GeoConv(2, 2, 3, mesh=mesh)
        with pytest.raises(ValueError, match="unknown mesh"):
            tconv.avg_pool_2x(torch.zeros(1, 4, 4, 2), mesh=mesh)
    with pytest.raises(ValueError, match="stride"):
        tconv.GeoConvTranspose(2, 2, 1, 2)


DOTTED = ["torch.nn.GELU()", "torch.nn.GELU(approximate='tanh')", "torch.nn.LeakyReLU()",
          "LeakyReLU(0.2)", "torch.nn.LeakyReLU(negative_slope=0.3, inplace=True)",
          "torch.nn.ELU(alpha=0.5)", "nn.CELU()", "torch.nn.SiLU()", "torch.nn.ReLU(inplace=True)",
          "torch.nn.Hardswish()", "Leaky_ReLU", "GELU"]


@pytest.mark.parametrize("name", sorted(tconv.ACTIVATIONS) + DOTTED)
def test_activation_matches_jax(name):
    assert sorted(tconv.ACTIVATIONS) == sorted(jconv.ACTIVATIONS)
    # both sides of every kink and the large-|x| tails
    x = np.concatenate([np.linspace(-8, 8, 201, dtype=np.float32), _randn(3, 64),
                        np.float32([-30.0, 30.0])])
    want = np.asarray(jconv.get_activation(name)(jnp.asarray(x)))
    got = tconv.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=OP_TOL)


@pytest.mark.parametrize("name, match", [
    ("softshrink", "unknown activation"),
    ("torch.nn.Softshrink()", "unknown activation"),
    ("torch.nn.Tanh(0.5)", "numeric argument"),
    ("torch.nn.LeakyReLU(slope=steep)", "unsupported activation argument"),
])
def test_activation_refuses_unknown_specs(name, match):
    with pytest.raises(ValueError, match=match):
        jconv.get_activation(name)
    with pytest.raises(ValueError, match=match):
        tconv.get_activation(name)


def test_bare_and_dotted_gelu_differ():
    """Bare "gelu" is the tanh approximation, a dotted torch spec the erf
    form, and bare "leaky_relu" has slope 0.1 where torch's has 0.01."""
    x = torch.linspace(-3, 3, 61)
    bare, dotted = tconv.get_activation("gelu")(x), tconv.get_activation("torch.nn.GELU()")(x)
    assert (bare - dotted).abs().max().item() > 1e-4
    torch.testing.assert_close(dotted, torch.nn.GELU()(x))
    torch.testing.assert_close(tconv.get_activation("leaky_relu")(-x), torch.where(-x < 0, -0.1 * x, -x))
    torch.testing.assert_close(tconv.get_activation("torch.nn.LeakyReLU()")(x),
                               torch.nn.LeakyReLU()(x))


# ---------------------------------------------------------------- the U-Net
YAML = dict(constant_channels=2, prescribed_channels=1, prognostic_channels=2,
            hidden_channels=(8, 16, 32, 64), n_convolutions=2, activation="gelu")
BENCH = dict(constant_channels=4, prescribed_channels=1, prognostic_channels=8,
             hidden_channels=(64, 128, 256), activation="gelu")


def _batch(seed, cfg, H, W, B=2, T=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, 1, cfg["constant_channels"], H, W), f(B, T, cfg["prescribed_channels"], H, W),
            f(B, T, cfg["prognostic_channels"], H, W), f(B, T - 1, cfg["prognostic_channels"], H, W))


def _assert_close_per_tensor(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for path, g in got.items():
        w = np.asarray(want[path])
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max())
        assert np.abs(g - w).max() <= tol * max(scale, 1e-6), (
            path, float(np.abs(g - w).max()), scale)


@pytest.mark.parametrize("cfg, H, W, remat", [
    (YAML, 8, 16, False),   # unet.yaml's widths, an even grid
    (YAML, 7, 13, True),    # an odd grid: edge padding before each pool, crops
    (BENCH, 32, 64, False),  # bench.py's widths and grid, batch 2, 2 steps
], ids=["unet-yaml-even", "odd-grid-remat", "bench-widths"])
def test_unet_rollout_and_grads_match_jax(cfg, H, W, remat):
    const, pres, prog, target = _batch(H * W, cfg, H, W)
    jmodel = junet.UNet(**cfg)
    params = jax_ref.init(jmodel, jax.random.PRNGKey(0), const, pres, prog)

    def loss_fn(p):
        out = jmodel.apply(p, const, pres, prog)
        return jnp.mean((out - target) ** 2), out

    (j_loss, j_out), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    tmodel = tunet.UNet(**cfg, remat=remat)
    weights.load_flax_params(tmodel, _np_tree(params))
    out = tmodel(*map(torch.from_numpy, (const, pres, prog)))
    assert out.shape == j_out.shape == (2, 2, cfg["prognostic_channels"], H, W)
    _assert_close_per_tensor({"out": out.detach().numpy()}, {"out": j_out}, MODEL_TOL)
    loss = torch.mean((out - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    got = weights.flatten_tree(weights.to_flax_tree(
        tmodel, {n: p.grad for n, p in tmodel.named_parameters()}))
    _assert_close_per_tensor(got, weights.flatten_tree(_np_tree(j_grads["params"])), MODEL_TOL)


def test_unet_builds_from_the_shipped_config():
    """`configs/model/unet.yaml` builds the same net on either side: the
    same flax parameter paths and shapes, the bottom level's half convs
    included; `UNetHPX` builds from it (without its `mesh` key) on the
    HEALPix mesh, and a type that neither side registers is the registry's
    KeyError."""
    from dlwpbench_tpu.models import build_model as jbuild
    from dlwpbench_tpu_torch.training.config import load_config

    cfg = load_config(os.path.join(REPO, "configs"), overrides=["model=unet", "data=synthetic"])
    tmodel = registry.build_model(cfg.model, seed=1)
    assert isinstance(tmodel, tunet.UNet) and tmodel.hidden_channels == (8, 16, 32, 64)
    assert [len(n) for n in tmodel.enc] == [2, 2, 2, 1] and [len(n) for n in tmodel.dec] == [1, 2, 2, 2]
    jmodel = jbuild(dict(cfg.model))
    H, W = int(cfg.data.height), int(cfg.data.width)
    const, pres, prog, _ = _batch(0, dict(cfg.model), H, W, B=1, T=2)
    jshapes = {k: v.shape for k, v in weights.flatten_tree(_np_tree(
        jmodel.init(jax.random.PRNGKey(0), const, pres, prog)["params"])).items()}
    tshapes = {k: v.shape for k, v in weights.flatten_tree(weights.to_flax_tree(tmodel)).items()}
    assert tshapes == jshapes
    hpx = registry.build_model({**{k: v for k, v in cfg.model.items() if k != "mesh"},
                                "type": "UNetHPX"})
    assert isinstance(hpx, tunet.UNetHPX) and hpx.mesh == "healpix"
    with pytest.raises(KeyError, match="IcosahedralUNet"):
        registry.build_model({**cfg.model, "type": "IcosahedralUNet"})


# Small widths for every registered family (a constructor takes the keys
# it has; the registry drops the rest), and each family's own extras.
SMALL_ANY = dict(hidden_channels=[4, 8], embed_dim=8, hidden_dim=8, depth=1, num_layers=1,
                 processor_layers=1, processor_size=1, hidden_dim_processor=8,
                 num_heads=[2, 2, 2, 2], depths=[2, 2], mlp_ratio=1.0, num_blocks=2,
                 mesh_level=1, input_height=8, input_width=16, img_height=8, img_width=16,
                 n_lat=8, n_lon=16, height=8, width=16, lifting_channels=8,
                 projection_channels=8, n_layers=1)
SMALL_OF = {"FNO2DModule": dict(hidden_channels=8), "TFNO2DModule": dict(hidden_channels=8),
            "PanguWeather": dict(window_size=[2, 2, 4], patch_size=[1, 1])}


def test_every_jax_model_type_builds_in_the_port():
    """Every `type` of the JAX registry (`dlwpbench_tpu/models/__init__.py`)
    resolves in the port's registry and builds at small widths on an 8 x
    16 grid; the port registers no type that JAX lacks."""
    from dlwpbench_tpu.models import registry as jregistry

    assert set(registry._REGISTRY) == set(jregistry._REGISTRY)
    for name in sorted(jregistry._REGISTRY):
        model = registry.build_model({"type": name, **SMALL_ANY, **SMALL_OF.get(name, {})},
                                     grid_shape=(8, 16))
        assert isinstance(model, registry.get_model_class(name)), name
        assert sum(p.numel() for p in model.parameters()) > 0, name


def test_unet_bf16_rollout_stays_bf16():
    """The port's counterpart of `tests/test_bf16_zoo.py` for the U-Net:
    bf16 parameters and inputs give a finite bf16 rollout."""
    cfg = dict(YAML, hidden_channels=(8, 16))
    model = tunet.UNet(**cfg, seed=0).to(torch.bfloat16)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in _batch(1, cfg, 16, 32)[:3]]
    with torch.no_grad():
        out = model(*args)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
