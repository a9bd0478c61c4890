"""The port's spectral ops (`dlwpbench_tpu_torch/ops/spectral.py`) against
the JAX package's on the CPU.

JAX parameters reach the port's layers through `weights.load_flax_params`;
inputs come from numpy seeds.  Tolerances, fp32:
- the DFT tables and `_tucker_core_dims`: bit for bit (the same numpy);
- `rfft2_matmul` / `irfft2_matmul`: 1e-6 absolute on unit-variance fields
  (real einsums summed in other orders);
- `SpectralConv2d` and `AFNO2DFilter` on both `fft_impl` branches: the
  output and every parameter's and the input's gradient within 1e-4 of
  that tensor's max|value| (the DFT sums and the per-mode products in
  other orders; pocketfft against XLA's FFT on the "fft" branch);
- the two branches of the port against each other: the same 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_dist_child import one_rank_mesh
from dlwpbench_tpu.ops import spectral as jsp
from dlwpbench_tpu_torch import weights
from dlwpbench_tpu_torch.ops import spectral as tsp

TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the ops here are small, and the
    suite's workers share the cores (each extra thread only waits on the
    others)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_close_per_tensor(got: dict, want: dict, tol: float = TOL):
    assert set(got) == set(want)
    for path, g in got.items():
        w = np.asarray(want[path])
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max())
        assert np.abs(g - w).max() <= tol * max(scale, 1e-6), (
            path, float(np.abs(g - w).max()), scale)


# ---------------------------------------------------------------- tables
@pytest.mark.parametrize("n", [7, 8, 16, 33])
def test_dft_tables_equal_jax(n):
    for name in ("_dft_mats_w", "_dft_mats_h", "_idft_mats_w"):
        for got, want in zip(getattr(tsp, name)(n), getattr(jsp, name)(n)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("H, W, m1, m2", [(8, 16, 3, 4), (8, 16, 4, 9), (32, 64, 12, 12),
                                          (7, 11, 3, 6), (32, 64, 16, 16)])
def test_band_dft_tables_equal_jax(H, W, m1, m2):
    for got, want in zip(tsp._band_dft_mats(H, W, m1, m2), jsp._band_dft_mats(H, W, m1, m2)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dims, rank", [((32, 32, 12, 12), 0.8), ((8, 8, 3, 4), 0.8),
                                        ((16, 16, 4, 4), 0.5), ((64, 64, 16, 16), 1.0)])
def test_tucker_core_dims_equal_jax(dims, rank):
    assert tsp._tucker_core_dims(dims, rank) == jsp._tucker_core_dims(dims, rank)


def test_tables_stay_on_the_device_once():
    """A forward pass takes each table from one cached tensor: the same
    object call after call, no copy per forward."""
    a = tsp._device_tables(tsp._band_dft_mats, 8, 16, 3, 4, device=torch.device("cpu"))
    b = tsp._device_tables(tsp._band_dft_mats, 8, 16, 3, 4, device=torch.device("cpu"))
    assert len(a) == 6 and all(x is y for x, y in zip(a, b))


# ---------------------------------------------------------------- matmul DFTs
@pytest.mark.parametrize("shape", [(2, 8, 16, 3), (1, 7, 11, 2)])
def test_rfft2_matmul_matches_jax(shape):
    x = _randn(0, *shape)
    jr, ji = jsp.rfft2_matmul(jnp.asarray(x))
    tr, ti = tsp.rfft2_matmul(torch.from_numpy(x))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=1e-6)
    # and the ortho rfft2 itself
    want = np.fft.rfft2(x, axes=(1, 2), norm="ortho")
    np.testing.assert_allclose(tr.numpy(), want.real, rtol=0, atol=1e-5)
    H, W = shape[1:3]
    back = tsp.irfft2_matmul(tr, ti, H, W).numpy()
    np.testing.assert_allclose(back, np.asarray(jsp.irfft2_matmul(jr, ji, H, W)), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-5)


# ---------------------------------------------------------------- SpectralConv2d
def _grads_of(module, x, loss_w):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = module(xt)
    loss = (out * torch.from_numpy(loss_w)).sum()
    loss.backward()
    grads = weights.flatten_tree(weights.to_flax_tree(
        module, {n: p.grad for n, p in module.named_parameters()}))
    return out.detach().numpy(), {**grads, "x": xt.grad.numpy()}


def _jax_grads(jmod, params, x, loss_w):
    def loss_fn(p, xx):
        out = jmod.apply(p, xx)
        return (out * loss_w).sum(), out

    (_, out), (g, gx) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    return np.asarray(out), {**weights.flatten_tree(_np_tree(g["params"])), "x": np.asarray(gx)}


# (H, W, Cin, Cout, modes): the matmul branch's bands, the fft branch's
# overlapping bands (2 m1 > H), an odd grid, m2 at the Nyquist column
SC_CASES = [(8, 16, 3, 4, (3, 4)), (8, 16, 2, 3, (6, 4)), (7, 11, 3, 2, (3, 5)),
            (8, 16, 2, 2, (4, 9))]


@pytest.mark.parametrize("fft_impl", ["matmul", "fft"])
@pytest.mark.parametrize("tucker", [None, 0.8])
@pytest.mark.parametrize("H, W, cin, cout, modes", SC_CASES)
def test_spectral_conv_matches_jax(H, W, cin, cout, modes, tucker, fft_impl):
    x = _randn(1, 2, H, W, cin)
    loss_w = _randn(2, 2, H, W, cout)
    jmod = jsp.SpectralConv2d(cout, *modes, tucker_rank=tucker, fft_impl=fft_impl)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    j_out, j_grads = _jax_grads(jmod, params, x, loss_w)
    tmod = tsp.SpectralConv2d(cin, cout, *modes, tucker_rank=tucker, fft_impl=fft_impl,
                              grid_shape=(H, W))
    weights.load_flax_params(tmod, _np_tree(params))
    out, grads = _grads_of(tmod, x, loss_w)
    _assert_close_per_tensor({"out": out, **grads}, {"out": j_out, **j_grads})


@pytest.mark.parametrize("tucker", [None, 0.8])
def test_spectral_conv_branches_agree(tucker):
    """The matmul branch against the fft branch on the same weights."""
    x = _randn(3, 2, 8, 16, 3)
    loss_w = _randn(4, 2, 8, 16, 4)
    a = tsp.SpectralConv2d(3, 4, 3, 4, tucker_rank=tucker, grid_shape=(8, 16))
    b = tsp.SpectralConv2d(3, 4, 3, 4, tucker_rank=tucker, fft_impl="fft", grid_shape=(8, 16))
    b.load_state_dict(a.state_dict())
    out_a, g_a = _grads_of(a, x, loss_w)
    out_b, g_b = _grads_of(b, x, loss_w)
    _assert_close_per_tensor({"out": out_b, **g_b}, {"out": out_a, **g_a})


def test_spectral_conv_grid_decides_the_modes():
    """`grid_shape` is required and sizes the weights as JAX's first input
    does; a field whose grid keeps other modes raises and names the fix."""
    with pytest.raises(TypeError, match="grid_shape"):
        tsp.SpectralConv2d(2, 2, 16, 16)
    conv = tsp.SpectralConv2d(2, 2, 16, 16, grid_shape=(32, 64))
    assert conv.weights1.shape == (2, 2, 16, 16, 2)
    with pytest.raises(ValueError, match="grid_shape=\\(8, 16\\)"):
        conv(torch.zeros(1, 8, 16, 2))
    x = _randn(0, 1, 8, 16, 2)
    jshape = jsp.SpectralConv2d(2, 16, 16).init(jax.random.PRNGKey(0), jnp.asarray(x))
    assert (tsp.SpectralConv2d(2, 2, 16, 16, grid_shape=(8, 16)).weights1.shape
            == jshape["params"]["weights1"].shape == (2, 2, 8, 9, 2))
    with pytest.raises(ValueError, match="fft_impl"):
        tsp.SpectralConv2d(2, 2, fft_impl="dft", grid_shape=(8, 16))


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in jax.tree_util.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("fft_impl", ["matmul", "fft"])
def test_tucker_path_never_builds_the_dense_weight(fft_impl):
    """No op of the Tucker forward or backward returns a tensor holding
    the dense weight's four dims [Cin, Cout, m1, m2] (in any order); the
    dims are chosen distinct from every other size here."""
    cin, cout, m1, m2 = 7, 6, 3, 4
    conv = tsp.SpectralConv2d(cin, cout, m1, m2, tucker_rank=0.8, fft_impl=fft_impl,
                              grid_shape=(8, 16))
    x = torch.from_numpy(_randn(0, 2, 8, 16, cin)).requires_grad_(True)
    with _Shapes() as rec:
        conv(x).square().sum().backward()
    dense = sorted((cin, cout, m1, m2))
    assert rec.shapes
    for shape in rec.shapes:
        rest = list(shape)
        for d in dense:
            if d not in rest:
                break
            rest.remove(d)
        else:
            pytest.fail(f"an op built a tensor of shape {shape}: the dense weight's dims")
    assert x.grad is not None and conv.weights1_core.grad is not None


# ---------------------------------------------------------------- AFNO
# (H, W, C, blocks, hard-thresholding fraction)
AFNO_CASES = [(8, 16, 8, 2, 1.0), (7, 11, 6, 3, 1.0), (8, 16, 8, 4, 0.5)]


@pytest.mark.parametrize("fft_impl", ["matmul", "fft"])
@pytest.mark.parametrize("H, W, C, nb, frac", AFNO_CASES)
def test_afno_filter_matches_jax(H, W, C, nb, frac, fft_impl):
    # a small sparsity threshold keeps values on both sides of the dead band
    x = _randn(5, 2, H, W, C)
    loss_w = _randn(6, 2, H, W, C)
    kw = dict(num_blocks=nb, sparsity_threshold=1e-3, hard_thresholding_fraction=frac,
              fft_impl=fft_impl)
    jmod = jsp.AFNO2DFilter(hidden_size=C, **kw)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    # larger weights than the 0.02 init, so that the MLP's ReLU and the
    # softshrink cut, and the gradients carry more than the residual
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 25.0, params)
    j_out, j_grads = _jax_grads(jmod, params, x, loss_w)
    tmod = tsp.AFNO2DFilter(C, **kw)
    weights.load_flax_params(tmod, params)
    out, grads = _grads_of(tmod, x, loss_w)
    _assert_close_per_tensor({"out": out, **grads}, {"out": j_out, **j_grads})
    # the filter's own part, beside the residual
    _assert_close_per_tensor({"f": out - x}, {"f": j_out - x})


def test_afno_branches_agree_and_band_quirk():
    """matmul against fft on one set of weights; on 32 x 64 the kept count
    int(17 x 1.0) bounds the longitude columns too (17 of 33 modes)."""
    x = _randn(7, 1, 32, 64, 8)
    a = tsp.AFNO2DFilter(8, 2, fft_impl="matmul")
    b = tsp.AFNO2DFilter(8, 2, fft_impl="fft")
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        for p in a.parameters():
            p.mul_(25.0)
        b.load_state_dict(a.state_dict())
        xa = torch.from_numpy(x)
        ya, yb = a(xa), b(xa)
    scale = (ya - xa).abs().max().item()
    assert (ya - yb).abs().max().item() <= TOL * scale
    assert a._band(32) == (0, 32, 17)


def test_afno_raises():
    """With a mesh (one rank here) the filter builds and agrees with the
    single-device one; a width that does not split into blocks raises."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 8, 16, 8)).astype(
        np.float32))
    single = tsp.AFNO2DFilter(8, 2)
    with torch.no_grad():
        for p in single.parameters():
            p.mul_(25.0)  # out of softshrink's dead band
    want = single(x)
    with one_rank_mesh() as mesh:
        meshed = tsp.AFNO2DFilter(8, 2, spmd_mesh=mesh)
        meshed.load_state_dict(single.state_dict())
        got = meshed(x)
    assert (got - want).abs().max() <= TOL * (want - x).abs().max()
    with pytest.raises(ValueError, match="blocks"):
        tsp.AFNO2DFilter(8, 3)


def test_softshrink_matches_jax():
    x = np.linspace(-0.05, 0.05, 101).astype(np.float32)
    np.testing.assert_array_equal(tsp.softshrink(torch.from_numpy(x), 0.01).numpy(),
                                  np.asarray(jsp.softshrink(jnp.asarray(x), 0.01)))


def test_port_layers_carry_flax_names():
    """A flax module holding the layers names them `SpectralConv2d_0`,
    `AFNO2DFilter_0`, with the leaves the port declares."""

    class Both(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return jsp.AFNO2DFilter(4, 2)(jsp.SpectralConv2d(4, 3, 3, tucker_rank=0.8)(x))

    x = jnp.asarray(_randn(0, 1, 8, 16, 4))
    p = Both().init(jax.random.PRNGKey(0), x)["params"]
    assert sorted(p["SpectralConv2d_0"]) == sorted(
        n for n, _ in tsp.SpectralConv2d(4, 4, 3, 3, tucker_rank=0.8, grid_shape=(8, 16)).named_parameters())
    assert sorted(p["AFNO2DFilter_0"]) == sorted(
        n for n, _ in tsp.AFNO2DFilter(4, 2).named_parameters())
