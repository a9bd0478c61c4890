"""The port's spherical harmonic transform (`dlwpbench_tpu_torch/ops/sht.py`)
against the JAX package's on the CPU, and the analytic cases of
`tests/test_sht.py`, mirrored.

Tolerances:
- the tables (quadrature nodes and weights, the Legendre table, the
  analysis tables with their per-m pseudo-inverse, the longitude DFT):
  bit for bit (the same numpy, float64 cast to float32);
- `sht_real` / `isht_real` and `sht` / `isht` against JAX on unit-variance
  fields: 1e-5 of the result's max|value| (einsums summed in other orders,
  pocketfft against XLA's FFT);
- the analytic cases (Y_10, Re Y_11, Re Y_32 to one coefficient; the
  bandlimited round trip; Parseval): `tests/test_sht.py`'s own tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlwpbench_tpu.ops import sht as jsht
from dlwpbench_tpu_torch.ops import sht as tsht

GRIDS = ["legendre-gauss", "equiangular"]
REL = 1e-5


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


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-6), (
        float(np.abs(got - want).max()), float(np.abs(want).max()))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("nlat, nlon, lmax, mmax", [(16, 32, None, None), (32, 64, 32, None),
                                                    (8, 16, 6, 5), (7, 12, None, None)])
def test_tables_equal_jax(grid, nlat, nlon, lmax, mmax):
    got = tsht.sht_tables(nlat, nlon, lmax, mmax, grid)
    want = jsht.sht_tables(nlat, nlon, lmax, mmax, grid)
    assert (got.nlat, got.nlon, got.lmax, got.mmax) == (want.nlat, want.nlon, want.lmax,
                                                        want.mmax)
    assert got.grid == grid
    for name in ("fwd", "inv", "theta"):
        assert getattr(got, name).dtype == getattr(want, name).dtype
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for g, w in zip(tsht._lon_dft_tables(nlon, got.mmax), jsht._lon_dft_tables(nlon, got.mmax)):
        np.testing.assert_array_equal(g, w)


def test_quadrature_and_legendre_equal_jax():
    for fn in ("gauss_legendre", "equiangular_midpoint"):
        for g, w in zip(getattr(tsht, fn)(24), getattr(jsht, fn)(24)):
            np.testing.assert_array_equal(g, w)
    x = np.cos(np.linspace(0.1, 3.0, 9))
    np.testing.assert_array_equal(tsht._legendre_table(10, 7, x), jsht._legendre_table(10, 7, x))
    np.testing.assert_array_equal(tsht.laplacian_eigenvalues(12, 2.0),
                                  jsht.laplacian_eigenvalues(12, 2.0))


@pytest.mark.parametrize("grid", GRIDS)
def test_transforms_match_jax(grid):
    t_t, t_j = tsht.sht_tables(16, 32, grid=grid), jsht.sht_tables(16, 32, grid=grid)
    f = _randn(3, 2, 3, 16, 32)
    ft = torch.from_numpy(f)
    jr, ji = jsht.sht_real(jnp.asarray(f), t_j)
    tr, ti = tsht.sht_real(ft, t_t)
    _close(tr.numpy(), jr)
    _close(ti.numpy(), ji)
    _close(tsht.isht_real(tr, ti, t_t).numpy(), jsht.isht_real(jr, ji, t_j))
    a_j = np.asarray(jsht.sht(jnp.asarray(f), t_j))
    a_t = tsht.sht(ft, t_t)
    assert a_t.dtype == torch.complex64
    _close(a_t.numpy().real, a_j.real)
    _close(a_t.numpy().imag, a_j.imag)
    _close(tsht.isht(a_t, t_t).numpy(), jsht.isht(jnp.asarray(a_j), t_j))
    # the two paths of the port against each other (`tests/test_sht.py::
    # test_sht_real_matches_complex`'s tolerances)
    np.testing.assert_allclose(a_t.numpy().real, tr.numpy(), atol=2e-6)
    np.testing.assert_allclose(tsht.isht(a_t, t_t).numpy(), tsht.isht_real(tr, ti, t_t).numpy(),
                               atol=5e-6)


def test_truncated_band_pads_like_jax():
    """mmax below nlon/2 + 1: `isht` pads the band before the irfft."""
    t_t, t_j = tsht.sht_tables(8, 16, 6, 5), jsht.sht_tables(8, 16, 6, 5)
    a = (_randn(0, 2, 6, 5) + 1j * _randn(1, 2, 6, 5)).astype(np.complex64)
    _close(tsht.isht(torch.from_numpy(a), t_t).numpy(), jsht.isht(jnp.asarray(a), t_j))


# ---------------------------------------------------------------- analytic (mirrored)
def _grid_field(tables, fn):
    theta = tables.theta
    phi = 2 * np.pi * np.arange(tables.nlon) / tables.nlon
    T, P = np.meshgrid(theta, phi, indexing="ij")
    return fn(T, P)


def _y10(theta, phi):
    return np.sqrt(3 / (4 * np.pi)) * np.cos(theta)


def _y11_real(theta, phi):
    return np.sqrt(3 / (8 * np.pi)) * np.sin(theta) * np.cos(phi)


def _y32_real(theta, phi):
    x = np.cos(theta)
    return np.sqrt(7 / (4 * np.pi) / 120.0) * 15 * x * (1 - x**2) * np.cos(2 * phi)


def _sht(t, f):
    return tsht.sht(torch.from_numpy(np.asarray(f, np.float32)[None]), t)[0].numpy()


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("fn, lm, value, tol", [(_y10, (1, 0), 1.0, 2e-5),
                                                (_y11_real, (1, 1), 0.5, 2e-5),
                                                (_y32_real, (3, 2), 0.5, 5e-5)],
                         ids=["y10", "y11", "y32"])
def test_harmonic_is_one_coefficient(grid, fn, lm, value, tol):
    t = tsht.sht_tables(16, 32, grid=grid)
    a = _sht(t, _grid_field(t, fn))
    assert abs(a[lm] - value) < tol
    a[lm] = 0
    assert np.abs(a).max() < tol


@pytest.mark.parametrize("grid", GRIDS)
def test_roundtrip_bandlimited(grid):
    t = tsht.sht_tables(16, 32, grid=grid)
    rng = np.random.default_rng(0)
    a = np.zeros((t.lmax, t.mmax), np.complex64)
    L = 12  # safely inside the band
    for l in range(L):
        for m in range(min(l + 1, t.mmax)):
            a[l, m] = rng.standard_normal() + 1j * rng.standard_normal() * (m > 0)
    a[:, 0] = a[:, 0].real
    f = tsht.isht(torch.from_numpy(a[None]), t)[0].numpy()
    a2 = _sht(t, f)
    np.testing.assert_allclose(a2[:L, :L], a[:L, :L], atol=5e-4)
    # the matmul path round-trips the same field
    ar, ai = tsht.sht_real(torch.from_numpy(f[None]), t)
    np.testing.assert_allclose(ar[0, :L, :L].numpy(), a[:L, :L].real, atol=5e-4)
    np.testing.assert_allclose(ai[0, :L, :L].numpy(), a[:L, :L].imag, atol=5e-4)


@pytest.mark.parametrize("grid", GRIDS)
def test_parseval(grid):
    t = tsht.sht_tables(24, 48, grid=grid)
    rng = np.random.default_rng(1)
    a = np.zeros((t.lmax, t.mmax), np.complex64)
    for l in range(16):
        for m in range(min(l + 1, 16)):
            a[l, m] = rng.standard_normal() + 1j * rng.standard_normal() * (m > 0)
    a[:, 0] = a[:, 0].real
    f = tsht.isht(torch.from_numpy(a[None]), t)[0].numpy()
    coeff_energy = np.sum(np.abs(a[:, 0]) ** 2) + 2 * np.sum(np.abs(a[:, 1:]) ** 2)
    w = (tsht.gauss_legendre if grid == "legendre-gauss" else tsht.equiangular_midpoint)(24)[1]
    grid_energy = (2 * np.pi / 48) * np.sum(w[:, None] * f**2)
    assert grid_energy == pytest.approx(coeff_energy, rel=1e-3)


def test_unknown_grid_raises():
    with pytest.raises(ValueError, match="unknown grid"):
        tsht.sht_tables(8, 16, grid="healpix")
