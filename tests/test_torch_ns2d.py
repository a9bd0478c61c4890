"""The port's Navier-Stokes solver (`data/ns2d.py`), its data source and
the insolation and wb_learnable tools, against the JAX package on the CPU.

The initial field is JAX's own draw (`jax.random.normal` cannot be
reproduced in torch): both solvers start from it.  Tolerances, fp32:
- `make_grid`'s tables, the source's splits, statistics and windows on the
  same trajectories: bit for bit;
- the Gaussian random field from JAX's noise: 1e-6 of its max|value|
  (pocketfft against XLA's FFT; measured 2e-7);
- `_nonlinear` on one spectrum: 1e-6 of its max (the folded multipliers
  round once where JAX rounds twice; measured 1.4e-7);
- `simulate` at n 32, batch 2, 3 records of 20 steps: 1e-5 of max|w|
  (measured 2.4e-7; the solver is not chaotic at this viscosity over
  these horizons);
- the pure-diffusion decay: rel 1e-3 of exp(-nu k^2 t), as
  `tests/test_data.py`;
- `insolation` on dates: bit for bit; `insolation_torch` against
  `insolation_jax`: 1e-6 (measured 3e-7);
- the wb_learnable store against `scripts/make_wb_learnable.py` at
  `--years 1979 1979 --inner-steps 2` from the same initial field: the
  insolation, coordinates and constants bit for bit, `msl` and `stream`
  within 1e-5 of each field's standard deviation (measured 7.5e-6 and
  1.2e-6: 1 ulp of msl's 1e5 and 8 ulp of stream's 1e8 values; the JAX
  script restarts every 400 records through an irfft2/rfft2 round trip,
  the port runs one simulation).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlwpbench_tpu.data import insolation as jins
from dlwpbench_tpu.data import ns2d as jns
from dlwpbench_tpu.data import sources as jsources
from dlwpbench_tpu_torch import make_wb_learnable as twb
from dlwpbench_tpu_torch.data import insolation as tins
from dlwpbench_tpu_torch.data import ns2d as tns
from dlwpbench_tpu_torch.data import sources as tsources
from dlwpbench_tpu_torch.data import zarr_lite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the solver's and the models' ops
    here are tiny, and the suite's workers share the cores (each extra
    thread only waits on the others)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_field(seed, n, batch):
    """JAX's initial field and its standard-normal noise, as numpy."""
    key = jax.random.PRNGKey(seed)
    noise = np.array(jax.random.normal(key, (batch, n, n), jnp.float32))
    return np.array(jns.gaussian_random_field(key, n, batch)), noise


@pytest.mark.parametrize("n", [16, 32, 33])
def test_make_grid_equals_jax(n):
    jg, tg = jns.make_grid(n), tns.make_grid(n)
    assert tg.n == jg.n == n
    for name in ("kx", "ky", "lap", "inv_lap", "dealias"):
        want, got = np.asarray(getattr(jg, name)), getattr(tg, name).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), name


def test_grf_from_jax_noise_and_its_moments():
    want, noise = _jax_field(0, 32, 2)
    got = tns.gaussian_random_field(torch.from_numpy(noise), 32, 2).numpy()
    assert got.shape == want.shape == (2, 32, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    # the port's own draw (test_data.py's properties): the k = 0 mode is gone
    w0 = tns.gaussian_random_field(torch.Generator().manual_seed(1), 64, 4).numpy()
    assert abs(w0.mean()) < 1e-3 and w0.std() > 0.1


def test_nonlinear_matches_jax():
    w0, _ = _jax_field(3, 32, 2)
    w_hat = np.fft.rfft2(w0).astype(np.complex64)
    want = np.asarray(jns._nonlinear(jnp.asarray(w_hat), jns.make_grid(32)))
    got = tns.nonlinear(torch.from_numpy(w_hat), 32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_simulate_matches_jax():
    w0, _ = _jax_field(0, 32, 2)
    want = np.asarray(jns.simulate(jnp.asarray(w0), n=32, record_steps=3, inner_steps=20))
    got = tns.simulate(torch.from_numpy(w0), n=32, record_steps=3, inner_steps=20).numpy()
    assert got.shape == want.shape == (2, 4, 32, 32)
    np.testing.assert_array_equal(got[:, 0], w0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # viscosity + small forcing: the enstrophy must not blow up
    ens = (got**2).mean(axis=(2, 3))
    assert np.isfinite(got).all() and ens[:, -1].max() < ens[:, 0].max() * 2.0


def test_pure_diffusion_decay():
    """With zero forcing and high viscosity the amplitude decays as
    exp(-nu k^2 t)."""
    n, k, nu, dt, steps = 32, 2, 1e-2, 1e-3, 100
    x = np.linspace(0, 1, n, endpoint=False)
    X, _ = np.meshgrid(x, x, indexing="ij")
    w0 = torch.from_numpy(np.sin(2 * np.pi * k * X).astype(np.float32))[None]
    traj = tns.simulate(w0, n=n, nu=nu, dt=dt, record_steps=1, inner_steps=steps,
                        forcing=torch.zeros(n, n)).numpy()
    expected = np.exp(-nu * (2 * np.pi * k) ** 2 * dt * steps)
    assert np.abs(traj[0, 1]).max() / np.abs(traj[0, 0]).max() == pytest.approx(expected,
                                                                                 rel=1e-3)


def test_generate_dataset_starts_from_the_host_draw():
    """The initial field is drawn on the host from `seed`, whatever the
    device: the first frame is `initial_field(seed)` and a second call
    repeats the trajectories bit for bit."""
    a = tns.generate_dataset(5, n=16, batch=2, record_steps=2, inner_steps=3, device="cpu")
    b = tns.generate_dataset(5, n=16, batch=2, record_steps=2, inner_steps=3, device="cpu")
    assert a.shape == (2, 3, 16, 16) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[:, 0], tns.initial_field(5, 16, 2).numpy())


NS_CFG = dict(type="NavierStokes", n=8, nu=1e-3, dt=1e-3, inner_steps=2, n_trajectories=7,
              record_steps=9, seed=3, normalize=True)


def test_navier_stokes_source_matches_jax(monkeypatch):
    """Both sources on the same trajectories (each side's generator
    monkeypatched): the 70/15/15 trajectory split, the stats under
    "vorticity", and every window (across trajectory boundaries, as JAX)
    bit for bit; the port solves on the device it is given."""
    traj = np.random.default_rng(0).standard_normal((7, 10, 8, 8)).astype(np.float32) * 3 + 1
    seen = {}

    def fake(side):
        def gen(**kw):
            seen[side] = kw
            return traj.copy()
        return gen

    monkeypatch.setattr(jns, "generate_dataset", fake("jax"))
    monkeypatch.setattr(tns, "generate_dataset", fake("torch"))
    tr, va, te = {"sequence_length": 3, "noise": 0.0}, {"sequence_length": 4}, {"sequence_length": 5}
    want = jsources.build_datasets(NS_CFG, tr, va, te, context_size=1)
    got = tsources.build_datasets(NS_CFG, tr, va, te, context_size=1, device="cpu")
    assert str(seen["torch"].pop("device")) == "cpu"
    assert seen["torch"] == seen["jax"]
    assert set(got[3]) == set(want[3]) == {"vorticity"}
    g_st, w_st = got[3]["vorticity"], want[3]["vorticity"]
    assert (g_st.mean, g_st.std) == (w_st.mean, w_st.std)
    for g, w, n_traj in zip(got[:3], want[:3], (4, 1, 2)):
        assert g.prognostic.shape == w.prognostic.shape == (n_traj * 10, 1, 8, 8)
        np.testing.assert_array_equal(g.prognostic, w.prognostic)
        assert g.constants is None and g.prescribed is None and len(g) == len(w) > 0
        for gb, wb in zip(g.batches(2), w.batches(2)):
            for a, b in zip(gb, wb):
                assert (a is None and b is None) or np.array_equal(a, b)


def test_navier_stokes_source_needs_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tsources.build_datasets(NS_CFG, {"sequence_length": 3}, {"sequence_length": 3})


# ---------------------------------------------------------------- insolation
LAT = np.linspace(-87.1875, 87.1875, 32).astype(np.float32)
LON = (np.arange(64) * (360.0 / 64)).astype(np.float32)


@pytest.mark.parametrize("daily", [False, True])
def test_insolation_equals_jax(daily):
    dates = np.datetime64("1979-12-30T18:00") + np.arange(0, 24 * 400, 6) * np.timedelta64(1, "h")
    want = jins.insolation(dates, LAT, LON, daily=daily)
    got = tins.insolation(dates, LAT, LON, daily=daily)
    assert got.shape == want.shape == (len(dates), 32, 64) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_insolation_torch_matches_insolation_jax():
    lat2d, lon2d = np.meshgrid(LAT, LON, indexing="ij")
    days = np.linspace(0, 365, 41).astype(np.float32)
    want = np.asarray(jins.insolation_jax(days, lat2d, lon2d))
    got = tins.insolation_torch(torch.from_numpy(days), lat2d, lon2d).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- wb_learnable
def test_make_wb_learnable_matches_the_jax_script(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import make_wb_learnable as jwb  # scripts/make_wb_learnable.py

    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    jwb.main(["--root", jroot, "--years", "1979", "1979", "--inner-steps", "2"])
    w0, _ = _jax_field(7, 64, 1)  # the JAX script's draw (seed 7)
    res = twb.make_wb_learnable(troot, (1979, 1979), inner_steps=2, device="cpu", w0=w0)
    assert res["frames"] == 1460
    stores = [("msl", "msl_1979_5.625deg.zarr"), ("stream", "stream_1979_5.625deg.zarr"),
              ("toa_incident_solar_radiation", "tisr_1979_5.625deg.zarr"),
              ("constants", "constants_5.625deg.zarr")]
    for d, name in stores:
        want = zarr_lite.ZarrGroup(os.path.join(jroot, d, name))
        got = zarr_lite.ZarrGroup(os.path.join(troot, d, name))
        assert sorted(got.array_keys()) == sorted(want.array_keys())
        for k in want.array_keys():
            w, g = want[k], got[k]
            assert g.dims == w.dims and g.shape == w.shape and g.dtype == w.dtype, (d, k)
            a, b = w.read(), g.read()
            if k in ("msl", "stream"):
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * float(np.std(a)))
            else:
                np.testing.assert_array_equal(b, a)
