"""2D incompressible Navier-Stokes pseudo-spectral solver (vorticity form),
on `torch.fft` (counterpart of `dlwpbench_tpu/data/ns2d.py`):

    dw/dt + u . grad(w) = nu * Lap(w) + f,      div(u) = 0
    f(x, y) = 0.1 * (sin(2*pi*(x+y)) + cos(2*pi*(x+y)))

on the periodic unit torus, the initial vorticity drawn from the Gaussian
random field N(0, 7^{3/2} (-Lap + 49 I)^{-2.5}) (the FNO setup).  The state
lives in Fourier space (complex64, [B, n, n//2+1]); each step is Heun
advection with Crank-Nicolson viscosity and 2/3 dealiasing of the
advection term, as the JAX solver's.

The JAX package runs the time loop as one jitted `lax.scan`; here it is a
Python loop of eager ops on the state's device, so a step is kept to few
launches:
- the spectral tables live on the device, built once per grid and device
  (`utils.device.device_constant`);
- the four derivative multipliers of `_nonlinear` (the velocity from the
  streamfunction, `1j*ky*(-inv_lap)` and `1j*kx*inv_lap`, and the
  vorticity gradient, `1j*kx` and `1j*ky`) are one precomputed complex
  table [4, n, n//2+1], so the four spectra are one product and their
  four inverse transforms one `irfft2` over the stacked tensor;
- the dealiasing mask and its sign, and the forcing, are one `addcmul`.
Folding the multipliers rounds once where the JAX solver rounds twice
(1 ulp); over a few records the two agree within the tolerance the tests
state.  The Heun and Crank-Nicolson updates keep JAX's order of
operations (`_crank_nicolson`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dlwpbench_tpu_torch.utils.device import device_constant


class NSGrid(NamedTuple):
    n: int
    kx: torch.Tensor  # [n, n//2+1]
    ky: torch.Tensor
    lap: torch.Tensor  # -(kx^2+ky^2)
    inv_lap: torch.Tensor  # -1/(kx^2+ky^2), the 0 mode zeroed
    dealias: torch.Tensor  # 2/3-rule mask (bool)


def _grid_tables(n: int) -> dict[str, np.ndarray]:
    """The JAX package's `make_grid` tables, built by numpy the same way."""
    k = np.fft.fftfreq(n, 1.0 / n)  # integer wavenumbers
    kr = np.fft.rfftfreq(n, 1.0 / n)
    ky = np.broadcast_to(k[:, None], (n, n // 2 + 1)) * (2 * np.pi)
    kx = np.broadcast_to(kr[None, :], (n, n // 2 + 1)) * (2 * np.pi)
    k2 = kx**2 + ky**2
    inv_lap = np.where(k2 == 0, 0.0, -1.0 / np.where(k2 == 0, 1.0, k2))
    cutoff = n // 3  # keep |k| <= n/3 (2/3 rule)
    mask = (np.abs(k[:, None]) <= cutoff) & (np.abs(kr[None, :]) <= cutoff)
    return dict(kx=kx.astype(np.float32), ky=ky.astype(np.float32),
                lap=(-k2).astype(np.float32), inv_lap=inv_lap.astype(np.float32), dealias=mask)


def make_grid(n: int) -> NSGrid:
    return NSGrid(n=n, **{k: torch.from_numpy(v) for k, v in _grid_tables(n).items()})


def _multipliers(n: int) -> np.ndarray:
    """[4, n, n//2+1] complex64: the spectra of u, v, dw/dx and dw/dy are
    w_hat times these (u = d(psi)/dy, v = -d(psi)/dx, Lap(psi) = -w)."""
    g = _grid_tables(n)
    kx, ky, inv = (g[k].astype(np.float64) for k in ("kx", "ky", "inv_lap"))
    return (1j * np.stack([-ky * inv, kx * inv, kx, ky])).astype(np.complex64)


def _neg_dealias(n: int) -> np.ndarray:
    return (-_grid_tables(n)["dealias"].astype(np.float32)).astype(np.complex64)


def _crank_nicolson(n: int, nu: float, dt: float) -> np.ndarray:
    """[2, n, n//2+1]: the viscous term's numerator and inverse denominator,
    1 + dt*nu*lap/2 and 1 / (1 - dt*nu*lap/2), in the JAX solver's float32
    arithmetic, stored as complex64 so that the products with the state
    need no cast.  The updates keep the JAX solver's order of operations:
    folding dt or the numerator into the denominator rounds each mode's
    amplification once more, a bias that grows with every step (6e-6 of
    max|w| after 1,000 steps at n 32 on this solver, against 3e-7)."""
    lap = _grid_tables(n)["lap"]
    half = np.float32(0.5) * np.float32(dt) * np.float32(nu)
    cn = np.stack([np.float32(1.0) + half * lap, np.float32(1.0) / (np.float32(1.0) - half * lap)])
    return cn.astype(np.complex64)


def gaussian_random_field(noise_or_gen, n: int, batch: int = 1) -> torch.Tensor:
    """Initial vorticity [batch, n, n] ~ N(0, 7^{3/2} (-Lap + 49 I)^{-2.5}).

    `noise_or_gen` is either the standard-normal noise [batch, n, n] itself
    (the JAX package draws it from `jax.random.normal`, which torch cannot
    reproduce) or a `torch.Generator` to draw it from, on the generator's
    device."""
    if isinstance(noise_or_gen, torch.Generator):
        noise = torch.randn((batch, n, n), generator=noise_or_gen,
                            device=noise_or_gen.device, dtype=torch.float32)
    else:
        noise = torch.as_tensor(noise_or_gen, dtype=torch.float32)
    k = torch.fft.fftfreq(n, 1.0 / n, device=noise.device) * 2 * np.pi
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    # sqrt of the covariance spectrum; tau=7, alpha=2.5, d=2
    scale = np.float32(np.float32(n**1.0) * np.sqrt(np.float32(2.0))) * np.float32(7.0**1.5)
    sqrt_eig = float(scale) * (k2 + 49.0) ** (-1.25)
    sqrt_eig[0, 0] = 0.0
    w_hat = sqrt_eig[None] * torch.fft.fft2(noise)
    return torch.fft.ifft2(w_hat).real.contiguous()


def default_forcing(n: int) -> np.ndarray:
    x = np.linspace(0, 1, n, endpoint=False)
    X, Y = np.meshgrid(x, x, indexing="ij")
    return (0.1 * (np.sin(2 * np.pi * (X + Y)) + np.cos(2 * np.pi * (X + Y)))).astype(np.float32)


def _nonlinear(w_hat: torch.Tensor, mult: torch.Tensor, neg_dealias: torch.Tensor,
               f_hat: torch.Tensor, n: int) -> torch.Tensor:
    """Dealiased advection term -(u . grad w) plus the forcing, in spectral
    space: the four spectra as one product, one irfft2 of the stack."""
    phys = torch.fft.irfft2(w_hat[:, None] * mult, s=(n, n))  # [B, 4, n, n]: u, v, wx, wy
    adv = (phys[:, :2] * phys[:, 2:]).sum(1)  # u * wx + v * wy
    return torch.addcmul(f_hat, torch.fft.rfft2(adv), neg_dealias)


def nonlinear(w_hat: torch.Tensor, n: int) -> torch.Tensor:
    """The JAX package's `_nonlinear(w_hat, make_grid(n))`: the advection
    term alone, without forcing."""
    dev = w_hat.device
    return _nonlinear(w_hat, device_constant(_multipliers, n, device=dev),
                      device_constant(_neg_dealias, n, device=dev),
                      torch.zeros((), dtype=torch.complex64, device=dev), n)


@torch.no_grad()
def simulate(w0: torch.Tensor, *, n: int, nu: float = 1e-3, dt: float = 1e-3,
             record_steps: int = 50, inner_steps: int = 1000,
             forcing=None) -> torch.Tensor:
    """Integrate the vorticity w0 [B, n, n] forward on its device; record
    every `inner_steps * dt` time units.  Returns [B, record_steps + 1, n,
    n], w0 first."""
    dev = w0.device
    w0 = w0.to(torch.float32)
    if forcing is None:
        forcing = device_constant(default_forcing, n, device=dev)
    f_hat = torch.fft.rfft2(torch.as_tensor(forcing, dtype=torch.float32, device=dev))[None]
    mult = device_constant(_multipliers, n, device=dev)
    neg_dealias = device_constant(_neg_dealias, n, device=dev)
    cn_num, cn_den = device_constant(_crank_nicolson, n, float(nu), float(dt), device=dev)
    dt = float(np.float32(dt))

    def step(w_hat):
        a = w_hat * cn_num
        nl1 = _nonlinear(w_hat, mult, neg_dealias, f_hat, n)
        w_mid = torch.add(a, nl1, alpha=dt).mul_(cn_den)
        nl1 += _nonlinear(w_mid, mult, neg_dealias, f_hat, n)
        return torch.add(a, nl1, alpha=0.5 * dt).mul_(cn_den)

    traj = torch.empty((w0.shape[0], record_steps + 1, n, n), dtype=torch.float32, device=dev)
    traj[:, 0] = w0
    w_hat = torch.fft.rfft2(w0)
    for r in range(record_steps):
        for _ in range(inner_steps):
            w_hat = step(w_hat)
        traj[:, r + 1] = torch.fft.irfft2(w_hat, s=(n, n))
    return traj


def initial_field(seed: int, n: int, batch: int) -> torch.Tensor:
    """The dataset's initial vorticity [batch, n, n], drawn on the host from
    a generator seeded with `seed`, so that every device starts from the
    same field."""
    return gaussian_random_field(torch.Generator().manual_seed(int(seed)), n, batch)


def generate_dataset(seed: int, n: int = 64, batch: int = 8, nu: float = 1e-3,
                     dt: float = 1e-3, record_steps: int = 50, inner_steps: int = 1000,
                     device="cuda") -> np.ndarray:
    """The initial field of `initial_field(seed)`, simulated on `device`:
    numpy [batch, record_steps + 1, n, n]."""
    w0 = initial_field(seed, n, batch).to(device)
    return simulate(w0, n=n, nu=nu, dt=dt, record_steps=record_steps,
                    inner_steps=inner_steps).cpu().numpy()
