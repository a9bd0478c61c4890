"""The real spherical harmonic transform (SHT), from scratch (counterpart
of `dlwpbench_tpu/ops/sht.py`).

Math (torch-harmonics' orthonormal convention):
  forward:  a[l, m] = 2*pi * sum_j w_j * Pbar_lm(theta_j) * X_m(j),
            X = rfft(f, lon axis, norm="forward")
  inverse:  X_m(j) = sum_l Pbar_lm(theta_j) * a[l, m];  f = irfft(X, "forward")

with Pbar the orthonormalised associated Legendre functions.  Grids:
"legendre-gauss" (Gauss-Legendre nodes and weights) and "equiangular"
(cell-centred colatitudes, the WeatherBench rows, with a per-m
least-squares analysis: `sht(isht(a)) == a` for bandlimited fields).

The tables (`gauss_legendre`, `equiangular_midpoint`, `_legendre_table`,
`sht_tables`, `_lon_dft_tables`) are the JAX module's numpy, float64 cast
to float32, built once per (nlat, nlon, lmax, mmax, grid); a transform
takes them on its tensor's device through `device_constant`, one copy per
(table, device).  `sht_real` / `isht_real` do the longitude DFT as real
matmuls and `sht` / `isht` through `torch.fft` (cuFFT on the card); the
Legendre contraction is an einsum batched over m in both.  JAX runs them
as `jnp.einsum` and `jnp.fft`, outside any Pallas kernel: no hand-written
kernel here either.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from dlwpbench_tpu_torch.utils.device import device_constant


def gauss_legendre(nlat: int) -> tuple[np.ndarray, np.ndarray]:
    """Colatitude nodes (ascending theta, north to south) and weights for
    integrating f(theta) sin(theta) dtheta over [0, pi]."""
    x, w = np.polynomial.legendre.leggauss(nlat)  # x ascending in cos-space
    theta = np.arccos(x[::-1])
    return theta, w[::-1].copy()


def equiangular_midpoint(nlat: int) -> tuple[np.ndarray, np.ndarray]:
    """Cell-centred equiangular colatitudes and Fejer moment-matched weights."""
    theta = np.pi * (np.arange(nlat) + 0.5) / nlat
    k = np.arange(nlat)
    # target moments: t_k = int_0^pi cos(k theta) sin(theta) dtheta
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (1.0 + np.cos(np.pi * k)) / (1.0 - k.astype(np.float64) ** 2)
    t[1] = 0.0
    C = np.cos(np.outer(k, theta))
    w = np.linalg.solve(C, t)
    return theta, w


def _legendre_table(lmax: int, mmax: int, x: np.ndarray) -> np.ndarray:
    """Orthonormalised associated Legendre functions [mmax, lmax, nlat],
    float64, zero where l < m; three-term recurrences, no Condon-Shortley
    phase (torch-harmonics')."""
    nlat = x.shape[0]
    out = np.zeros((mmax, lmax, nlat))
    sx = np.sqrt(np.clip(1.0 - x * x, 0.0, None))  # sin(theta)
    pmm = np.full(nlat, np.sqrt(1.0 / (4.0 * np.pi)))  # sectoral seeds Pbar_m^m
    for m in range(mmax):
        if m > 0:
            pmm = pmm * sx * np.sqrt((2 * m + 1) / (2.0 * m))
        if m < lmax:
            out[m, m] = pmm
        if m + 1 < lmax:
            out[m, m + 1] = np.sqrt(2 * m + 3.0) * x * pmm
        for l in range(m + 2, lmax):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            out[m, l] = a * (x * out[m, l - 1] - b * out[m, l - 2])
    return out


class SHTTables(NamedTuple):
    nlat: int
    nlon: int
    lmax: int
    mmax: int
    fwd: np.ndarray  # [mmax, nlat, lmax]: 2*pi * w_j * Pbar_lm(theta_j)
    inv: np.ndarray  # [mmax, lmax, nlat]: Pbar_lm(theta_j)
    theta: np.ndarray
    grid: str = "equiangular"  # the port's: keys the tables' device copies


@functools.lru_cache(maxsize=None)
def sht_tables(nlat: int, nlon: int, lmax: int | None = None, mmax: int | None = None,
               grid: str = "equiangular") -> SHTTables:
    lmax = lmax or nlat
    mmax = mmax or min(nlon // 2 + 1, lmax)
    if grid == "legendre-gauss":
        theta, w = gauss_legendre(nlat)
    elif grid == "equiangular":
        theta, w = equiangular_midpoint(nlat)
    else:
        raise ValueError(f"unknown grid {grid!r}")
    plm = _legendre_table(lmax, mmax, np.cos(theta))  # [m, l, nlat]
    if grid == "legendre-gauss":
        # exact quadrature: the analysis is the weighted adjoint of the synthesis
        fwd = 2.0 * np.pi * np.transpose(plm * w[None, None, :], (0, 2, 1))
    else:
        # per-m least squares (the synthesis matrix's pseudo-inverse)
        fwd = np.zeros((mmax, nlat, lmax))
        for m in range(mmax):
            S = plm[m].T  # [nlat, lmax] synthesis (zero columns for l < m)
            cols = np.arange(m, lmax)
            fwd[m, :, cols] = np.linalg.pinv(S[:, cols])
    return SHTTables(nlat=nlat, nlon=nlon, lmax=lmax, mmax=mmax, fwd=fwd.astype(np.float32),
                     inv=plm.astype(np.float32), theta=theta, grid=grid)


@functools.lru_cache(maxsize=None)
def _lon_dft_tables(nlon: int, mmax: int):
    """The longitude DFT as real matrices (the norm="forward" rfft
    convention restricted to the first `mmax` frequencies, the hermitian
    doubling folded into the inverse): (cr, ci) [nlon, mmax] and (icr, ici)
    [mmax, nlon]."""
    k = np.arange(nlon)[:, None]
    m = np.arange(mmax)[None, :]
    ang = 2.0 * np.pi * k * m / nlon
    cr = (np.cos(ang) / nlon).astype(np.float32)
    ci = (-np.sin(ang) / nlon).astype(np.float32)
    alpha = np.full(mmax, 2.0)
    alpha[0] = 1.0
    if nlon % 2 == 0 and mmax == nlon // 2 + 1:
        alpha[-1] = 1.0
    icr = (alpha[:, None] * np.cos(ang.T)).astype(np.float32)
    ici = (-alpha[:, None] * np.sin(ang.T)).astype(np.float32)
    return cr, ci, icr, ici


def _legendre(nlat, nlon, lmax, mmax, grid, name, complex_: bool):
    t = getattr(sht_tables(nlat, nlon, lmax, mmax, grid), name)
    return t.astype(np.complex64) if complex_ else t


def _tables_on(tables: SHTTables, name: str, device, complex_: bool = False) -> torch.Tensor:
    """`tables.fwd` or `tables.inv` on `device` (complex64 for the fft
    path), copied once per (tables, device)."""
    return device_constant(_legendre, tables.nlat, tables.nlon, tables.lmax, tables.mmax,
                           tables.grid, name, complex_, device=device)


def _lon_table(nlon, mmax, i):
    return _lon_dft_tables(nlon, mmax)[i]


def _lon_tables_on(tables: SHTTables, device) -> tuple[torch.Tensor, ...]:
    return tuple(device_constant(_lon_table, tables.nlon, tables.mmax, i, device=device)
                 for i in range(4))


def sht_real(f: torch.Tensor, tables: SHTTables) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward SHT with the longitude DFT as real matmuls: f [..., nlat,
    nlon] -> (ar, ai), each [..., lmax, mmax], fp32."""
    cr, ci, _, _ = _lon_tables_on(tables, f.device)
    fwd = _tables_on(tables, "fwd", f.device)  # [mmax, nlat, lmax]
    f = f.float()
    Xr = torch.einsum("...jk,km->...jm", f, cr)
    Xi = torch.einsum("...jk,km->...jm", f, ci)
    return (torch.einsum("...jm,mjl->...lm", Xr, fwd),
            torch.einsum("...jm,mjl->...lm", Xi, fwd))


def isht_real(ar: torch.Tensor, ai: torch.Tensor, tables: SHTTables) -> torch.Tensor:
    """Inverse of `sht_real`: (ar, ai) [..., lmax, mmax] -> [..., nlat, nlon]."""
    _, _, icr, ici = _lon_tables_on(tables, ar.device)
    inv = _tables_on(tables, "inv", ar.device)  # [mmax, lmax, nlat]
    Xr = torch.einsum("...lm,mlj->...jm", ar, inv)
    Xi = torch.einsum("...lm,mlj->...jm", ai, inv)
    return torch.einsum("...jm,mk->...jk", Xr, icr) + torch.einsum("...jm,mk->...jk", Xi, ici)


def sht(f: torch.Tensor, tables: SHTTables) -> torch.Tensor:
    """Forward real SHT through `torch.fft.rfft`: f [..., nlat, nlon] real
    -> [..., lmax, mmax] complex64."""
    X = torch.fft.rfft(f.float(), dim=-1, norm="forward")[..., : tables.mmax]
    return torch.einsum("...jm,mjl->...lm", X, _tables_on(tables, "fwd", f.device, True))


def isht(a: torch.Tensor, tables: SHTTables) -> torch.Tensor:
    """Inverse real SHT: a [..., lmax, mmax] complex -> [..., nlat, nlon]."""
    X = torch.einsum("...lm,mlj->...jm", a, _tables_on(tables, "inv", a.device, True))
    nfreq = tables.nlon // 2 + 1
    if tables.mmax < nfreq:
        X = F.pad(X, (0, nfreq - tables.mmax))
    return torch.fft.irfft(X, n=tables.nlon, dim=-1, norm="forward")


def laplacian_eigenvalues(lmax: int, radius: float = 1.0) -> np.ndarray:
    """-l(l+1)/r^2 spectrum of the sphere Laplacian (for spectral solvers)."""
    l = np.arange(lmax)
    return -l * (l + 1) / (radius * radius)
