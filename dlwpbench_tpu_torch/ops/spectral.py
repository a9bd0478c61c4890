"""Spectral ops (counterpart of `dlwpbench_tpu/ops/spectral.py`): the FNO
spectral convolution, dense or Tucker-factorised, and the AFNO blockwise
frequency-domain MLP filter.

- `softshrink` (`:30`), JAX's `where` form;
- the DFT tables `_dft_mats_w` (`:46`), `_dft_mats_h` (`:56`),
  `_idft_mats_w` (`:66`) and `_band_dft_mats` (`:113`): numpy, built in
  float64 and divided by the square root as JAX builds them, then cast
  to float32, so both sides hold the same bits.  A forward pass takes them
  from `_device_tables`: one copy per (table, shape, device), never one
  per call;
- `rfft2_matmul` (`:81`) and `irfft2_matmul` (`:97`): the ortho rfft2 and
  its inverse over [B, H, W, C] as real einsums;
- `_tucker_core_dims` (`:142`): tensorly's float-rank rule through
  `np.roots`;
- `SpectralConv2d` (`:164`): per-mode complex channel mixing on the kept
  corner bands [:m1, :m2] and [-m1:, :m2]; `fft_impl="matmul"` (the
  default) computes only those bands through the truncated DFT tables,
  `"fft"` goes through `torch.fft` (cuFFT on the card), and is taken
  whenever 2 m1 > H, where the two bands overlap (JAX's rule at `:255`);
- `AFNO2DFilter` (`:313`): the two-layer complex block MLP on the kept
  band, softshrink, the inverse transform and the residual;
  `fft_impl="matmul"` (`_matmul_filter`, `:393`) or `"fft"`.

JAX computes all of this with `jnp.einsum` and `jnp.fft`, outside any
Pallas kernel, so the port's counterparts are `torch.einsum` (cuBLAS on
the card) and `torch.fft` (cuFFT); there is no hand-written kernel here.

dtypes: the field is cast to fp32 before the transform, the weights are
taken in fp32 (JAX promotes an fp32 field times bf16 weights to fp32;
torch's products refuse mixed dtypes, so the port casts them, exactly),
and the result is cast back to the field's dtype.

With `spmd_mesh` the AFNO filter runs over the distributed rFFT2
(`parallel/spectral_dist.py::dist_afno_filter`) on latitude rows sharded
over the mesh dim `dist_axis`.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dlwpbench_tpu_torch.parallel import launch
from dlwpbench_tpu_torch.utils.device import device_constant

FFT_IMPLS = ("matmul", "fft")


def softshrink(x: torch.Tensor, lambd: float) -> torch.Tensor:
    """torch.nn.functional.softshrink in JAX's `where` form (zero gradient
    inside the dead band, at its edges too)."""
    return torch.where(x > lambd, x - lambd, torch.where(x < -lambd, x + lambd, 0.0))


def check_fft_impl(fft_impl: str) -> None:
    if fft_impl not in FFT_IMPLS:
        raise ValueError(f"fft_impl {fft_impl!r}: expected one of {FFT_IMPLS}")


# ---------------------------------------------------------------------------
# DFT tables (numpy, float64 -> float32, as JAX builds them)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dft_mats_w(W: int):
    """Ortho rfft matrices over the last spatial axis: x[w] -> X[k]."""
    w = np.arange(W)[:, None]
    k = np.arange(W // 2 + 1)[None, :]
    ang = 2 * np.pi * w * k / W
    cw = (np.cos(ang) / np.sqrt(W)).astype(np.float32)  # [W, Wf]
    sw = (-np.sin(ang) / np.sqrt(W)).astype(np.float32)
    return cw, sw


@functools.lru_cache(maxsize=None)
def _dft_mats_h(H: int):
    """Ortho full-DFT matrices over the H axis: [K, H]."""
    k = np.arange(H)[:, None]
    h = np.arange(H)[None, :]
    ang = 2 * np.pi * k * h / H
    ch = (np.cos(ang) / np.sqrt(H)).astype(np.float32)
    sh = (np.sin(ang) / np.sqrt(H)).astype(np.float32)
    return ch, sh


@functools.lru_cache(maxsize=None)
def _idft_mats_w(W: int):
    """Ortho irfft matrices [Wf, W] with hermitian mode doubling."""
    Wf = W // 2 + 1
    alpha = np.full(Wf, 2.0)
    alpha[0] = 1.0
    if W % 2 == 0:
        alpha[-1] = 1.0
    k = np.arange(Wf)[:, None]
    w = np.arange(W)[None, :]
    ang = 2 * np.pi * k * w / W
    icw = (alpha[:, None] * np.cos(ang) / np.sqrt(W)).astype(np.float32)
    isw = (-alpha[:, None] * np.sin(ang) / np.sqrt(W)).astype(np.float32)
    return icw, isw


@functools.lru_cache(maxsize=None)
def _band_dft_mats(H: int, W: int, m1: int, m2: int):
    """Truncated ortho rfft2 matrices for FNO's kept corner bands:
    (cw, sw, ch, sh, icw, isw), the W-axis forward [W, m2], the H-axis
    forward rows [2*m1, H] and the W-axis inverse [m2, W] with hermitian
    doubling."""
    w = np.arange(W)[:, None]
    k = np.arange(m2)[None, :]
    angw = 2 * np.pi * w * k / W
    cw = (np.cos(angw) / np.sqrt(W)).astype(np.float32)
    sw = (-np.sin(angw) / np.sqrt(W)).astype(np.float32)
    g = np.concatenate([np.arange(m1), np.arange(H - m1, H)])[:, None]
    h = np.arange(H)[None, :]
    angh = 2 * np.pi * g * h / H
    ch = (np.cos(angh) / np.sqrt(H)).astype(np.float32)
    sh = (np.sin(angh) / np.sqrt(H)).astype(np.float32)
    alpha = np.full(m2, 2.0)
    alpha[0] = 1.0
    if W % 2 == 0 and m2 == W // 2 + 1:
        alpha[-1] = 1.0
    icw = (alpha[:, None] * np.cos(angw.T) / np.sqrt(W)).astype(np.float32)
    isw = (-alpha[:, None] * np.sin(angw.T) / np.sqrt(W)).astype(np.float32)
    return cw, sw, ch, sh, icw, isw


def _table(fn, args, i):
    return fn(*args)[i]


def _device_tables(fn, *args, device) -> tuple[torch.Tensor, ...]:
    """The numpy tables `fn(*args)` as tensors on `device`, each copied
    once per (tables, arguments, device) by `device_constant`."""
    return tuple(device_constant(_table, fn, args, i, device=device)
                 for i in range(len(fn(*args))))


def rfft2_matmul(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Ortho rfft2 over axes (1, 2) of [B, H, W, C] as real matmuls:
    (real, imag), each [B, H, W//2+1, C]."""
    B, H, W, C = x.shape
    cw, sw = _device_tables(_dft_mats_w, W, device=x.device)
    ch, sh = _device_tables(_dft_mats_h, H, device=x.device)
    xr = torch.einsum("bhwc,wk->bhkc", x, cw)
    xi = torch.einsum("bhwc,wk->bhkc", x, sw)
    yr = torch.einsum("gh,bhkc->bgkc", ch, xr) + torch.einsum("gh,bhkc->bgkc", sh, xi)
    yi = torch.einsum("gh,bhkc->bgkc", ch, xi) - torch.einsum("gh,bhkc->bgkc", sh, xr)
    return yr, yi


def irfft2_matmul(yr: torch.Tensor, yi: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Inverse of `rfft2_matmul`: [B, H, W//2+1, C] real/imag -> [B, H, W, C]."""
    ch, sh = _device_tables(_dft_mats_h, H, device=yr.device)
    icw, isw = _device_tables(_idft_mats_w, W, device=yr.device)
    # ifft over H (the adjoint of the ortho forward)
    zr = torch.einsum("gh,bgkc->bhkc", ch, yr) - torch.einsum("gh,bgkc->bhkc", sh, yi)
    zi = torch.einsum("gh,bgkc->bhkc", ch, yi) + torch.einsum("gh,bgkc->bhkc", sh, yr)
    # irfft over W with hermitian doubling (the real part implicitly)
    return torch.einsum("bhkc,kw->bhwc", zr, icw) + torch.einsum("bhkc,kw->bhwc", zi, isw)


def _tucker_core_dims(dims: tuple[int, ...], rank: float) -> tuple[int, ...]:
    """Core sizes for a float Tucker rank (tensorly's `validate_tucker_rank`,
    the rule of neuraloperator's TFNO): one fraction f with

        prod(dims) * f^n  +  sum(d_i^2) * f  =  rank * prod(dims),

    then core_dim_i = round(f * d_i)."""
    n = len(dims)
    prod = float(np.prod(dims))
    coeffs = np.zeros(n + 1)
    coeffs[0] = prod                      # f^n
    coeffs[-2] = float(sum(d * d for d in dims))  # f^1
    coeffs[-1] = -rank * prod             # f^0
    roots = np.roots(coeffs)
    real = roots[np.isreal(roots)].real
    f = float(min(r for r in real if r > 0))
    return tuple(max(1, int(round(f * d))) for d in dims)


def _mix_dense(br, bi, w):
    """Per-mode complex channel mixing of a band's real and imaginary
    planes [B, m1, m2, Cin] with w [Cin, Cout, m1, m2, 2]."""
    wr, wi = w[..., 0], w[..., 1]
    return (torch.einsum("bxyi,ioxy->bxyo", br, wr) - torch.einsum("bxyi,ioxy->bxyo", bi, wi),
            torch.einsum("bxyi,ioxy->bxyo", br, wi) + torch.einsum("bxyi,ioxy->bxyo", bi, wr))


def _mix_tucker(br, bi, core, factors):
    """The same mixing through the Tucker factors; the dense [Cin, Cout,
    m1, m2] weight is never built.  JAX leaves the order to opt_einsum,
    which a PyTorch installation need not have, and without it torch's
    einsum contracts left to right (the band with the core first: an outer
    product of both).  The order here is written out: the band (both planes stacked
    on s) x fi, then x fx and x fy (the modes x, y stay on the band), then
    the core over (w, u, v) with its real and imaginary planes on t, then
    x fo; the four real products land on (s, t)."""
    fi, fo, fx, fy = factors
    t = torch.einsum("sbxyi,iw->sbxyw", torch.stack([br, bi]), fi)
    t = torch.einsum("sbxyw,xu->sbxywu", t, fx)
    t = torch.einsum("sbxywu,yv->sbxywuv", t, fy)
    t = torch.einsum("sbxywuv,twquv->stbxyq", t, core.movedim(-1, 0))
    t = torch.einsum("stbxyq,oq->stbxyo", t, fo)
    return t[0, 0] - t[1, 1], t[0, 1] + t[1, 0]


class SpectralConv2d(nn.Module):
    """FNO 2D Fourier layer on channels-last [B, H, W, Cin] fields.

    Keeps modes [:m1, :m2] and [-m1:, :m2] of the (full H x half W) rfft2
    spectrum and mixes channels with complex weights per mode, m1 =
    min(modes1, H) and m2 = min(modes2, W//2+1).  The weight shapes follow
    the grid; JAX reads it from the first input, the port from
    `grid_shape` (H, W), and a field whose grid keeps other modes raises.

    `tucker_rank` (a fraction): the complex weight [Cin, Cout, m1, m2] is
    Tucker-factorised, a core `weights{1,2}_core` [r0, r1, r2, r3, 2] and
    the factors `weights{1,2}_factor{0..3}` [d_i, r_i]; the mixing runs
    through the factors (`_mix_tucker`).  Parameter names and layouts are
    flax's, so `weights.load_flax_params` loads them as they are.
    """

    def __init__(self, in_channels: int, out_channels: int, modes1: int = 12,
                 modes2: int = 12, tucker_rank: Optional[float] = None,
                 fft_impl: str = "matmul", *, grid_shape: Sequence[int]):
        super().__init__()
        check_fft_impl(fft_impl)
        self.modes, self.fft_impl = (int(modes1), int(modes2)), fft_impl
        self.in_channels, self.out_channels = int(in_channels), int(out_channels)
        self.m1, self.m2 = self._kept(*grid_shape)
        dims = (self.in_channels, self.out_channels, self.m1, self.m2)
        self.tucker = tucker_rank is not None
        for name in ("weights1", "weights2"):
            if not self.tucker:
                setattr(self, name, nn.Parameter(torch.empty(*dims, 2)))
                continue
            core_dims = _tucker_core_dims(dims, float(tucker_rank))
            setattr(self, f"{name}_core", nn.Parameter(torch.empty(*core_dims, 2)))
            for i, (d, r) in enumerate(zip(dims, core_dims)):
                setattr(self, f"{name}_factor{i}", nn.Parameter(torch.empty(d, r)))
        self.init_(torch.Generator().manual_seed(0))

    def _kept(self, H: int, W: int) -> tuple[int, int]:
        return min(self.modes[0], int(H)), min(self.modes[1], int(W) // 2 + 1)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """JAX's draws: U(0, 1/(Cin Cout)) for the dense weights; for the
        Tucker ones the core N(0, 1) / (Cin Cout) and each factor
        N(0, 1) / sqrt(r)."""
        scale = 1.0 / (self.in_channels * self.out_channels)
        for name in ("weights1", "weights2"):
            if not self.tucker:
                getattr(self, name).uniform_(0.0, 1.0, generator=generator).mul_(scale)
                continue
            getattr(self, f"{name}_core").normal_(generator=generator).mul_(scale)
            for i in range(4):
                f = getattr(self, f"{name}_factor{i}")
                f.normal_(generator=generator).div_(float(np.sqrt(f.shape[1])))

    def _weight(self, name: str):
        """The weight in fp32 (JAX's promotion of an fp32 field times bf16
        weights): the dense tensor, or (core, [fi, fo, fx, fy])."""
        if not self.tucker:
            return getattr(self, name).float()
        return (getattr(self, f"{name}_core").float(),
                [getattr(self, f"{name}_factor{i}").float() for i in range(4)])

    def _mix(self, br, bi, w):
        return _mix_tucker(br, bi, *w) if self.tucker else _mix_dense(br, bi, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        m1, m2 = self.m1, self.m2
        if self._kept(H, W) != (m1, m2):
            raise ValueError(
                f"SpectralConv2d built for modes ({m1}, {m2}); the {H}x{W} grid keeps "
                f"{self._kept(H, W)}: build it with grid_shape=({H}, {W})")
        w1, w2 = self._weight("weights1"), self._weight("weights2")
        xf = x.float()
        if self.fft_impl == "matmul" and 2 * m1 <= H:
            cw, sw, ch, sh, icw, isw = _device_tables(_band_dft_mats, H, W, m1, m2,
                                                      device=x.device)
            xr = torch.einsum("bhwc,wk->bhkc", xf, cw)  # [B, H, m2, C]
            xi = torch.einsum("bhwc,wk->bhkc", xf, sw)
            yr = torch.einsum("gh,bhkc->bgkc", ch, xr) + torch.einsum("gh,bhkc->bgkc", sh, xi)
            yi = torch.einsum("gh,bhkc->bgkc", ch, xi) - torch.einsum("gh,bhkc->bgkc", sh, xr)
            tr, ti = self._mix(yr[:, :m1], yi[:, :m1], w1)
            br, bi = self._mix(yr[:, m1:], yi[:, m1:], w2)
            or_ = torch.cat([tr, br], dim=1)  # [B, 2*m1, m2, Cout]
            oi_ = torch.cat([ti, bi], dim=1)
            zr = torch.einsum("gh,bgkc->bhkc", ch, or_) - torch.einsum("gh,bgkc->bhkc", sh, oi_)
            zi = torch.einsum("gh,bgkc->bhkc", ch, oi_) + torch.einsum("gh,bgkc->bhkc", sh, or_)
            out = (torch.einsum("bhkc,kw->bhwc", zr, icw)
                   + torch.einsum("bhkc,kw->bhwc", zi, isw))
            return out.to(x.dtype)

        x_ft = torch.fft.rfft2(xf, dim=(1, 2))  # [B, H, Wf, C]
        top = torch.complex(*self._mix(x_ft[:, :m1, :m2].real, x_ft[:, :m1, :m2].imag, w1))
        bot = torch.complex(*self._mix(x_ft[:, H - m1:, :m2].real,
                                       x_ft[:, H - m1:, :m2].imag, w2))
        # JAX writes the top band, then the bottom one over it: where the
        # two overlap (2 m1 > H) the bottom band's rows win
        rows = [top[:, : min(m1, H - m1)]]
        if H > 2 * m1:
            rows.append(top.new_zeros(B, H - 2 * m1, m2, self.out_channels))
        rows.append(bot)
        out_ft = F.pad(torch.cat(rows, dim=1), (0, 0, 0, W // 2 + 1 - m2))
        return torch.fft.irfft2(out_ft, s=(H, W), dim=(1, 2)).to(x.dtype)


def _pack_w(w: torch.Tensor) -> torch.Tensor:
    """[2, nb, i, o] -> [nb, 2i, 2o]: [[W0, W1], [-W1, W0]], so that
    [Ar, Ai] @ it = [Or, Oi]."""
    w0, wim = w[0], w[1]
    return torch.cat([torch.cat([w0, wim], dim=-1), torch.cat([-wim, w0], dim=-1)], dim=-2)


def _blockmm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...bi,bio->...bo", a, w)


class AFNO2DFilter(nn.Module):
    """AFNO frequency-domain block MLP on [B, H, W, C] token grids; returns
    the filtered field plus the residual.

    The kept band is rows [total - kept, min(total + kept, H)) and columns
    [:kept] of the rfft2 spectrum, total = H//2 + 1 and kept = int(total x
    `hard_thresholding_fraction`): the one count bounds both the rows and
    the longitude columns (on 32 x 64 the columns keep 17 of the 33 modes),
    a quirk of the reference kept as it is.  Parameters `w1` [2, nb, bs,
    bf], `b1` [2, nb, bf], `w2` [2, nb, bf, bs], `b2` [2, nb, bs] (real and
    imaginary parts on the first axis), flax's names and layouts.

    With `spmd_mesh` the filter runs over the distributed rFFT2 on the
    mesh dim `dist_axis` (`fft_impl` then unused, as in JAX): `forward`
    takes and gives the replicated field, `local` this rank's latitude
    rows (a model whose step is sharded calls it).
    """

    def __init__(self, hidden_size: int, num_blocks: int = 8,
                 sparsity_threshold: float = 0.01, hard_thresholding_fraction: float = 1.0,
                 hidden_size_factor: int = 1, spmd_mesh=None, dist_axis: str = "x",
                 fft_impl: str = "matmul"):
        super().__init__()
        check_fft_impl(fft_impl)
        self.group = None if spmd_mesh is None else launch.axis(spmd_mesh, dist_axis)[0]
        if hidden_size % num_blocks:
            raise ValueError(f"hidden_size {hidden_size} does not split into {num_blocks} blocks")
        nb = self.num_blocks = int(num_blocks)
        bs = self.block_size = int(hidden_size) // nb
        bf = bs * int(hidden_size_factor)
        self.sparsity_threshold = float(sparsity_threshold)
        self.fraction, self.fft_impl = float(hard_thresholding_fraction), fft_impl
        self.w1 = nn.Parameter(torch.empty(2, nb, bs, bf))
        self.b1 = nn.Parameter(torch.empty(2, nb, bf))
        self.w2 = nn.Parameter(torch.empty(2, nb, bf, bs))
        self.b2 = nn.Parameter(torch.empty(2, nb, bs))
        self.init_(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """JAX's draws: 0.02 N(0, 1) for every parameter."""
        for p in (self.w1, self.b1, self.w2, self.b2):
            p.normal_(generator=generator).mul_(0.02)

    def _band(self, H: int) -> tuple[int, int, int]:
        total = H // 2 + 1
        kept = int(total * self.fraction)
        return total - kept, min(total + kept, H), kept

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """[..., H/P, W, C] rows of this rank -> its rows of the filtered
        field plus the residual."""
        from dlwpbench_tpu_torch.parallel.spectral_dist import dist_afno_filter  # imports this module

        y = dist_afno_filter(x, self.w1, self.b1, self.w2, self.b2, self.group, self.fraction,
                             self.sparsity_threshold)
        return y.to(x.dtype) + x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is not None:
            y = self.local(launch.scatter_to_ranks(x, x.ndim - 3, self.group))
            return launch.gather_from_ranks(y, y.ndim - 3, self.group)
        B, H, W, C = x.shape
        nb, bs, Wf = self.num_blocks, self.block_size, W // 2 + 1
        r0, r1, kept = self._band(H)
        w1, b1, w2, b2 = (p.float() for p in (self.w1, self.b1, self.w2, self.b2))

        def to_grid(band):  # [B, r1 - r0, kept, nb, bs] -> [B, H, Wf, C], zero outside
            band = band.reshape(B, r1 - r0, kept, C)
            return F.pad(band, (0, 0, 0, Wf - kept, r0, H - r1))

        if self.fft_impl == "matmul":
            yr, yi = rfft2_matmul(x.float())  # [B, H, Wf, C]
            sl_r = yr[:, r0:r1, :kept].reshape(B, r1 - r0, kept, nb, bs)
            sl_i = yi[:, r0:r1, :kept].reshape(B, r1 - r0, kept, nb, bs)
            a = torch.cat([sl_r, sl_i], dim=-1)  # [B, r, k, nb, 2bs]
            o1 = torch.relu(_blockmm(a, _pack_w(w1)) + torch.cat([b1[0], b1[1]], dim=-1))
            o2 = _blockmm(o1, _pack_w(w2)) + torch.cat([b2[0], b2[1]], dim=-1)
            out_r = to_grid(softshrink(o2[..., :bs], self.sparsity_threshold))
            out_i = to_grid(softshrink(o2[..., bs:], self.sparsity_threshold))
            return irfft2_matmul(out_r, out_i, H, W).to(x.dtype) + x

        xf = torch.fft.rfft2(x.float(), dim=(1, 2), norm="ortho").reshape(B, H, Wf, nb, bs)
        sl = xf[:, r0:r1, :kept]
        o1r = torch.relu(_blockmm(sl.real, w1[0]) - _blockmm(sl.imag, w1[1]) + b1[0])
        o1i = torch.relu(_blockmm(sl.imag, w1[0]) + _blockmm(sl.real, w1[1]) + b1[1])
        o2r = _blockmm(o1r, w2[0]) - _blockmm(o1i, w2[1]) + b2[0]
        o2i = _blockmm(o1i, w2[0]) + _blockmm(o1r, w2[1]) + b2[1]
        spec = torch.complex(to_grid(softshrink(o2r, self.sparsity_threshold)),
                             to_grid(softshrink(o2i, self.sparsity_threshold)))
        out = torch.fft.irfft2(spec, s=(H, W), dim=(1, 2), norm="ortho")
        return out.to(x.dtype) + x
