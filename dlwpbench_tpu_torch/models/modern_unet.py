"""ModernUNet, its HEALPix variant and the PDE-Refiner diffusion model
(counterpart of `dlwpbench_tpu/models/modern_unet.py`).

- `ResidualBlock` (`:115`): pre-norm wide residual block, GroupNorm ->
  activation -> 3x3 geo-padded conv, then AdaGN (the time embedding's
  scale and shift, or its sum) -> activation -> zero-initialised 3x3 conv,
  and a 1x1 `GeoConv` shortcut only when the channel count changes;
- `ModernUNetCore` (`:206`): the encoder, the middle block (+ optional
  `AttentionBlock`), the decoder and the GroupNorm / activation /
  zero-initialised 1x1 head, wired by `variant` ("upstream", "reference"
  or "diffusion", see the class);
- `ModernUNet` (`:357`) and `MUNetHPX`: the core as a `RolloutModel` step
  (per-step remat "full" like every rollout model);
- `DiffModernUNet` (`:396`) and `DiffMUNetHPX`: the denoiser
  `single_forward` (context + noised residual on channels, a sinusoidal
  time embedding through a 2-layer MLP into every block's AdaGN) and the
  rollout that runs the DDPM refinement loop from noise at every lead
  step, with the "reference" (ancestral) or "mean" (posterior mean)
  sampler;
- `ConvNeXtLSTMBlock` (`:569`): the ConvNeXt LSTM cell, a standalone block.

Submodules carry the flax auto-names of the JAX modules
(`ModernUNetCore_0.ResidualBlock_3.GroupNormCL_1.GroupNorm_0`, `core`,
`time_mlp1`, ...), so `weights.load_flax_params` maps a flax tree onto
them name for name.

dtype promotion: a flax Dense, Conv or GroupNorm computes in the promoted
dtype of its input and its parameters.  In the diffusion model with bf16
parameters the fp32 time embedding makes the AdaGN output fp32, and from
the first block on the trunk runs in fp32.  torch's layers refuse mixed
dtypes, so every parametrised layer here goes through `_promoted`, which
applies JAX's rule.

`use_fourier` puts a `FourierResidualBlock` (`:162`, two
`ops.spectral.SpectralConv2d` layers with 16 x 16 modes, each beside a
Dense skip) at level 0 on the lat-lon mesh; the HEALPix models ignore it,
as JAX's do.  Its mode counts follow the grid (`grid_shape`).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from dlwpbench_tpu_torch.models.base import RolloutModel, _flatten_window, _to_channels_last
from dlwpbench_tpu_torch.ops import ddpm
from dlwpbench_tpu_torch.ops.conv import (
    GeoConv,
    PlainConv,
    PlainConvTranspose,
    _circular,
    _nchw,
    fold_faces,
    get_activation,
    unfold_faces,
)
from dlwpbench_tpu_torch.ops.padding import healpix_pad_channels_last
from dlwpbench_tpu_torch.ops.spectral import SpectralConv2d
from dlwpbench_tpu_torch.utils.device import device_constant
from dlwpbench_tpu_torch.weights import DenseGeneral

VARIANTS = ("upstream", "reference", "diffusion")
SAMPLERS = ("reference", "mean")


def _promoted(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """`layer(x)` in the promoted dtype of `x` and the layer's parameters,
    as flax computes (an fp32 input through bf16 weights runs in fp32 with
    the weights upcast; the gradient reaches the bf16 copies through the
    cast)."""
    w = next(layer.parameters())
    dtype = torch.promote_types(x.dtype, w.dtype)
    x = x.to(dtype)
    if w.dtype == dtype:
        return layer(x)
    return torch.func.functional_call(
        layer, {n: p.to(dtype) for n, p in layer.named_parameters()}, (x,))


def _fourier_freqs(half: int, max_period: float) -> np.ndarray:
    """exp(-log(max_period) * j / half), j < half, in fp32 in the JAX
    expression's order (computed on the host, so every device gets the
    same table)."""
    lp = torch.log(torch.tensor(max_period, dtype=torch.float32))
    return torch.exp(-lp * torch.arange(half, dtype=torch.float32) / half).numpy()


def fourier_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding [B] -> [B, dim] (reference
    `modern_unet.py:10-30`): cos then sin of t x freqs in fp32, a zero
    column for odd dims.  t reaches 2e5, where one ulp of a frequency
    moves cos and sin by 1e-3: the product is the JAX one's."""
    half = dim // 2
    freqs = device_constant(_fourier_freqs, half, float(max_period), device=t.device)
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class ZeroConv(GeoConv):
    """A `GeoConv` whose kernel and bias start at zero: cylinder padding on
    the lat-lon grid, neighbour padding of the faces on HEALPix."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 mesh: str = "equirectangular"):
        super().__init__(in_features, features, kernel_size,
                         mesh="healpix" if mesh == "healpix" else "equirectangular")
        with torch.no_grad():
            self.Conv_0.weight.zero_()
            self.Conv_0.bias.zero_()


class GroupNormCL(nn.Module):
    """GroupNorm over channels-last [B, ..., C]: every position (faces
    included) of a group's channels, eps 1e-5; the group count clamped
    down to a divisor of C."""

    def __init__(self, channels: int, num_groups: int = 1):
        super().__init__()
        groups = int(num_groups)
        while channels % groups:  # tiny test configs
            groups -= 1
        self.GroupNorm_0 = nn.GroupNorm(groups, channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        y = _promoted(self.GroupNorm_0, x.reshape(B, -1, C).transpose(1, 2))
        return y.transpose(1, 2).reshape(x.shape)


class ResidualBlock(nn.Module):
    """Wide residual block; AdaGN time conditioning when built with
    `emb_features` (the reference applies its Dense to the raw embedding,
    with no activation, `modern_unet.py:655,662`)."""

    def __init__(self, in_channels: int, out_channels: int, activation: str = "gelu",
                 norm: bool = False, n_groups: int = 1, mesh: str = "equirectangular",
                 use_scale_shift_norm: bool = False, emb_features: Optional[int] = None):
        super().__init__()
        self.act = get_activation(activation)
        self.norm, self.scale_shift = norm, use_scale_shift_norm
        if norm:
            self.GroupNormCL_0 = GroupNormCL(in_channels, n_groups)
            self.GroupNormCL_1 = GroupNormCL(out_channels, n_groups)
        self.GeoConv_0 = GeoConv(in_channels, out_channels, 3, mesh=mesh)
        if emb_features is not None:
            self.Dense_0 = nn.Linear(emb_features,
                                     2 * out_channels if use_scale_shift_norm else out_channels)
        self.ZeroConv_0 = ZeroConv(out_channels, out_channels, 3, mesh=mesh)
        if in_channels != out_channels:
            self.GeoConv_1 = GeoConv(in_channels, out_channels, 1, mesh=mesh)

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.GroupNormCL_0(x) if self.norm else x
        h = _promoted(self.GeoConv_0, self.act(h))
        if self.norm:
            h = self.GroupNormCL_1(h)
        if emb is not None:
            eo = _promoted(self.Dense_0, emb)
            eo = eo.reshape(eo.shape[0], *([1] * (h.ndim - 2)), eo.shape[-1])
            if self.scale_shift:
                scale, shift = eo.chunk(2, dim=-1)
                h = h * (1 + scale) + shift
            else:
                h = h + eo
        h = _promoted(self.ZeroConv_0, self.act(h))
        if hasattr(self, "GeoConv_1"):
            x = _promoted(self.GeoConv_1, x)
        return h + x


class FourierResidualBlock(nn.Module):
    """Spectral residual block: (GroupNorm ->) activation ->
    SpectralConv2d + Dense, twice, and a Dense shortcut only when the
    channel count changes.  It takes no time embedding (JAX's ignores
    `emb`)."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int = 16,
                 modes2: int = 16, activation: str = "gelu", norm: bool = False,
                 n_groups: int = 1, *, grid_shape: Sequence[int]):
        super().__init__()
        self.act, self.norm = get_activation(activation), norm
        if norm:
            self.GroupNormCL_0 = GroupNormCL(in_channels, n_groups)
            self.GroupNormCL_1 = GroupNormCL(out_channels, n_groups)
        self.SpectralConv2d_0 = SpectralConv2d(in_channels, out_channels, modes1, modes2,
                                               grid_shape=grid_shape)
        self.Dense_0 = nn.Linear(in_channels, out_channels)
        self.SpectralConv2d_1 = SpectralConv2d(out_channels, out_channels, modes1, modes2,
                                               grid_shape=grid_shape)
        self.Dense_1 = nn.Linear(out_channels, out_channels)
        if in_channels != out_channels:
            self.Dense_2 = nn.Linear(in_channels, out_channels)

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.act(self.GroupNormCL_0(x) if self.norm else x)
        y = self.SpectralConv2d_0(h) + _promoted(self.Dense_0, h)
        y = self.act(self.GroupNormCL_1(y) if self.norm else y)
        out = self.SpectralConv2d_1(y) + _promoted(self.Dense_1, y)
        if hasattr(self, "Dense_2"):
            x = _promoted(self.Dense_2, x)
        return out + x


class MultiHeadDotProductAttention(nn.Module):
    """flax's `MultiHeadDotProductAttention` (self-attention, no dropout,
    no mask): query, key and value projections to [heads, hd], the query
    scaled by 1/sqrt(hd), softmax over the keys, the out projection."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels do not split into {num_heads} heads")
        self.heads, self.hd = num_heads, channels // num_heads
        for name in ("query", "key", "value"):
            setattr(self, name, DenseGeneral((channels, num_heads, self.hd),
                                             (num_heads, self.hd)))
        self.out = DenseGeneral((num_heads, self.hd, channels), (channels,), in_axes=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        q, k, v = (_promoted(getattr(self, n), x).reshape(B, N, self.heads, self.hd)
                   for n in ("query", "key", "value"))
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(self.hd), k), dim=-1)
        return _promoted(self.out, torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, N, C))


class AttentionBlock(nn.Module):
    """Self-attention over every token of the field, residual: x +
    MHA(LayerNorm(x)) (plain torch ops, as the JAX block runs outside any
    Pallas kernel)."""

    def __init__(self, channels: int, num_heads: int = 4):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(channels, eps=1e-6)  # flax's epsilon
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(channels, num_heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        h = _promoted(self.LayerNorm_0, x.reshape(B, -1, C))
        h = self.MultiHeadDotProductAttention_0(h)
        return x + h.reshape(x.shape)


class ModernUNetCore(nn.Module):
    """The shared trunk; time-conditioned when built with `emb_features`.

    `variant` selects the block wiring (`modern_unet.py:206-226`):
    - "upstream": a 1x1 stem conv, geo-padded strided 3x3 downsampling,
      the skip concatenated at every decoder level, one residual block per
      level, "SAME" k4 s2 transposes, final GroupNorm(8);
    - "reference": the reference `MUNetHPX` as it executes: plain
      zero-padded strided downsampling, no decoder skips, two residual
      blocks per decoder level (the second to 2 x the next width), every
      encoder and decoder block norm-free, final GroupNorm(8);
    - "diffusion": the diffusion file's: no stem, plain zero-padded
      downsampling, skips at every decoder level but the bottom, one
      residual block per level, final GroupNorm(4); its middle blocks
      normalise in 4 groups.
    """

    def __init__(self, in_channels: int, hidden_channels: Sequence[int], out_channels: int,
                 activation: str = "gelu", norm: bool = False, attention: bool = False,
                 mesh: str = "equirectangular", use_scale_shift_norm: bool = False,
                 use_fourier: bool = False, variant: str = "upstream",
                 emb_features: Optional[int] = None,
                 grid_shape: Optional[Sequence[int]] = None):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r}: expected one of {VARIANTS}")
        if use_fourier and mesh == "equirectangular" and grid_shape is None:
            raise ValueError("use_fourier on the lat-lon mesh sizes its spectral weights for "
                             "the data's grid: give grid_shape=(H, W)")
        self.act = get_activation(activation)
        self.mesh, self.variant = mesh, variant
        hc = self.hidden_channels = tuple(int(c) for c in hidden_channels)
        blk_norm = norm if variant == "upstream" else False
        counts: dict[str, int] = {}

        def add(kind: str, module: nn.Module) -> str:
            name = f"{kind}_{counts.get(kind, 0)}"
            counts[kind] = counts.get(kind, 0) + 1
            setattr(self, name, module)
            return name

        def block(c_in: int, c_out: int, block_norm: bool, groups: int = 1) -> str:
            return add("ResidualBlock", ResidualBlock(
                c_in, c_out, activation, block_norm, groups, mesh=mesh,
                use_scale_shift_norm=use_scale_shift_norm, emb_features=emb_features))

        # self.enc: per level (downsampling module or None, residual block)
        self.enc, skip_ch, ch = [], [], int(in_channels)
        for lvl, c in enumerate(hc):
            if lvl == 0:
                down = None if variant == "diffusion" else add("GeoConv", GeoConv(ch, ch, 1, mesh))
            elif variant == "upstream":
                down = add("GeoConv", GeoConv(ch, ch, 3, mesh, strides=2))
            else:  # the reference's plain zero-padded conv, outside its HEALPix wrapper
                down = add("Conv", PlainConv(ch, ch, 3, stride=2, mesh=mesh))
            if use_fourier and mesh == "equirectangular" and lvl == 0:
                blk = add("FourierResidualBlock", FourierResidualBlock(
                    ch, c, activation=activation, norm=blk_norm, grid_shape=grid_shape))
            else:
                blk = block(ch, c, blk_norm)
            self.enc.append((down, blk))
            ch = c
            skip_ch.append(c)

        mid_groups = 4 if variant == "diffusion" else 1
        self.mid = [block(ch, hc[-1], norm, mid_groups)]
        if attention:
            self.mid.append(add("AttentionBlock", AttentionBlock(hc[-1])))
        self.mid.append(block(hc[-1], hc[-1], norm, mid_groups))
        ch = hc[-1]

        # self.dec: per level (concatenate the skip?, residual blocks, upsampling or None)
        self.dec, rev = [], hc[::-1]
        for i, c in enumerate(rev):
            skip = variant == "upstream" or (variant == "diffusion" and i > 0)
            if skip:
                ch += skip_ch[len(hc) - 1 - i]
            blocks = [block(ch, c, blk_norm)]
            ch = c
            if variant == "reference":  # a second block, to 2 x the next width
                c_out2 = 2 * (rev[i + 1] if i + 1 < len(rev) else rev[i])
                blocks.append(block(ch, c_out2, blk_norm))
                ch = c_out2
            up = None
            if i < len(rev) - 1:
                feat = ch if variant == "reference" else rev[i + 1]
                up = add("ConvTranspose", PlainConvTranspose(ch, feat, 4, 2, 1, mesh=mesh))
                ch = feat
            self.dec.append((skip, blocks, up))

        self.GroupNormCL_0 = GroupNormCL(ch, 4 if variant == "diffusion" else 8)
        self.ZeroConv_0 = ZeroConv(ch, int(out_channels), 1, mesh=mesh)

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        healpix = self.mesh == "healpix"
        in_hw = x.shape[1:3]
        skips = []
        for down, blk in self.enc:
            if down is not None:
                x = _promoted(getattr(self, down), x)
            x = getattr(self, blk)(x, emb)
            skips.append(x)
        for name in self.mid:
            mod = getattr(self, name)
            x = mod(x) if isinstance(mod, AttentionBlock) else mod(x, emb)
        for i, (skip, blocks, up) in enumerate(self.dec):
            if skip:
                s = skips[len(skips) - 1 - i]
                if not healpix:  # odd grids: the upsampled field is one longer
                    x = x[:, : s.shape[1], : s.shape[2]]
                x = torch.cat([s, x], dim=-1)
            for name in blocks:
                x = getattr(self, name)(x, emb)
            if up is not None:
                x = _promoted(getattr(self, up), x)
        if not healpix:  # odd-grid final crop
            x = x[:, : in_hw[0], : in_hw[1]]
        x = self.act(self.GroupNormCL_0(x))
        return _promoted(self.ZeroConv_0, x)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's lecun-normal: variance 1 / fan_in, normal truncated at +-2
    std (std corrected for the truncation), drawn by redrawing the values
    beyond +-2 (`nn.init.trunc_normal_` takes 5 s for the shipped
    ModernUNet's 90 M parameters on 8 host cores, this 0.6 s).  A tensor
    on the meta device (shapes only) has no values to draw."""
    if w.is_meta:
        return
    flat = w.view(-1)
    flat.normal_(generator=generator)
    while (bad := (flat.abs() > 2.0).nonzero().squeeze(1)).numel():
        flat[bad] = torch.randn(bad.numel(), generator=generator, dtype=flat.dtype)
    flat.mul_(math.sqrt(1.0 / fan_in) / 0.87962566103423978)


def _init_like_flax(model: nn.Module, seed: int) -> None:
    """flax's default init: lecun-normal Dense and conv kernels, zero
    biases, unit norm scales; the ZeroConvs stay zero; the spectral layers
    draw their own weights (`init_`)."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.in_features, gen)
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                kh, kw = m.kernel_size
                _lecun_normal_(m.weight, kh * kw * m.in_channels // m.groups, gen)
            else:
                if isinstance(m, SpectralConv2d):
                    m.init_(gen)
                continue
            m.bias.zero_()
        for m in model.modules():
            if isinstance(m, ZeroConv):
                m.Conv_0.weight.zero_()


def _in_channels(constant: int, prescribed: int, prognostic: int, context: int) -> int:
    return int(constant) + int(context) * (int(prescribed) + int(prognostic))


class ModernUNet(RolloutModel):
    """Reference `ModernUNet` (config `type: ModernUNet`).  `seed` seeds the
    random init (flax's defaults); weights from the JAX model come in
    through `weights.load_flax_params`.  `grid_shape` (H, W) sizes the
    Fourier block's spectral weights for the data's grid (`use_fourier`)."""

    def __init__(
        self,
        constant_channels: int = 4,
        prescribed_channels: int = 0,
        prognostic_channels: int = 1,
        hidden_channels: Sequence[int] = (64, 128, 256, 1024),
        activation: str = "gelu",
        context_size: int = 1,
        mesh: str = "equirectangular",
        attention: bool = False,
        norm: bool = False,
        use_fourier: bool = False,
        variant: str = "upstream",
        grid_shape: Optional[Sequence[int]] = None,
        remat: bool = False,
        remat_policy: str = "full",
        seed: int = 0,
    ):
        super().__init__(context_size, remat, remat_policy)
        self.mesh = mesh
        self.ModernUNetCore_0 = ModernUNetCore(
            _in_channels(constant_channels, prescribed_channels, prognostic_channels,
                         context_size),
            hidden_channels, int(prognostic_channels), activation=activation, norm=norm,
            attention=attention, mesh=mesh, use_fourier=use_fourier, variant=variant,
            grid_shape=grid_shape)
        self.hidden_channels = self.ModernUNetCore_0.hidden_channels
        _init_like_flax(self, seed)

    def step(self, x: torch.Tensor, state: Any, aux: Any = None):
        return self.ModernUNetCore_0(x), state


class MUNetHPX(ModernUNet):
    """HEALPix ModernUNet (config `type: MUNetHPX`, reference `MUNetHPX`)."""

    __init__ = functools.partialmethod(ModernUNet.__init__, mesh="healpix")


class DiffModernUNet(nn.Module):
    """PDE-Refiner diffusion model (config `type: DiffModernUNet`).

    Training calls `single_forward` (denoise one refinement step,
    v-prediction); `forward` is the rollout, each lead step a full DDPM
    refinement loop from noise over `num_refinement_step` timesteps
    subsampled from the `train_noise_steps` schedule the denoiser was
    trained on ([800, 600, 400, 200, 0] for 1000 / 5, `modern_unet.py:
    484-560`).  `sampler` "reference" is ancestral sampling (noise at every
    refinement but the last), "mean" the posterior mean."""

    def __init__(
        self,
        constant_channels: int = 4,
        prescribed_channels: int = 0,
        prognostic_channels: int = 1,
        hidden_channels: Sequence[int] = (64, 128, 256, 1024),
        activation: str = "gelu",
        context_size: int = 1,
        mesh: str = "equirectangular",
        attention: bool = False,
        norm: bool = False,
        use_scale_shift_norm: bool = True,
        num_refinement_step: int = 5,
        min_noise_std: float = 4e-4,
        train_noise_steps: int = 1000,
        sampler: str = "reference",
        variant: str = "diffusion",
        seed: int = 0,
    ):
        super().__init__()
        self.context_size, self.mesh, self.sampler = int(context_size), mesh, sampler
        self.num_refinement_step = int(num_refinement_step)
        self.min_noise_std, self.train_noise_steps = float(min_noise_std), int(train_noise_steps)
        self.act = get_activation(activation)
        hc = self.hidden_channels = tuple(int(c) for c in hidden_channels)
        d = hc[0]
        self.time_mlp1 = nn.Linear(d, 4 * d)
        self.time_mlp2 = nn.Linear(4 * d, 4 * d)
        self.core = ModernUNetCore(
            # the context frames' prognostic fields and the noised target, each frame
            _in_channels(constant_channels, prescribed_channels, 2 * int(prognostic_channels),
                         context_size),
            hc, int(prognostic_channels), activation=activation, norm=norm,
            attention=attention, mesh=mesh, use_scale_shift_norm=use_scale_shift_norm,
            variant=variant, emb_features=4 * d)
        _init_like_flax(self, seed)

    def _time_embed(self, k: torch.Tensor) -> torch.Tensor:
        # k in train timesteps, scaled by 1000 / K (`modern_unet.py:142-145`)
        t = k.float() * (1000.0 / self.num_refinement_step)
        emb = fourier_embedding(t, self.hidden_channels[0])
        return _promoted(self.time_mlp2, self.act(_promoted(self.time_mlp1, emb)))

    def single_forward(self, constants, prescribed, prognostic, y_noised, k) -> torch.Tensor:
        """The denoiser, channel-first like the reference: constants
        [B,1,Cc,(F),H,W] or None, prescribed [B,ctx,Cp,...] or None,
        prognostic [B,ctx,Cq,...], y_noised [B,1,Cq,...], k [B] int ->
        [B, Cq, (F), H, W]."""
        ctx = prognostic.shape[1]
        y = y_noised.expand(y_noised.shape[0], ctx, *y_noised.shape[2:])
        parts = [] if constants is None else [_to_channels_last(constants)[:, 0]]
        if prescribed is not None:
            parts.append(_flatten_window(_to_channels_last(prescribed)))
        parts.append(_flatten_window(_to_channels_last(torch.cat([prognostic, y], dim=2))))
        out = self.core(torch.cat(parts, dim=-1), self._time_embed(k))
        return torch.movedim(out, -1, 1)

    def forward(self, constants=None, prescribed=None, prognostic=None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[Sequence[torch.Tensor]]] = None) -> torch.Tensor:
        """The rollout [B, T - ctx, Cq, (F), H, W].  Draws come from
        `generator` (a generator on the fields' device, seeded 0 on every
        call when neither it nor `noise` is given), or from `noise`:
        noise[i][0] is lead step i's initial y [B, 1, Cq, ...] and, for the
        "reference" sampler, noise[i][1 + j] refinement j's draw (unused
        at the last, t = 0)."""
        if self.sampler not in SAMPLERS:
            raise ValueError(
                f"sampler={self.sampler!r}: expected 'reference' (ancestral DDPM, the deployed "
                "reference inference) or 'mean' (deterministic posterior-mean refinement)")
        if prognostic is None:
            raise ValueError("prognostic input is required")
        ctx = self.context_size
        steps = prognostic.shape[1] - ctx
        if steps < 1:
            raise ValueError(f"sequence length {prognostic.shape[1]} must exceed context {ctx}")
        dev = prognostic.device
        sched = ddpm.make_refiner_schedule(self.train_noise_steps, self.min_noise_std, device=dev)
        ts = [int(t) for t in ddpm.subsampled_timesteps(sched.num_timesteps,
                                                         self.num_refinement_step)]
        step_ratio = sched.num_timesteps // self.num_refinement_step
        if generator is None and noise is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        B = prognostic.shape[0]
        window = prognostic[:, :ctx]
        outs = []
        for i in range(steps):
            pres_t = None if prescribed is None else prescribed[:, i : i + ctx]
            shape = (B, 1, *window.shape[2:])
            y = (noise[i][0] if noise is not None
                 else torch.randn(shape, generator=generator, device=dev, dtype=window.dtype))
            for j, k in enumerate(ts):
                pred = self.single_forward(constants, pres_t, window, y,
                                           torch.full((B,), k, device=dev))
                z, gen = None, None
                if self.sampler == "reference":
                    z, gen = (noise[i][1 + j], None) if noise is not None else (None, generator)
                y = ddpm.step(sched, pred[:, None], k, y, generator=gen, noise=z,
                              prev_t=k - step_ratio)
            out = window[:, -1] + y[:, 0]
            window = torch.cat([window[:, 1:], out[:, None]], dim=1)
            outs.append(out)
        return torch.stack(outs, dim=1)


class DiffMUNetHPX(DiffModernUNet):
    """HEALPix diffusion ModernUNet (config `type: DiffMUNetHPX`)."""

    __init__ = functools.partialmethod(DiffModernUNet.__init__, mesh="healpix")


class ConvNeXtLSTMBlock(nn.Module):
    """ConvNeXt-style LSTM cell (reference `unet.py:958-1071`), stateless:
    (x, h, c) -> (h', c').  A depthwise k7 geo-conv of cat(x, h) (cylinder
    padding, or the faces' neighbours on HEALPix) -> GroupNorm -> 1x1 conv
    to 4C gates (a Dense on the 5D HEALPix field) -> GroupNorm(4); LSTM
    gates (f, i, g, o); h' = sigmoid(o) * act(GroupNorm(1x1(c)))."""

    def __init__(self, channels: int, kernel_size: int = 7, mesh: str = "equirectangular",
                 activation: str = "gelu"):
        super().__init__()
        C, k = int(channels), int(kernel_size)
        self.mesh, self.pad = mesh, k // 2
        self.act = get_activation(activation)
        latlon = mesh == "equirectangular"
        self.Conv_0 = nn.Conv2d(2 * C, C, k, groups=C, padding=(self.pad, 0) if latlon else 0)
        self.GroupNormCL_0 = GroupNormCL(C, 1)
        self.GroupNormCL_1 = GroupNormCL(4 * C, 4)
        self.GroupNormCL_2 = GroupNormCL(C, 1)
        if latlon:
            self.Conv_1, self.Conv_2 = nn.Conv2d(C, 4 * C, 1), nn.Conv2d(C, C, 1)
        else:
            self.Dense_0, self.Dense_1 = nn.Linear(C, 4 * C), nn.Linear(C, C)
        _init_like_flax(self, 0)

    def _pointwise(self, conv: str, dense: str, x: torch.Tensor) -> torch.Tensor:
        if self.mesh == "equirectangular":
            return _promoted_nchw(getattr(self, conv), x)
        return _promoted(getattr(self, dense), x)

    def forward(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        z = torch.cat([x, h], dim=-1)
        if self.mesh == "equirectangular":
            z = _promoted_nchw(self.Conv_0, _circular(z, self.pad, 2))
        else:
            z = unfold_faces(_promoted_nchw(self.Conv_0,
                                            fold_faces(healpix_pad_channels_last(z, self.pad))))
        z = self.GroupNormCL_1(self._pointwise("Conv_1", "Dense_0", self.GroupNormCL_0(z)))
        f, i, g, o = z.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        out = self.act(self.GroupNormCL_2(self._pointwise("Conv_2", "Dense_1", c)))
        return torch.sigmoid(o) * out, c_new


def _promoted_nchw(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An NCHW conv on channels-last [B, H, W, C] in the promoted dtype."""
    return _nchw(functools.partial(_promoted, conv), x)
