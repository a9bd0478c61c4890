"""Small-window attention on the fused-qkv layout: the CUDA kernels'
wrappers and their plain versions.

Counterpart of `dlwpbench_tpu/ops/pallas_attention.py`'s token-major
`window_attention_qkv` (`:1462`; `_tm_impl` `:1349`, `_tm_bwd` `:1407`) and
5D `window_attention_qkv5d` (`:1746`; `_tm5_impl` `:1630`, `_tm5_bwd`
`:1688`).  For every member window (b, l, w) and head h, with hd = C / nh:

    s[q, k] = q . k * hd^-1/2 + bias[w or 0, h, k, q] + mask[l or 0, w or 0, k, q]
    out[q]  = softmax_k(s) v,   lse[q] = logsumexp_k(s)

where q, k, v are the head's columns of the window's [N, 3C] rows (q at
h*hd, k at C + h*hd, v at 2C + h*hd).  The bias is KEY-major
[nW or 1, nh, Nk, Nq] (`expand_earth_bias` emits it; 1 = one bias shared
by every window) and the mask [L or 1, nW or 1, N, N] an additive shift
mask, symmetric in its last two dims, or None.  Layouts:

- token-major: qkv [B, L, nW, N, 3C] -> out [B, L, nW, N, C], lse
  [B, L, nW, nh, N] fp32;
- 5D: the padded field qkv5 [B, Pl, Lat, Lon, 3C] whose windows
  (wpl, wlat, wlon) are read in place -> out [B, Pl, Lat, Lon, C], lse
  [B, nLon, nW, nh, N] fp32 with nW = nPl * nLat, tokens in
  `window_partition_3d` order.

For a CUDA tensor each wrapper launches its hand-written kernel
(`csrc/window_attention_qkv.cu`, built at first use) or raises: on an
unsupported dtype, head dim, N, layout, a failed build or a failed launch.
Forward and backward each have two designs, chosen from (N, hd) by
`fwd_route` and `bwd_route`: fused tensor-core kernels for windows up to
144 tokens at head dims up to 48 (every model path), the row kernels for
the rest (the backward's in four passes).  The plain versions run only
for tensors on the CPU.  The differentiable
entries `window_attention_qkv` and `window_attention_qkv5d` are
`torch.autograd.Function`s whose backward goes through the `_bwd`
wrappers; the mask is a constant and gets no gradient.  Each wrapper
counts its launches in `.launches`, those of the fused design in
`.fused_launches` and those of the bf16 instance in `.bf16_launches`.
"""

from __future__ import annotations

import torch

from dlwpbench_tpu_torch.ops.flash_attention import _DTYPE_CODE, _device_of, _kernel_fn

MAX_HEAD_DIM = 128
MAX_N = 1023
FUSED_MAX_N, FUSED_MAX_HEAD_DIM = 144, 48  # the fused designs' region
_SOURCE = "window_attention_qkv"
_TOKEN_MAJOR, _FIELD_5D = 0, 1  # the kernels' `layout` argument


# ---------------------------------------------------------------- layouts
def partition_windows_5d(x: torch.Tensor, win) -> torch.Tensor:
    """[B, Pl, Lat, Lon, F] -> [B, nLon, nPl*nLat, wpl*wlat*wlon, F]: the
    token order of `window_partition_3d`."""
    B, Pl, Lat, Lon, F = x.shape
    wpl, wlat, wlon = win
    x = x.reshape(B, Pl // wpl, wpl, Lat // wlat, wlat, Lon // wlon, wlon, F)
    x = x.permute(0, 5, 1, 3, 2, 4, 6, 7)
    return x.reshape(B, Lon // wlon, (Pl // wpl) * (Lat // wlat), wpl * wlat * wlon, F)


def reverse_windows_5d(x: torch.Tensor, win, Pl: int, Lat: int, Lon: int) -> torch.Tensor:
    """The inverse of `partition_windows_5d`."""
    wpl, wlat, wlon = win
    B, F = x.shape[0], x.shape[-1]
    x = x.reshape(B, Lon // wlon, Pl // wpl, Lat // wlat, wpl, wlat, wlon, F)
    return x.permute(0, 2, 4, 3, 5, 1, 6, 7).reshape(B, Pl, Lat, Lon, F)


def _zero_mask(N: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((1, 1, N, N), dtype=like.dtype, device=like.device)


def _check_bias_mask(bias, mask, L, nW, N, nh):
    if bias.ndim != 4 or tuple(bias.shape[1:]) != (nh, N, N) or bias.shape[0] not in (1, nW):
        raise ValueError(f"bias must be [nW or 1, nh, N, N] = [{nW} or 1, {nh}, {N}, {N}], "
                         f"got {tuple(bias.shape)}")
    if mask is not None and (
        mask.ndim != 4 or tuple(mask.shape[2:]) != (N, N)
        or mask.shape[0] not in (1, L) or mask.shape[1] not in (1, nW)
    ):
        raise ValueError(f"mask must be [L or 1, nW or 1, N, N] = [{L} or 1, {nW} or 1, "
                         f"{N}, {N}], got {tuple(mask.shape)}")


def _check_qkv(qkv, nh):
    if qkv.ndim != 5 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % nh:
        raise ValueError(f"qkv must be 5D with a last dim 3C, C % nh == 0, got "
                         f"{tuple(qkv.shape)}, nh {nh}")


def _check_token_major(qkv, bias, mask, nh):
    """Validate shapes; returns (B, L, nW, N, C)."""
    _check_qkv(qkv, nh)
    B, L, nW, N, C3 = qkv.shape
    _check_bias_mask(bias, mask, L, nW, N, nh)
    return B, L, nW, N, C3 // 3


def _window_dims(qkv5, bias, mask, nh, win):
    """Validate a 5D field, its window, bias and mask; returns (nLon, nW, N)."""
    _check_qkv(qkv5, nh)
    if len(win) != 3:
        raise ValueError(f"window {win} is not 3D")
    _, Pl, Lat, Lon, _ = qkv5.shape
    wpl, wlat, wlon = win
    if Pl % wpl or Lat % wlat or Lon % wlon:
        raise ValueError(f"window {tuple(win)} does not tile the field {(Pl, Lat, Lon)}")
    L, nW, N = Lon // wlon, (Pl // wpl) * (Lat // wlat), wpl * wlat * wlon
    _check_bias_mask(bias, mask, L, nW, N, nh)
    return L, nW, N


# ---------------------------------------------------------------- plain versions
def window_attention_qkv_plain(qkv, bias, mask, nh):
    """Plain PyTorch version on the token-major layout, fp32 whatever the
    input type.  Returns (out [B,L,nW,N,C] in qkv's dtype, lse [B,L,nW,nh,N]
    fp32)."""
    B, L, nW, N, C = _check_token_major(qkv, bias, mask, nh)
    hd = C // nh
    x = qkv.float().reshape(B, L, nW, N, 3, nh, hd)
    q, k, v = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    s = torch.einsum("blwnhd,blwmhd->blwhnm", q * hd**-0.5, k)
    s = s + bias.float().transpose(-1, -2)[None, None]
    if mask is not None:
        s = s + mask.float().transpose(-1, -2)[None, :, :, None]
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("blwhnm,blwmhd->blwnhd", p, v)
    return out.reshape(B, L, nW, N, C).to(qkv.dtype), lse


def window_attention_qkv_bwd_plain(qkv, bias, mask, out, lse, dout):
    """Plain PyTorch backward of `window_attention_qkv_plain`, fp32 whatever
    the input type (nh is lse's dim 3).  Returns (dqkv in qkv's layout and
    dtype, dbias [nW or 1, nh, N, N] key-major in the bias's dtype, summed
    over (B, L), and over the windows too when the bias is shared)."""
    nh = lse.shape[3]
    B, L, nW, N, C = _check_token_major(qkv, bias, mask, nh)
    hd = C // nh
    scale = hd**-0.5
    x = qkv.float().reshape(B, L, nW, N, 3, nh, hd)
    q, k, v = x[..., 0, :, :] * scale, x[..., 1, :, :], x[..., 2, :, :]
    do = dout.float().reshape(B, L, nW, N, nh, hd)
    o = out.float().reshape(B, L, nW, N, nh, hd)
    s = torch.einsum("blwnhd,blwmhd->blwhnm", q, k) + bias.float().transpose(-1, -2)[None, None]
    if mask is not None:
        s = s + mask.float().transpose(-1, -2)[None, :, :, None]
    p = torch.exp(s - lse.float()[..., None])
    drow = (do * o).sum(-1).permute(0, 1, 2, 4, 3)  # [B, L, nW, nh, N]
    dv = torch.einsum("blwhnm,blwnhd->blwmhd", p, do)
    dp = torch.einsum("blwnhd,blwmhd->blwhnm", do, v)
    ds = p * (dp - drow[..., None])
    dq = torch.einsum("blwhnm,blwmhd->blwnhd", ds, k) * scale
    dk = torch.einsum("blwhnm,blwnhd->blwmhd", ds, q)
    dqkv = torch.stack([dq, dk, dv], dim=4).reshape(B, L, nW, N, 3 * C)
    dbias = ds.sum((0, 1))  # [nW, nh, Nq, Nk]
    if bias.shape[0] == 1:
        dbias = dbias.sum(0, keepdim=True)
    return dqkv.to(qkv.dtype), dbias.transpose(-1, -2).to(bias.dtype)


def window_attention_qkv5d_plain(qkv5, bias, mask, nh, win):
    """Plain PyTorch version on the 5D field: partition -> token-major plain
    -> reverse.  Returns (out [B,Pl,Lat,Lon,C], lse [B,nLon,nW,nh,N] fp32)."""
    Pl, Lat, Lon = qkv5.shape[1:4]
    out, lse = window_attention_qkv_plain(partition_windows_5d(qkv5, win), bias, mask, nh)
    return reverse_windows_5d(out, win, Pl, Lat, Lon), lse


def window_attention_qkv5d_bwd_plain(qkv5, bias, mask, out5, lse, dout5, win):
    """Plain PyTorch backward of `window_attention_qkv5d_plain`: (dqkv5 in
    the 5D layout, dbias as `window_attention_qkv_bwd_plain`)."""
    Pl, Lat, Lon = qkv5.shape[1:4]
    part = lambda t: partition_windows_5d(t, win)  # noqa: E731
    dqkv, dbias = window_attention_qkv_bwd_plain(part(qkv5), bias, mask, part(out5), lse,
                                                 part(dout5))
    return reverse_windows_5d(dqkv, win, Pl, Lat, Lon), dbias


# ---------------------------------------------------------------- CUDA wrappers
def _check_cuda(name, tensors, hd, N):
    """What the small-window kernels (this module's and
    `packed_attention`'s) take: one CUDA device, all tensors float32 or all
    bfloat16, head dim a multiple of 8 up to 128, N up to 1023, contiguous
    and 16-byte aligned."""
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODE or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{name} takes its tensors all float32 or all bfloat16, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} unsupported: need a multiple of 8 <= {MAX_HEAD_DIM}")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"window of N = {N} tokens unsupported: need 1 <= N <= {MAX_N}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: its tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):  # the kernels copy 4 elements at a time
        raise ValueError(f"{name}: its tensors must be 16-byte aligned")


def _no_grad_guard(name, tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is not differentiable; call window_attention_qkv or "
            "window_attention_qkv5d, whose backward launches the CUDA backward kernels"
        )


def _dims(layout, x, bias, mask, nh, win):
    """The kernels' integer arguments after `dtype`'s place: B, L, nW, N,
    nh, hd, bW, mL, mW, Pl, Lat, Lon, wpl, wlat, wlon."""
    if layout == _TOKEN_MAJOR:
        B, L, nW, N, C3 = x.shape
        field = (0, 0, 0, 0, 0, 0)
    else:
        L, nW, N = _window_dims(x, bias, mask, nh, win)
        B, C3 = x.shape[0], x.shape[-1]
        field = (*x.shape[1:4], *win)
    return (B, L, nW, N, nh, C3 // 3 // nh, bias.shape[0], mask.shape[0], mask.shape[1],
            *field)


def _bwd_chunks(bW, nh, members_per_window):
    """How many member chunks the four-pass route's dbias pass splits each
    bias window into: at least about 1024 (bias window, head, chunk)
    triples to fill the card (each has one block per [N, N] tile besides)."""
    want = -(-1024 // (bW * nh))
    return max(1, min(members_per_window, want, 65535 // bW))


def bwd_route(N, hd):
    """Which backward design takes a window of N tokens at head dim hd:
    "fused" (one tensor-core pass per member, for N <= FUSED_MAX_N and hd
    <= FUSED_MAX_HEAD_DIM; its largest block, 207,360 B of shared memory at
    N 144, hd 48 by the budget in `csrc/window_attention_qkv.cu`, fits the
    232,448 B an H100 block may hold, and hd 64 would not) or "four_pass"
    (the row kernels, any N to MAX_N).  Decided from the shape before the
    launch, never as a retry."""
    return "fused" if N <= FUSED_MAX_N and hd <= FUSED_MAX_HEAD_DIM else "four_pass"


def fwd_route(N, hd):
    """Which forward design takes a window of N tokens at head dim hd:
    "fused" (one tensor-core pass per (member, head) holding each query's
    whole row of scores in registers, for N <= FUSED_MAX_N and hd <=
    FUSED_MAX_HEAD_DIM, the region `bwd_route` uses) or "row" (the
    row-per-thread kernel with an online softmax, any N to MAX_N).  Decided
    from the shape before the launch, never as a retry."""
    return "fused" if N <= FUSED_MAX_N and hd <= FUSED_MAX_HEAD_DIM else "row"


def _fused_chunks(bW, nh, members_per_window):
    """How many member chunks the fused backward splits each bias window
    into: about 1024 (bias window, head, chunk) blocks, 8 per SM of an
    H100, so that the last blocks leave little of the card idle, but at
    least 4 members a chunk, since each block also writes an [N, N] dbias
    partial that the chunk sum reads back."""
    want = -(-1024 // (bW * nh))
    return max(1, min(members_per_window, want, members_per_window // 4))


def _launch_fwd(name, layout, x, bias, mask, nh, win, out_shape, lse_shape, route=None):
    """Launches the forward of `route` ("fused" or "row"; by default the
    one `fwd_route` names, as the public wrappers take it); returns (out,
    lse, route)."""
    dims = _dims(layout, x, bias, mask, nh, win)
    _check_cuda(name, (x, bias, mask), dims[5], dims[3])
    _no_grad_guard(name, (x, bias))
    route = route or fwd_route(dims[3], dims[5])
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    lse = torch.empty(lse_shape, dtype=torch.float32, device=x.device)
    symbol = "window_attention_qkv_fwd_fused" if route == "fused" else "window_attention_qkv_fwd"
    fn = _kernel_fn(_SOURCE, symbol, 5, 17)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), bias.data_ptr(), mask.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), *dims, layout, _DTYPE_CODE[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} on the {route} route for qkv "
                           f"{tuple(x.shape)} {x.dtype}, bias {tuple(bias.shape)}, "
                           f"mask {tuple(mask.shape)}, nh {nh}")
    return out, lse, route


def _launch_bwd(name, layout, x, bias, mask, out, lse, dout, win):
    nh = lse.shape[3]
    dims = _dims(layout, x, bias, mask, nh, win)
    B, L, nW, N, _, hd, bW = dims[:7]
    if tuple(out.shape) != tuple(x.shape[:-1]) + (x.shape[-1] // 3,) or dout.shape != out.shape:
        raise ValueError(f"{name}: out {tuple(out.shape)} and dO {tuple(dout.shape)} do not "
                         f"fit qkv {tuple(x.shape)}")
    if tuple(lse.shape) != (B, L, nW, nh, N) or lse.dtype != torch.float32:
        raise TypeError(f"{name}: lse must be float32 [B, L, nW, nh, N] = {(B, L, nW, nh, N)}, "
                        f"got {lse.dtype} {tuple(lse.shape)}")
    _check_cuda(name, (x, bias, mask, out, dout), hd, N)
    lse = lse.contiguous()
    route = bwd_route(N, hd)
    members = B * L * (nW if bW == 1 else 1)
    dqkv = torch.empty_like(x)
    dbias = torch.empty_like(bias)
    tensors = [x, bias, mask, out, dout, lse, dqkv, dbias]
    if route == "fused":
        n_chunks = _fused_chunks(bW, nh, members)
        fn = _kernel_fn(_SOURCE, "window_attention_qkv_bwd_fused", 9, 18)
    else:
        n_chunks = _bwd_chunks(bW, nh, members)
        tensors.append(torch.empty_like(lse))  # drow
        fn = _kernel_fn(_SOURCE, "window_attention_qkv_bwd", 10, 18)
    tensors.append(torch.empty((n_chunks, bW, nh, N, N), dtype=torch.float32, device=x.device))
    with torch.cuda.device(x.device):
        err = fn(*(t.data_ptr() for t in tensors), *dims, n_chunks, layout,
                 _DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} on the {route} route for qkv "
                           f"{tuple(x.shape)} {x.dtype}, bias {tuple(bias.shape)}, "
                           f"mask {tuple(mask.shape)}")
    return dqkv, dbias, route


def window_attention_qkv_fwd(qkv, bias, mask, nh):
    """(out [B,L,nW,N,C], lse [B,L,nW,nh,N] fp32) on the token-major layout.

    CPU tensors take the plain version; CUDA tensors the kernel of
    `fwd_route`'s design, whose launches are counted in
    `window_attention_qkv_fwd.launches`, and those of the fused route in
    `.fused_launches` too.  Not differentiable on CUDA tensors: use
    `window_attention_qkv`."""
    B, L, nW, N, C = _check_token_major(qkv, bias, mask, nh)
    if _device_of((qkv, bias) if mask is None else (qkv, bias, mask)).type == "cpu":
        return window_attention_qkv_plain(qkv, bias, mask, nh)
    mask = _zero_mask(N, qkv) if mask is None else mask
    out, lse, route = _launch_fwd("window_attention_qkv_fwd", _TOKEN_MAJOR, qkv, bias, mask,
                                  nh, None, (B, L, nW, N, C), (B, L, nW, nh, N))
    window_attention_qkv_fwd.launches += 1
    window_attention_qkv_fwd.bf16_launches += qkv.dtype == torch.bfloat16
    window_attention_qkv_fwd.fused_launches += route == "fused"
    return out, lse


window_attention_qkv_fwd.launches = 0
window_attention_qkv_fwd.bf16_launches = 0
window_attention_qkv_fwd.fused_launches = 0


def window_attention_qkv_bwd(qkv, bias, mask, out, lse, dout):
    """(dqkv, dbias) of `window_attention_qkv_fwd`; see
    `window_attention_qkv_bwd_plain`.  CUDA tensors take the kernels of
    `bwd_route`'s design: one counted launch in
    `window_attention_qkv_bwd.launches` runs all its passes, and
    `window_attention_qkv_bwd.fused_launches` counts those of the fused
    route."""
    nh = lse.shape[3]
    _check_token_major(qkv, bias, mask, nh)
    tensors = (qkv, bias, out, lse, dout) + (() if mask is None else (mask,))
    if _device_of(tensors).type == "cpu":
        return window_attention_qkv_bwd_plain(qkv, bias, mask, out, lse, dout)
    mask = _zero_mask(qkv.shape[3], qkv) if mask is None else mask
    dqkv, dbias, route = _launch_bwd("window_attention_qkv_bwd", _TOKEN_MAJOR, qkv, bias,
                                     mask, out, lse, dout, None)
    window_attention_qkv_bwd.launches += 1
    window_attention_qkv_bwd.bf16_launches += qkv.dtype == torch.bfloat16
    window_attention_qkv_bwd.fused_launches += route == "fused"
    return dqkv, dbias


window_attention_qkv_bwd.launches = 0
window_attention_qkv_bwd.bf16_launches = 0
window_attention_qkv_bwd.fused_launches = 0


def window_attention_qkv5d_fwd(qkv5, bias, mask, nh, win):
    """(out [B,Pl,Lat,Lon,C], lse [B,nLon,nW,nh,N] fp32) on the 5D field.

    CPU tensors take the plain version; CUDA tensors the kernel of
    `fwd_route`'s design, counted in `window_attention_qkv5d_fwd.launches`
    (and in `.fused_launches` too on the fused route).  Not differentiable
    on CUDA tensors: use `window_attention_qkv5d`."""
    win = tuple(int(w) for w in win)
    nLon, nW, N = _window_dims(qkv5, bias, mask, nh, win)
    B, C3 = qkv5.shape[0], qkv5.shape[-1]
    if _device_of((qkv5, bias) if mask is None else (qkv5, bias, mask)).type == "cpu":
        return window_attention_qkv5d_plain(qkv5, bias, mask, nh, win)
    mask = _zero_mask(N, qkv5) if mask is None else mask
    out, lse, route = _launch_fwd("window_attention_qkv5d_fwd", _FIELD_5D, qkv5, bias, mask,
                                  nh, win, tuple(qkv5.shape[:-1]) + (C3 // 3,),
                                  (B, nLon, nW, nh, N))
    window_attention_qkv5d_fwd.launches += 1
    window_attention_qkv5d_fwd.bf16_launches += qkv5.dtype == torch.bfloat16
    window_attention_qkv5d_fwd.fused_launches += route == "fused"
    return out, lse


window_attention_qkv5d_fwd.launches = 0
window_attention_qkv5d_fwd.bf16_launches = 0
window_attention_qkv5d_fwd.fused_launches = 0


def window_attention_qkv5d_bwd(qkv5, bias, mask, out5, lse, dout5, win):
    """(dqkv5, dbias) of `window_attention_qkv5d_fwd`; CUDA tensors take the
    kernels of `bwd_route`'s design (one counted launch in
    `window_attention_qkv5d_bwd.launches`, and in `.fused_launches` too on
    the fused route)."""
    win = tuple(int(w) for w in win)
    _, _, N = _window_dims(qkv5, bias, mask, lse.shape[3], win)
    tensors = (qkv5, bias, out5, lse, dout5) + (() if mask is None else (mask,))
    if _device_of(tensors).type == "cpu":
        return window_attention_qkv5d_bwd_plain(qkv5, bias, mask, out5, lse, dout5, win)
    mask = _zero_mask(N, qkv5) if mask is None else mask
    dqkv, dbias, route = _launch_bwd("window_attention_qkv5d_bwd", _FIELD_5D, qkv5, bias,
                                     mask, out5, lse, dout5, win)
    window_attention_qkv5d_bwd.launches += 1
    window_attention_qkv5d_bwd.bf16_launches += qkv5.dtype == torch.bfloat16
    window_attention_qkv5d_bwd.fused_launches += route == "fused"
    return dqkv, dbias


window_attention_qkv5d_bwd.launches = 0
window_attention_qkv5d_bwd.bf16_launches = 0
window_attention_qkv5d_bwd.fused_launches = 0


# ---------------------------------------------------------------- autograd
class _WindowAttentionQKV(torch.autograd.Function):
    """The counterpart of `_tm_diff` (`pallas_attention.py:1396-1459`)."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, nh):
        out, lse = window_attention_qkv_fwd(qkv, bias, mask, nh)
        ctx.save_for_backward(qkv, bias, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask, out, lse = ctx.saved_tensors
        dqkv, dbias = window_attention_qkv_bwd(qkv, bias, mask, out, lse, dout.contiguous())
        return dqkv, dbias, None, None


class _WindowAttentionQKV5D(torch.autograd.Function):
    """The counterpart of `_tm5_diff` (`pallas_attention.py:1677-1743`)."""

    @staticmethod
    def forward(ctx, qkv5, bias, mask, nh, win):
        out, lse = window_attention_qkv5d_fwd(qkv5, bias, mask, nh, win)
        ctx.save_for_backward(qkv5, bias, mask, out, lse)
        ctx.win = win
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv5, bias, mask, out, lse = ctx.saved_tensors
        dqkv, dbias = window_attention_qkv5d_bwd(qkv5, bias, mask, out, lse,
                                                 dout.contiguous(), ctx.win)
        return dqkv, dbias, None, None, None


def window_attention_qkv(qkv, bias, mask, nh):
    """Differentiable token-major window attention [B,L,nW,N,C]; a None mask
    is a zero [1,1,N,N] mask (`pallas_attention.py:1486-1488`)."""
    if mask is None:
        mask = _zero_mask(qkv.shape[3], qkv)
    return _WindowAttentionQKV.apply(qkv, bias, mask, nh)


def window_attention_qkv5d(qkv5, bias, mask, nh, win):
    """Differentiable window attention on the 5D field [B,Pl,Lat,Lon,C]; a
    None mask is a zero [1,1,N,N] mask (`pallas_attention.py:1767-1770`)."""
    win = tuple(int(w) for w in win)
    if mask is None:
        mask = _zero_mask(win[0] * win[1] * win[2], qkv5)
    return _WindowAttentionQKV5D.apply(qkv5, bias, mask, nh, win)
