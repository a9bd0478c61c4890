"""The spectral mixing layers on latitude-sharded fields (counterpart of
`dlwpbench_tpu/parallel/spectral_dist.py`), over the distributed SHT and
rFFT2:

- `dist_spherical_conv`: SFNO's Driscoll-Healy step; the weight does not
  depend on m, so each rank contracts its local m-block with the whole
  weight and no collective joins the contraction;
- `dist_sfno_blocks`: SFNO's block stack as one schedule whose
  activations stay chunked over channels across the blocks;
- `dist_sfno_blocks_2d`: the same stack on a (latitude x channel) mesh,
  the channel reductions by `launch.reduce_scatter`;
- `dist_afno_filter`: FourCastNet's AFNO filter over the distributed
  rFFT2, the kept-mode columns masked from their global index.

Each function runs on this rank's rows between `launch.scatter_to_ranks`
and `launch.gather_from_ranks`; the `make_*` wrappers put them there for
replicated tensors.  The weights are replicated and each rank applies
them to its own rows or m-block, so after a backward each rank holds its
share of every weight gradient: their sum over the ranks (a model's
`partition_group`, one flat all-reduce in the trainer) is the gradient
JAX's GSPMD sums for free.  Only the fp order of the partial sums
differs from the single-device layers, in JAX's order.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dlwpbench_tpu_torch.ops.sht import SHTTables
from dlwpbench_tpu_torch.ops.spectral import softshrink
from dlwpbench_tpu_torch.parallel import launch
from dlwpbench_tpu_torch.parallel.fft import dist_irfft2, dist_rfft2
from dlwpbench_tpu_torch.parallel.sht_dist import chunk_starts, dist_isht, dist_sht


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu default


def dist_spherical_conv(f_local: torch.Tensor, w: torch.Tensor, tables: SHTTables, group=None,
                        pipeline_chunks: int = 1, comm_dtype=None) -> torch.Tensor:
    """f_local [..., C, nlat/P, nlon] real, w [C, Cout, lmax] complex ->
    [..., Cout, nlat/P, nlon] fp32.  With `pipeline_chunks=K` the mixing
    is K partial sums over input-channel chunks and the inverse transform
    chunks over output channels (JAX's order of partial sums)."""
    w = w.to(torch.complex64)
    if pipeline_chunks <= 1:
        a = dist_sht(f_local, tables, group, comm_dtype=comm_dtype)
        return dist_isht(torch.einsum("...ilm,iol->...olm", a, w), tables, group,
                         comm_dtype=comm_dtype)
    out = None
    for s, n in chunk_starts(f_local.shape[-3], pipeline_chunks):
        a_k = dist_sht(f_local.narrow(-3, s, n), tables, group, comm_dtype=comm_dtype)
        p_k = torch.einsum("...ilm,iol->...olm", a_k, w[s:s + n])
        out = p_k if out is None else out + p_k
    return dist_isht(out, tables, group, pipeline_chunks=pipeline_chunks, comm_dtype=comm_dtype)


def _complex_spec(spec: torch.Tensor) -> torch.Tensor:
    """[C, Cout, lmax, 2] real/imag pairs -> complex64."""
    return torch.complex(spec[..., 0].float(), spec[..., 1].float())


def dist_sfno_blocks(x_local: torch.Tensor, layers: list, tables: SHTTables, group=None,
                     pipeline_chunks: int = 8, comm_dtype=None) -> torch.Tensor:
    """SFNO's block stack (spherical conv + skip Dense -> gelu -> MLP
    residual) on [B, nlat/P, nlon, C], channels-last.  The activation
    stays in K channel chunks across the blocks: each chunk's analysis
    exchange depends on its chunk alone, the mixer and the MLP's first
    layer are partial sums over chunks, its second layer is computed per
    output chunk (JAX's schedule, same math as the per-layer loop).

    `layers`: one dict per block, `spec` [C, C, lmax, 2], `skip_k` [C, C],
    `skip_b` [C], `mlp1_k` [C, HD], `mlp1_b` [HD], `mlp2_k` [HD, C],
    `mlp2_b` [C], kernels in flax's [in, out] layout."""
    ch = chunk_starts(x_local.shape[-1], pipeline_chunks)
    xc = [x_local[..., s:s + n] for s, n in ch]
    dt = x_local.dtype
    for L in layers:
        wc = _complex_spec(L["spec"])
        skip = sum(x_k @ L["skip_k"][s:s + n] for x_k, (s, n) in zip(xc, ch)) + L["skip_b"]
        out = None
        for x_k, (s, n) in zip(xc, ch):
            a_k = dist_sht(x_k.movedim(-1, -3).float(), tables, group, comm_dtype=comm_dtype)
            p_k = torch.einsum("...ilm,iol->...olm", a_k, wc[s:s + n])
            out = p_k if out is None else out + p_k
        z_chunks, h = [], None
        for s, n in ch:
            y_k = dist_isht(out.narrow(-3, s, n), tables, group, comm_dtype=comm_dtype)
            z_k = _gelu(y_k.movedim(-3, -1).to(dt) + skip[..., s:s + n])
            z_chunks.append(z_k)
            h_k = z_k @ L["mlp1_k"][s:s + n]
            h = h_k if h is None else h + h_k
        h = _gelu(h + L["mlp1_b"])
        xc = [z_k + h @ L["mlp2_k"][:, s:s + n] + L["mlp2_b"][s:s + n]
              for z_k, (s, n) in zip(z_chunks, ch)]
    return torch.cat(xc, dim=-1)


def dist_sfno_blocks_2d(x_local: torch.Tensor, layers: list, tables: SHTTables, group_x,
                        group_c, pipeline_chunks: int = 4, comm_dtype=None) -> torch.Tensor:
    """The same block stack on a (latitude x channel) mesh: x_local [B,
    nlat/Px, nlon, C/Q], latitude over `group_x`, channels over `group_c`
    (Q ranks), the parameters replicated (`layers` as for
    `dist_sfno_blocks`).  Each rank contracts its input channels against
    every output and `launch.reduce_scatter` over `group_c` sums the
    partials into its output chunk (JAX's `psum_scatter`): the mixer's
    spectrum, the skip Dense, and both MLP layers, the hidden dim split
    over Q."""
    C_loc = x_local.shape[-1]
    Q, cq = dist.get_world_size(group_c), dist.get_rank(group_c)
    dt = x_local.dtype
    ch = chunk_starts(C_loc, pipeline_chunks)
    for L in layers:
        if L["mlp1_k"].shape[1] % Q:
            raise ValueError(f"MLP hidden dim {L['mlp1_k'].shape[1]} does not split over the "
                             f"channel axis ({Q})")
    i0 = cq * C_loc
    for L in layers:
        wc = _complex_spec(L["spec"])
        skip = (launch.reduce_scatter(x_local @ L["skip_k"][i0:i0 + C_loc], -1, group_c)
                + L["skip_b"][i0:i0 + C_loc])
        out = None  # the mixer over this rank's input channels, all outputs
        for s, n in ch:
            a_k = dist_sht(x_local[..., s:s + n].movedim(-1, -3).float(), tables, group_x,
                           comm_dtype=comm_dtype)
            p_k = torch.einsum("...ilm,iol->...olm", a_k, wc[i0 + s:i0 + s + n])
            out = p_k if out is None else out + p_k
        # the channel reduction of the spectral partials, as real pairs
        out = torch.view_as_complex(
            launch.reduce_scatter(torch.view_as_real(out), -4, group_c).contiguous())
        z_chunks, h = [], None
        for s, n in ch:
            y_k = dist_isht(out.narrow(-3, s, n), tables, group_x, comm_dtype=comm_dtype)
            z_k = _gelu(y_k.movedim(-3, -1).to(dt) + skip[..., s:s + n])
            z_chunks.append(z_k)
            h_k = z_k @ L["mlp1_k"][i0 + s:i0 + s + n]
            h = h_k if h is None else h + h_k
        hd = L["mlp1_k"].shape[1] // Q
        h = _gelu(launch.reduce_scatter(h, -1, group_c) + L["mlp1_b"][cq * hd:(cq + 1) * hd])
        o = (launch.reduce_scatter(h @ L["mlp2_k"][cq * hd:(cq + 1) * hd], -1, group_c)
             + L["mlp2_b"][i0:i0 + C_loc])
        x_local = torch.cat(z_chunks, dim=-1) + o
    return x_local


def dist_afno_filter(x_local: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor, group=None,
                     hard_thresholding_fraction: float = 1.0,
                     sparsity_threshold: float = 0.01) -> torch.Tensor:
    """The AFNO filter on [..., H/P, W, C] (residual not included), fp32:
    w1 [2, nb, bs, hs], b1 [2, nb, hs], w2 [2, nb, hs, bs], b2 [2, nb, bs]
    (real and imaginary parts on axis 0), the single-device
    `ops.spectral.AFNO2DFilter`'s.  The kept rows are the same band; the
    kept columns, the first `kept` of the global rFFT (the reference's
    quirk: both cutoffs from the H-based count), are masked from each
    rank's global column index, which also drops the Wf padding."""
    H_loc, W, C = x_local.shape[-3:]
    p, idx = dist.get_world_size(group), dist.get_rank(group)
    H = H_loc * p
    nb, bs = w1.shape[1], w1.shape[2]
    if nb * bs != C:
        raise ValueError(f"block structure {nb}x{bs} != channels {C}")
    w1, b1, w2, b2 = (t.float() for t in (w1, b1, w2, b2))
    # dist_rfft2 is unnormalised: rescaled to "ortho", so the coefficients,
    # and the scale-sensitive softshrink, match the single-device filter
    Xf = dist_rfft2(x_local.movedim(-1, -3), group) * (1.0 / math.sqrt(H * W))
    wf_loc = Xf.shape[-1]
    total = H // 2 + 1
    kept = int(total * hard_thresholding_fraction)
    r0, r1 = total - kept, min(total + kept, H)
    col = idx * wf_loc + torch.arange(wf_loc, device=x_local.device)
    col_keep = (col < kept)[:, None]

    Z = Xf.movedim(-3, -1)[..., r0:r1, :, :]  # [..., rows, wf, C]
    Z = Z.reshape(*Z.shape[:-1], nb, bs)
    zr, zi = Z.real, Z.imag

    def mix(a, w):
        return torch.einsum("...ni,nio->...no", a, w)

    o1r = torch.relu(mix(zr, w1[0]) - mix(zi, w1[1]) + b1[0])
    o1i = torch.relu(mix(zi, w1[0]) + mix(zr, w1[1]) + b1[1])
    o2r = mix(o1r, w2[0]) - mix(o1i, w2[1]) + b2[0]
    o2i = mix(o1i, w2[0]) + mix(o1r, w2[1]) + b2[1]

    def place(o):  # [..., rows, wf, nb, bs] -> [..., C, H, wf], zero off the kept band
        o = softshrink(o, sparsity_threshold).reshape(*o.shape[:-2], C)
        o = torch.where(col_keep, o, 0.0)
        return F.pad(o, (0, 0, 0, 0, r0, H - r1)).movedim(-1, -3)

    y = torch.complex(place(o2r), place(o2i))
    out = dist_irfft2(y * math.sqrt(H * W), W, group)  # undo the ortho scale
    return out.movedim(-3, -1)


def make_dist_spherical_conv(mesh, tables: SHTTables, axis_name: str = "x",
                             pipeline_chunks: int = 1, comm_dtype=None):
    """`dist_spherical_conv` on replicated [..., C, nlat, nlon] fields;
    `conv(x, w)`.  Each rank's weight gradient is its share (see the
    module's docstring)."""
    group = launch.axis(mesh, axis_name)[0]

    def conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        y = dist_spherical_conv(launch.scatter_to_ranks(x, x.ndim - 2, group), w, tables, group,
                                pipeline_chunks, comm_dtype)
        return launch.gather_from_ranks(y, y.ndim - 2, group)

    return conv


def make_dist_sfno_blocks(mesh, tables: SHTTables, axis_name: str = "x",
                          pipeline_chunks: int = 8, comm_dtype=None):
    """`dist_sfno_blocks` on replicated [B, nlat, nlon, C] fields;
    `fn(x, layers)`."""
    group = launch.axis(mesh, axis_name)[0]

    def fn(x: torch.Tensor, layers: list) -> torch.Tensor:
        y = dist_sfno_blocks(launch.scatter_to_ranks(x, 1, group), layers, tables, group,
                             pipeline_chunks, comm_dtype)
        return launch.gather_from_ranks(y, 1, group)

    return fn


def make_dist_sfno_blocks_2d(mesh, tables: SHTTables, axis_x: str = "x", axis_c: str = "c",
                             pipeline_chunks: int = 4, comm_dtype=None):
    """`dist_sfno_blocks_2d` on replicated [B, nlat, nlon, C] fields over a
    mesh with dims `axis_x` and `axis_c`; `fn(x, layers)`.  The weight
    gradients are shares over both dims: sum them over the whole mesh."""
    gx, gc = launch.axis(mesh, axis_x)[0], launch.axis(mesh, axis_c)[0]

    def fn(x: torch.Tensor, layers: list) -> torch.Tensor:
        x = launch.scatter_to_ranks(launch.scatter_to_ranks(x, 1, gx), 3, gc)
        y = dist_sfno_blocks_2d(x, layers, tables, gx, gc, pipeline_chunks, comm_dtype)
        return launch.gather_from_ranks(launch.gather_from_ranks(y, 3, gc), 1, gx)

    return fn


def make_dist_afno_filter(mesh, axis_name: str = "x", hard_thresholding_fraction: float = 1.0,
                          sparsity_threshold: float = 0.01):
    """`dist_afno_filter` on replicated [..., H, W, C] fields;
    `f(x, w1, b1, w2, b2)`."""
    group = launch.axis(mesh, axis_name)[0]

    def f(x, w1, b1, w2, b2):
        y = dist_afno_filter(launch.scatter_to_ranks(x, x.ndim - 3, group), w1, b1, w2, b2,
                             group, hard_thresholding_fraction, sparsity_threshold)
        return launch.gather_from_ranks(y, y.ndim - 3, group)

    return f
