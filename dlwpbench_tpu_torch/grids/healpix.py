"""HEALPix grid geometry: index maps and the neighbour padding as a gather
(the port's copy of `dlwpbench_tpu/grids/healpix.py`, numpy only).

The reference (dlwp-benchmark) represents HEALPix data as [F=12, H=nside,
W=nside] face arrays and pads each face from its neighbours with per-face
`torch.cat`/`rot90` assembly plus synthesized missing corners
(`utils/healpix.py:165-368`).  Here the padding is *precomputed* as a
gather:

    padded[f, i, j] = w0 * flat[idx0[f, i, j]] + w1 * flat[idx1[f, i, j]]

where `flat` is the [12*H*W] flattened field.  Every padded pixel is either a
copy of exactly one source pixel (w = 1) or the average of two (the
synthesized top-left/bottom-right corner diagonals, w = 0.5 each;
`utils/healpix.py:316-368`).  The index tables are derived by running the
reference's *exact* neighbour/rotation algorithm on symbolic (index, weight)
pairs in numpy, once, which keeps the reference's padding semantics while
the runtime op is one gather and a 2-tap weighted sum
(`ops/padding.py::healpix_pad`).

Face layout (reference `utils/healpix.py:167-175`): faces 0-3 north, 4-7
equator, 8-11 south.

Index-map conventions follow the reference's nested-scheme bit interleave
(`data/processing/healpix_mapping.py:439-483`): within a face, even bits of
the pixel index encode y and odd bits encode x; the [F, H, W] array stores
value (f, y, x) at [f, nside-1-x, nside-1-y] (assignment `hpx3d[f, x, y]`
followed by a flip of both axes, `healpix_mapping.py:415-422`).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "npix",
    "nest_to_fhw",
    "fhw_to_nest",
    "ring_to_nest",
    "nest_to_ring",
    "build_pad_indices",
]


def npix(nside: int) -> int:
    return 12 * nside * nside


# ---------------------------------------------------------------------------
# Nested-scheme bit interleave (vectorized)
# ---------------------------------------------------------------------------


def _spread_bits(v: np.ndarray) -> np.ndarray:
    """Spread the bits of v so bit k moves to bit 2k (supports nside<=2**16)."""
    v = v.astype(np.uint64)
    v = (v | (v << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
    v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
    return v


def _compress_bits(v: np.ndarray) -> np.ndarray:
    """Inverse of _spread_bits: gather even bits of v down to contiguous bits."""
    v = v.astype(np.uint64) & np.uint64(0x5555555555555555)
    v = (v | (v >> np.uint64(1))) & np.uint64(0x3333333333333333)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return v


@functools.lru_cache(maxsize=None)
def nest_to_fhw(nside: int) -> np.ndarray:
    """Map [F, H, W] positions -> nested 1D HEALPix indices.

    Returns int64 array `m` of shape [12, nside, nside] with
    `fhw_array.reshape(-1)[...]` semantics: `hpx_fhw = hpx1d_nest[m]`.

    Matches reference `healpix_mapping.py:406-422` (hpx1d2hpx3d): the value at
    nested index with face f, interleaved (y even bits, x odd bits) lands at
    [f, nside-1-x, nside-1-y].
    """
    f = np.arange(12).reshape(12, 1, 1)
    h = np.arange(nside).reshape(1, nside, 1)
    w = np.arange(nside).reshape(1, 1, nside)
    x = nside - 1 - h
    y = nside - 1 - w
    within = (_spread_bits(y) << np.uint64(1)) | _spread_bits(x)
    return f * nside * nside + within.astype(np.int64)


@functools.lru_cache(maxsize=None)
def fhw_to_nest(nside: int) -> np.ndarray:
    """Inverse map: nested 1D index -> flattened [F*H*W] position."""
    m = nest_to_fhw(nside).reshape(-1)
    inv = np.empty_like(m)
    inv[m] = np.arange(m.size)
    return inv


# ---------------------------------------------------------------------------
# RING <-> NESTED (pure numpy, replaces healpy dependency for remapping)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def ring_to_nest(nside: int) -> np.ndarray:
    """ring_to_nest(nside)[ring_idx] = nested_idx (int64, length 12*nside^2).

    Standard HEALPix ordering conversion (Gorski et al. 2005), implemented
    from the published pixelization equations in vectorized numpy (the
    reference leans on healpy's C++ for this; we are healpy-free).
    """
    n = npix(nside)
    p = np.arange(n, dtype=np.int64)
    ncap = 2 * nside * (nside - 1)

    ring, phi = _ring_decompose(nside, p)
    face, x, y = _ring2xyf(nside, ring, phi)

    nest = (face.astype(np.int64) * nside * nside) + (
        (_spread_bits(y.astype(np.uint64)) << np.uint64(1))
        | _spread_bits(x.astype(np.uint64))
    ).astype(np.int64)
    return nest


def _isqrt(v: np.ndarray) -> np.ndarray:
    """Exact vectorized integer sqrt (float64 sqrt + fixup)."""
    r = np.floor(np.sqrt(v.astype(np.float64))).astype(np.int64)
    r = np.where((r + 1) * (r + 1) <= v, r + 1, r)
    r = np.where(r * r > v, r - 1, r)
    return r


def _ring_decompose(nside: int, p: np.ndarray):
    """Ring pixel index -> (ring number 1..4*nside-1, 1-based pixel-in-ring)."""
    n = npix(nside)
    ncap = 2 * nside * (nside - 1)
    ring = np.empty(p.shape, np.int64)
    phi = np.empty(p.shape, np.int64)

    # North polar cap: ring i in [1, nside-1] has 4i pixels.
    cap = p < ncap
    i = (1 + _isqrt(1 + 2 * p[cap])) >> 1
    ring[cap] = i
    phi[cap] = p[cap] + 1 - 2 * i * (i - 1)

    # Equatorial belt: rings nside..3*nside, 4*nside pixels each.
    eq = (p >= ncap) & (p < n - ncap)
    ip = p[eq] - ncap
    i = ip // (4 * nside) + nside
    ring[eq] = i
    phi[eq] = ip % (4 * nside) + 1

    # South polar cap (mirror of north).
    sc = p >= n - ncap
    ip = n - p[sc]
    i = (1 + _isqrt(2 * ip - 1)) >> 1
    ring[sc] = 4 * nside - i
    phi[sc] = 4 * i + 1 - (ip - 2 * i * (i - 1))
    return ring, phi


def _ring2xyf(nside: int, ring: np.ndarray, j: np.ndarray):
    """Vectorized HEALPix ring -> (face, x, y) per Gorski et al. 2005.

    `ring` is the 1-based ring index (1..4*nside-1); `j` the 1-based
    pixel-in-ring index.  Validated round-trip against `nest_to_ring` and the
    analytic ring layout in tests.
    """
    n = ring.shape[0]
    iring = ring.astype(np.int64)
    iphi = j.astype(np.int64)

    jrll = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4], np.int64)
    jpll = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7], np.int64)

    nl2 = 2 * nside
    face = np.empty(n, np.int64)
    ix = np.empty(n, np.int64)
    iy = np.empty(n, np.int64)

    # north polar cap
    m = iring < nside
    if m.any():
        ir, ip = iring[m], iphi[m]
        nr = ir
        kshift = 0
        fn = (ip - 1) // nr
        irt = ir - jrll[fn] * nside + 1  # in [-nside+1 .. 0] range shifted
        ipt = 2 * (ip - fn * nr - 1) - (ir - 1)  # 2*(pos in face) - ring
        ix[m] = (ipt - irt) >> 1
        iy[m] = (-(ipt + irt)) >> 1
        face[m] = fn

    # equatorial belt
    m = (iring >= nside) & (iring <= 3 * nside)
    if m.any():
        ir, ip = iring[m], iphi[m]
        ire = ir - nside + 1  # 1 .. 2*nside+1
        irm = nl2 + 2 - ire
        ifm = (ip - ire // 2 + nside - 1) // nside
        ifp = (ip - irm // 2 + nside - 1) // nside
        fn = np.where(ifp == ifm, ifp | 4, np.where(ifp < ifm, ifp, ifm + 8))
        kshift = (ir - nside) & 1
        irt = ir - jrll[fn] * nside + 1
        ipt = 2 * ip - jpll[fn] * nside - kshift - 1
        ipt = np.where(ipt >= nl2, ipt - 8 * nside, ipt)
        ix[m] = (ipt - irt) >> 1
        iy[m] = (-(ipt + irt)) >> 1
        face[m] = fn

    # south polar cap
    m = iring > 3 * nside
    if m.any():
        ir, ip = iring[m], iphi[m]
        nr = 4 * nside - ir
        fn = 8 + (ip - 1) // nr
        irt = ir - jrll[fn] * nside + 1
        ipt = 2 * (ip - (fn - 8) * nr - 1) - (nr - 1)
        ipt = np.where(ipt >= nl2, ipt - 8 * nside, ipt)
        ix[m] = (ipt - irt) >> 1
        iy[m] = (-(ipt + irt)) >> 1
        face[m] = fn

    return face, ix, iy


@functools.lru_cache(maxsize=None)
def nest_to_ring(nside: int) -> np.ndarray:
    """nest_to_ring(nside)[nested_idx] = ring_idx."""
    r2n = ring_to_nest(nside)
    n2r = np.empty_like(r2n)
    n2r[r2n] = np.arange(r2n.size)
    return n2r


def _xyf2ang(nside: int, face: np.ndarray, ix: np.ndarray, iy: np.ndarray):
    """(face, x, y) -> (z=cos(colat), phi) pixel centers, vectorized.

    Standard HEALPix center equations (Gorski et al. 2005); replaces healpy's
    pix2ang for remap-matrix construction.
    """
    jrll = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4], np.int64)
    jpll = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7], np.int64)
    n = npix(nside)
    fact2 = 4.0 / n
    fact1 = (nside * 2) * fact2
    nl4 = 4 * nside

    jr = jrll[face] * nside - ix - iy - 1  # ring index from north, 1..4n-1

    nr = np.where(jr < nside, jr, np.where(jr > 3 * nside, nl4 - jr, nside))
    z = np.where(
        jr < nside,
        1.0 - nr.astype(np.float64) ** 2 * fact2,
        np.where(
            jr > 3 * nside,
            nr.astype(np.float64) ** 2 * fact2 - 1.0,
            (2 * nside - jr) * fact1,
        ),
    )
    kshift = np.where((jr >= nside) & (jr <= 3 * nside), (jr - nside) & 1, 0)

    jp = (jpll[face] * nr + ix - iy + 1 + kshift) // 2
    jp = np.where(jp > nl4, jp - nl4, jp)
    jp = np.where(jp < 1, jp + nl4, jp)
    phi = (jp - (kshift + 1) * 0.5) * (np.pi / 2 / nr)
    return z, phi


def nest_pix2ang(nside: int, nest_idx: np.ndarray):
    """Nested pixel index -> (latitude_deg, longitude_deg) of pixel centers."""
    nest_idx = np.asarray(nest_idx, np.int64)
    face = nest_idx // (nside * nside)
    rem = (nest_idx % (nside * nside)).astype(np.uint64)
    ix = _compress_bits(rem).astype(np.int64)
    iy = _compress_bits(rem >> np.uint64(1)).astype(np.int64)
    z, phi = _xyf2ang(nside, face, ix, iy)
    lat = np.rad2deg(np.arcsin(np.clip(z, -1.0, 1.0)))
    lon = np.rad2deg(phi) % 360.0
    return lat, lon


def ring_pix2ang(nside: int, ring_idx: np.ndarray):
    """Ring pixel index -> (latitude_deg, longitude_deg). Analytic, direct."""
    p = np.asarray(ring_idx, np.int64)
    n = npix(nside)
    ring, j = _ring_decompose(nside, p)

    north = ring < nside
    south = ring > 3 * nside
    i_cap = np.where(north, ring, 4 * nside - ring)  # ring count from its pole
    eq = ~(north | south)

    z = np.where(
        north,
        1.0 - (i_cap.astype(np.float64) ** 2) * 4.0 / n,
        np.where(
            south,
            (i_cap.astype(np.float64) ** 2) * 4.0 / n - 1.0,
            (2 * nside - ring) * 2.0 / (3.0 * nside),
        ),
    )
    kshift = np.where(eq, (ring - nside) & 1, 0)
    nr = np.where(eq, nside, i_cap)
    phi = (j - (kshift + 1) * 0.5) * (np.pi / 2) / nr

    lat = np.rad2deg(np.arcsin(np.clip(z, -1.0, 1.0)))
    lon = np.rad2deg(phi) % 360.0
    return lat, lon


# ---------------------------------------------------------------------------
# Neighbor padding as a precomputed gather
# ---------------------------------------------------------------------------

# Each symbolic "face" is a pair (idx, w): idx int64 [h, w, 2], w float64
# [h, w, 2].  A value is w[...,0]*flat[idx[...,0]] + w[...,1]*flat[idx[...,1]].

_Face = tuple[np.ndarray, np.ndarray]


def _plain_face(f: int, nside: int) -> _Face:
    base = np.arange(nside * nside, dtype=np.int64).reshape(nside, nside)
    idx = np.zeros((nside, nside, 2), np.int64)
    w = np.zeros((nside, nside, 2), np.float64)
    idx[..., 0] = f * nside * nside + base
    w[..., 0] = 1.0
    return idx, w


def _rot90(face: _Face, k: int) -> _Face:
    idx, w = face
    return np.rot90(idx, k, (0, 1)), np.rot90(w, k, (0, 1))


def _cat(faces: list[_Face], axis: int) -> _Face:
    return (
        np.concatenate([f[0] for f in faces], axis),
        np.concatenate([f[1] for f in faces], axis),
    )


def _sl(face: _Face, ys: slice, xs: slice) -> _Face:
    idx, w = face
    return idx[ys, xs], w[ys, xs]


def _single(face: _Face, y: int, x: int) -> tuple[int, float]:
    """Read the (single-source) pixel (y, x) of an unpadded face."""
    idx, w = face
    assert w[y, x, 1] == 0.0, "corner synthesis expects single-source faces"
    return int(idx[y, x, 0]), float(w[y, x, 0])


def _tl_corner(t: _Face, l: _Face, p: int) -> _Face:
    """Synthesized top-left corner; reference `utils/healpix.py:316-343`."""
    idx = np.zeros((p, p, 2), np.int64)
    w = np.zeros((p, p, 2), np.float64)
    ti, tw = t
    li, lw = l
    # Bottom-right point: 0.5*t[-1, 0] + 0.5*l[0, -1]
    idx[-1, -1] = (ti[-1, 0, 0], li[0, -1, 0])
    w[-1, -1] = (0.5 * tw[-1, 0, 0], 0.5 * lw[0, -1, 0])
    for i in range(1, p):
        # Above the diagonal: from t;  below: from l;  diagonal: averaged.
        idx[-i - 1, -i:] = ti[-i - 1, :i]
        w[-i - 1, -i:] = tw[-i - 1, :i]
        idx[-i:, -i - 1] = li[:i, -i - 1]
        w[-i:, -i - 1] = lw[:i, -i - 1]
        idx[-i - 1, -i - 1] = (ti[-i - 1, 0, 0], li[0, -i - 1, 0])
        w[-i - 1, -i - 1] = (0.5 * tw[-i - 1, 0, 0], 0.5 * lw[0, -i - 1, 0])
    return idx, w


def _br_corner(b: _Face, r: _Face, p: int) -> _Face:
    """Synthesized bottom-right corner; reference `utils/healpix.py:345-368`."""
    idx = np.zeros((p, p, 2), np.int64)
    w = np.zeros((p, p, 2), np.float64)
    bi, bw = b
    ri, rw = r
    idx[0, 0] = (bi[0, -1, 0], ri[-1, 0, 0])
    w[0, 0] = (0.5 * bw[0, -1, 0], 0.5 * rw[-1, 0, 0])
    for i in range(1, p):
        idx[:i, i] = ri[-i:, i]
        w[:i, i] = rw[-i:, i]
        idx[i, :i] = bi[i, -i:]
        w[i, :i] = bw[i, -i:]
        idx[i, i] = (bi[i, -1, 0], ri[-1, i, 0])
        w[i, i] = (0.5 * bw[i, -1, 0], 0.5 * rw[-1, i, 0])
    return idx, w


def _pad_north(p, c, t, tl, l, bl, b, br, r, tr):
    """North-hemisphere face assembly; reference `utils/healpix.py:232-258`."""
    c2 = _cat([_sl(_rot90(t, 1), slice(-p, None), slice(None)), c,
               _sl(b, slice(None, p), slice(None))], 0)
    left = _cat([
        _sl(_rot90(tl, 2), slice(-p, None), slice(-p, None)),
        _sl(_rot90(l, -1), slice(None), slice(-p, None)),
        _sl(bl, slice(None, p), slice(-p, None)),
    ], 0)
    right = _cat([
        _sl(tr, slice(-p, None), slice(None, p)),
        _sl(r, slice(None), slice(None, p)),
        _sl(br, slice(None, p), slice(None, p)),
    ], 0)
    return _cat([left, c2, right], 1)


def _pad_equator(p, c, t, tl, l, bl, b, br, r, tr):
    """Equatorial face assembly; reference `utils/healpix.py:260-285`."""
    c2 = _cat([_sl(t, slice(-p, None), slice(None)), c,
               _sl(b, slice(None, p), slice(None))], 0)
    left = _cat([
        _sl(tl, slice(-p, None), slice(-p, None)),
        _sl(l, slice(None), slice(-p, None)),
        _sl(bl, slice(None, p), slice(-p, None)),
    ], 0)
    right = _cat([
        _sl(tr, slice(-p, None), slice(None, p)),
        _sl(r, slice(None), slice(None, p)),
        _sl(br, slice(None, p), slice(None, p)),
    ], 0)
    return _cat([left, c2, right], 1)


def _pad_south(p, c, t, tl, l, bl, b, br, r, tr):
    """South-hemisphere face assembly; reference `utils/healpix.py:287-313`."""
    c2 = _cat([_sl(t, slice(-p, None), slice(None)), c,
               _sl(_rot90(b, 1), slice(None, p), slice(None))], 0)
    left = _cat([
        _sl(tl, slice(-p, None), slice(-p, None)),
        _sl(l, slice(None), slice(-p, None)),
        _sl(bl, slice(None, p), slice(-p, None)),
    ], 0)
    right = _cat([
        _sl(tr, slice(-p, None), slice(None, p)),
        _sl(_rot90(r, -1), slice(None), slice(None, p)),
        _sl(_rot90(br, 2), slice(None, p), slice(None, p)),
    ], 0)
    return _cat([left, c2, right], 1)


@functools.lru_cache(maxsize=None)
def build_pad_indices(nside: int, padding: int) -> tuple[np.ndarray, np.ndarray]:
    """Precompute HEALPix neighbor-padding gather tables.

    Returns (idx, w): int32 [12, H+2p, W+2p, 2] flat source indices into the
    [12*H*W] field, and float32 weights.  Runtime padding is then
    `(field.reshape(..., -1)[..., idx] * w).sum(-1)`.

    Neighbor topology per face (reference `utils/healpix.py:204-230`).
    """
    p = padding
    if not isinstance(p, int) or p < 1:
        raise ValueError(f"invalid padding {padding!r}, expected int > 0")
    if p > nside:
        raise ValueError(f"padding {p} exceeds nside {nside}")
    F = [_plain_face(i, nside) for i in range(12)]
    tl, br = functools.partial(_tl_corner, p=p), functools.partial(_br_corner, p=p)

    padded = [
        # North faces (t, tl, l, bl, b, br, r, tr)
        _pad_north(p, F[0], F[1], F[2], F[3], F[3], F[4], F[8], F[5], F[1]),
        _pad_north(p, F[1], F[2], F[3], F[0], F[0], F[5], F[9], F[6], F[2]),
        _pad_north(p, F[2], F[3], F[0], F[1], F[1], F[6], F[10], F[7], F[3]),
        _pad_north(p, F[3], F[0], F[1], F[2], F[2], F[7], F[11], F[4], F[0]),
        # Equatorial faces
        _pad_equator(p, F[4], F[0], tl(F[0], F[3]), F[3], F[7], F[11],
                     br(F[11], F[8]), F[8], F[5]),
        _pad_equator(p, F[5], F[1], tl(F[1], F[0]), F[0], F[4], F[8],
                     br(F[8], F[9]), F[9], F[6]),
        _pad_equator(p, F[6], F[2], tl(F[2], F[1]), F[1], F[5], F[9],
                     br(F[9], F[10]), F[10], F[7]),
        _pad_equator(p, F[7], F[3], tl(F[3], F[2]), F[2], F[6], F[10],
                     br(F[10], F[11]), F[11], F[4]),
        # South faces
        _pad_south(p, F[8], F[5], F[0], F[4], F[11], F[11], F[10], F[9], F[9]),
        _pad_south(p, F[9], F[6], F[1], F[5], F[8], F[8], F[11], F[10], F[10]),
        _pad_south(p, F[10], F[7], F[2], F[6], F[9], F[9], F[8], F[11], F[11]),
        _pad_south(p, F[11], F[4], F[3], F[7], F[10], F[10], F[9], F[8], F[8]),
    ]
    idx = np.stack([f[0] for f in padded]).astype(np.int32)
    w = np.stack([f[1] for f in padded]).astype(np.float32)
    return idx, w
