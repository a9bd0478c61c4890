// Small-window attention on the fused-qkv layout, forward and backward,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels behind `_tm_impl` / `_tm_bwd` (token-major) and
// `_tm5_impl` / `_tm5_bwd` (5D field) in dlwpbench_tpu/ops/pallas_attention.py,
// whose shared head loops are `_tm_heads_fwd` and `_tm_heads_bwd`.  For
// every member window (b, l, w) and head h, with scale = hd^-1/2:
//
//     q, k, v  = columns h*hd, C + h*hd, 2C + h*hd of the window's [N, 3C] rows
//     s[k, q]  = k . q * scale + bias[w or 0, h, k, q] + mask[l or 0, w or 0, k, q]
//     p        = softmax over k;  out[q] = sum_k p v;  lse[q] = max + log sum
//
// bias is KEY-major [bW, nh, Nk, Nq] (bW = nW, or 1 for a bias shared by
// every window); mask is [mL, mW, N, N] with leading dims of 1 broadcast
// (the wrapper passes zeros for "no mask"), and must be symmetric: the
// group-id shift masks of Swin and Pangu are.  Backward, with
// drow[q] = sum(dout * out):
//
//     ds = p * (dp - drow),  dq = scale * ds k,  dk = ds^T (q * scale),
//     dv = p^T dout,         dbias[w] = sum of ds over (b, l), and over the
//                            windows too when the bias is shared
//
// dq, dk, dv are written into the same [.., 3C] layout as qkv.
//
// The two layouts differ only in where token n of member (b, l, w) lives,
// so every kernel is written once and takes the addressing as a template
// parameter (`TokenMajor`, `Field5D`):
//  - token-major: qkv[b, l, w, n, :] of a [B, L, nW, N, 3C] tensor;
//  - 5D: qkv5[b, ipl*wpl + r/wlat, ilat*wlat + r%wlat, l*wlon + n%wlon, :]
//    of the padded field [B, Pl, Lat, Lon, 3C], with r = n / wlon,
//    ipl = w / nLat, ilat = w % nLat and L = nLon: the token order of
//    `window_partition_3d`, so the partition and its reverse never run.
// lse is [B, L, nW, nh, N] in both (L = nLon for 5D).
//
// Design, simple and right first.  A thread owns one query (or key) row of
// the head, or 1/2 or 1/4 of it for head dims up to 64 or 128 (the parts
// sum their partial dot products with warp shuffles).  A block holds up to
// 128 rows; K, V (or Q, dO) tiles of 64 rows and the tile's bias + mask
// block are staged in shared memory as fp32, the tile's token addresses
// computed once per row (a 5D address takes several integer divisions)
// and the rows copied 4 elements at a time.  Key-major bias means a fixed
// key's values for consecutive queries are contiguous, so the staging reads
// are coalesced.  Every tile loop takes the place of the Pallas grid's
// sequential axis.
//  forward   one block per (member, query tile, head), online softmax over
//            key tiles of 64, 16 keys per rescale;
//  backward  four launches, no floating-point atomics, every sum in a fixed
//            order, so two calls give bit-identical results:
//   1. dQ (and drow = rowsum(dout * out) into scratch): block per
//      (member, query tile, head), walking the key tiles;
//   2. dbias partials: block per (query tile x key tile, head, bias window
//      x member chunk); it walks its chunk of the members that share the
//      bias window in order and sums their ds blocks in shared memory;
//   3. the partials summed over the chunks in order, into dbias;
//   4. dK + dV: block per (member, key tile, head), walking the query tiles.
// A design that keeps each member's [N, N] ds tile in shared memory does
// not fit above N of about 230; these passes take any N up to 1023 with
// one code path, at the price of recomputing s and dp in each pass.
//
// What bounds it on an H100 SXM: at Pangu's stage 1 (6,912 window-heads,
// N 144, hd 32) the forward does 4 M N^2 hd = 18.3 GFLOP on about 0.5 GB of
// fp32 operands: 35 operations per byte, above the fp32 ridge of 20, so
// fp32 operations bound it (0.27 ms at 67 TFLOP/s); the backward's five
// products 46 GFLOP (0.68 ms).  The products run on the fp32 CUDA cores;
// tensor cores (wgmma) and TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // threads per block at most
constexpr int kMaxRows = 128;     // rows per block at most
constexpr int kTile = 64;         // rows per shared-memory tile
constexpr int kChunk = 16;        // keys per online-softmax update (forward)
constexpr int kPitch = kTile + 1; // +1: conflict-free row-wise access

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// How a row of D head dims is split over threads: TPR threads per row,
// DPT dims each.
template <int D>
struct Split {
  static constexpr int TPR = D <= 32 ? 1 : (D <= 64 ? 2 : 4);
  static constexpr int DPT = D / TPR;
  static_assert(DPT % 2 == 0, "head-dim slice must be float2 aligned");
};

// Shapes of one call.  Members are m = (b * L + l) * nW + w.
struct Geom {
  int B, L, nW, N, nh;
  int bW, mL, mW;                      // bias / mask leading dims
  int Pl, Lat, Lon, wpl, wlat, wlon;   // 5D field (Field5D only)
  int rows;                            // rows per block
  int n_tiles;                         // ceil(N / rows)
  float scale;
};

struct TokenMajor {
  __device__ static size_t row(const Geom& g, int b, int l, int w, int n) {
    return ((static_cast<size_t>(b) * g.L + l) * g.nW + w) * g.N + n;
  }
};

struct Field5D {
  __device__ static size_t row(const Geom& g, int b, int l, int w, int n) {
    const int nLat = g.Lat / g.wlat;
    const int r = n / g.wlon;
    const int pl = (w / nLat) * g.wpl + r / g.wlat;
    const int lat = (w % nLat) * g.wlat + r % g.wlat;
    const int lon = l * g.wlon + n % g.wlon;
    return ((static_cast<size_t>(b) * g.Pl + pl) * g.Lat + lat) * g.Lon + lon;
  }
};

struct Member {
  int b, l, w;
  __device__ Member(const Geom& g, int m)
      : b(m / (g.nW * g.L)), l((m / g.nW) % g.L), w(m % g.nW) {}
};

template <typename T>
__device__ __forceinline__ const T* bias_ptr(const T* bias, const Geom& g,
                                             int w, int h) {
  return bias + (static_cast<size_t>(g.bW > 1 ? w : 0) * g.nh + h) * g.N * g.N;
}

template <typename T>
__device__ __forceinline__ const T* mask_ptr(const T* mask, const Geom& g,
                                             int l, int w) {
  return mask + (static_cast<size_t>(g.mL > 1 ? l : 0) * g.mW +
                 (g.mW > 1 ? w : 0)) * g.N * g.N;
}

// a . s[0:DPT], s in shared memory (a broadcast read across the block)
template <int DPT>
__device__ __forceinline__ float dot_s(const float (&a)[DPT], const float* s) {
  float acc = 0.f;
  if constexpr (DPT % 4 == 0) {
#pragma unroll
    for (int d = 0; d < DPT; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(s + d);
      acc = fmaf(a[d], x.x, acc);
      acc = fmaf(a[d + 1], x.y, acc);
      acc = fmaf(a[d + 2], x.z, acc);
      acc = fmaf(a[d + 3], x.w, acc);
    }
  } else {
#pragma unroll
    for (int d = 0; d < DPT; d += 2) {
      const float2 x = *reinterpret_cast<const float2*>(s + d);
      acc = fmaf(a[d], x.x, acc);
      acc = fmaf(a[d + 1], x.y, acc);
    }
  }
  return acc;
}

// acc[0:DPT] += c * s[0:DPT], s in shared memory
template <int DPT>
__device__ __forceinline__ void axpy_s(float (&acc)[DPT], float c, const float* s) {
  if constexpr (DPT % 4 == 0) {
#pragma unroll
    for (int d = 0; d < DPT; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(s + d);
      acc[d] = fmaf(c, x.x, acc[d]);
      acc[d + 1] = fmaf(c, x.y, acc[d + 1]);
      acc[d + 2] = fmaf(c, x.z, acc[d + 2]);
      acc[d + 3] = fmaf(c, x.w, acc[d + 3]);
    }
  } else {
#pragma unroll
    for (int d = 0; d < DPT; d += 2) {
      const float2 x = *reinterpret_cast<const float2*>(s + d);
      acc[d] = fmaf(c, x.x, acc[d]);
      acc[d + 1] = fmaf(c, x.y, acc[d + 1]);
    }
  }
}

// Sum over the TPR adjacent lanes that share a row; every lane of the warp
// calls it the same number of times (blocks are whole warps).
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int DPT>
__device__ __forceinline__ void load_row(float (&r)[DPT], const T* p, bool ok,
                                         float mul) {
#pragma unroll
  for (int d = 0; d < DPT; ++d) r[d] = ok ? load_f(p + d) * mul : 0.f;
}

// 4 consecutive elements as fp32: one 16-byte (fp32) or 8-byte (bf16) load.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Stages tokens [row0, row0 + n) of member `mb` for one head: columns
// a_col .. a_col + D of operand a (row stride a_stride, times a_mul) into
// a_s[kTile][D] and columns b_col .. of operand b into b_s[kTile][D], as
// fp32, zero-filling rows n .. kTile-1.  The tokens' addresses are computed
// once per row into off_s; the copies go 4 elements at a time (the wrapper
// guarantees 16-byte aligned tensors, and strides and columns are
// multiples of 8).  Contains a __syncthreads().
template <typename T, int D, typename Layout>
__device__ __forceinline__ void stage_pair(float* a_s, const T* a, int a_stride,
                                           int a_col, float a_mul, float* b_s,
                                           const T* b, int b_stride, int b_col,
                                           size_t* off_s, const Geom& g,
                                           const Member& mb, int row0, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    off_s[j] = Layout::row(g, mb.b, mb.l, mb.w, row0 + j);
  }
  __syncthreads();
  constexpr int V = D / 4;
  for (int i = threadIdx.x; i < kTile * V; i += blockDim.x) {
    const int j = i / V;
    const int c = (i % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 y = x;
    if (j < n) {
      x = load4(a + off_s[j] * a_stride + a_col + c);
      y = load4(b + off_s[j] * b_stride + b_col + c);
      x.x *= a_mul;
      x.y *= a_mul;
      x.z *= a_mul;
      x.w *= a_mul;
    }
    *reinterpret_cast<float4*>(a_s + j * D + c) = x;
    *reinterpret_cast<float4*>(b_s + j * D + c) = y;
  }
}

// Stages bias + mask for keys [k0, k0 + kn) and queries [q0, q0 + qn) as
// dst[key - k0][query - q0] (pitch R), zero outside.
template <typename T>
__device__ __forceinline__ void stage_bias(float* dst, const T* bp, const T* mp,
                                           int N, int R, int k0, int kn,
                                           int q0, int qn) {
  for (int i = threadIdx.x; i < kTile * R; i += blockDim.x) {
    const int j = i / R;
    const int r = i % R;
    const size_t o = static_cast<size_t>(k0 + j) * N + q0 + r;
    dst[i] = (j < kn && r < qn) ? load_f(bp + o) + load_f(mp + o) : 0.f;
  }
}

// ---------------------------------------------------------------- forward
// Grid (members, query tiles, heads).
template <typename T, int D, typename Layout>
__global__ void __launch_bounds__(kMaxThreads)
wa_fwd_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
              const T* __restrict__ mask, T* __restrict__ out,
              float* __restrict__ lse, Geom g) {
  constexpr int TPR = Split<D>::TPR, DPT = Split<D>::DPT;
  extern __shared__ float4 smem4[];
  const int R = g.rows;
  float* k_s = reinterpret_cast<float*>(smem4);  // [kTile][D]
  float* v_s = k_s + kTile * D;                  // [kTile][D]
  float* b_s = v_s + kTile * D;                  // [kTile][R]: bias + mask
  __shared__ size_t off_s[kTile];                // the tile's token rows

  const int m = blockIdx.x;
  const Member mb(g, m);
  const int h = blockIdx.z;
  const int N = g.N;
  const int C = g.nh * D;
  const int r = threadIdx.x / TPR;
  const int d0 = (threadIdx.x % TPR) * DPT;
  const int row0 = blockIdx.y * R;
  const int qi = row0 + r;
  const bool ok = r < R && qi < N;
  const int rc = ok ? r : 0;  // clamped shared-memory column
  const int qn = min(R, N - row0);
  const T* bp = bias_ptr(bias, g, mb.w, h);
  const T* mp = mask_ptr(mask, g, mb.l, mb.w);

  float qr[DPT], acc[DPT];
  const size_t qrow = ok ? Layout::row(g, mb.b, mb.l, mb.w, qi) : 0;
  load_row<T, DPT>(qr, qkv + qrow * 3 * C + h * D + d0, ok, g.scale);
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  float mx = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    const int kn = min(kTile, N - k0);
    __syncthreads();  // the previous tile is consumed
    stage_pair<T, D, Layout>(k_s, qkv, 3 * C, C + h * D, 1.f, v_s, qkv, 3 * C,
                             2 * C + h * D, off_s, g, mb, k0, kn);
    stage_bias(b_s, bp, mp, N, R, k0, kn, row0, qn);
    __syncthreads();

    for (int c0 = 0; c0 < kn; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int kk = c0 + j;
        // keys past kn are zero-filled rows: finite dot, score -inf
        const float dot = row_sum<TPR>(dot_s<DPT>(qr, k_s + kk * D + d0));
        const float sv = kk < kn ? dot + b_s[kk * R + rc] : -INFINITY;
        s[j] = sv;
        cmax = fmaxf(cmax, sv);
      }
      // every chunk holds a real key, so m_new is finite
      const float m_new = fmaxf(mx, cmax);
      const float alpha = expf(mx - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
        axpy_s<DPT>(acc, p, v_s + (c0 + j) * D + d0);
      }
      mx = m_new;
    }
  }

  if (ok) {
    const float inv_l = 1.f / l;
    T* op = out + qrow * C + h * D + d0;
#pragma unroll
    for (int d = 0; d < DPT; ++d) store_f(op + d, acc[d] * inv_l);
    if (d0 == 0) lse[(static_cast<size_t>(m) * g.nh + h) * N + qi] = mx + logf(l);
  }
}

// ---------------------------------------------------------------- backward 1
// dQ, and drow = rowsum(dout * out) into scratch.  Grid (members, query
// tiles, heads).
template <typename T, int D, typename Layout>
__global__ void __launch_bounds__(kMaxThreads)
wa_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                 const T* __restrict__ mask, const T* __restrict__ out,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ drow, T* __restrict__ dqkv, Geom g) {
  constexpr int TPR = Split<D>::TPR, DPT = Split<D>::DPT;
  extern __shared__ float4 smem4[];
  const int R = g.rows;
  float* k_s = reinterpret_cast<float*>(smem4);  // [kTile][D]
  float* v_s = k_s + kTile * D;                  // [kTile][D]
  float* b_s = v_s + kTile * D;                  // [kTile][R]
  __shared__ size_t off_s[kTile];

  const int m = blockIdx.x;
  const Member mb(g, m);
  const int h = blockIdx.z;
  const int N = g.N;
  const int C = g.nh * D;
  const int r = threadIdx.x / TPR;
  const int d0 = (threadIdx.x % TPR) * DPT;
  const int row0 = blockIdx.y * R;
  const int qi = row0 + r;
  const bool ok = r < R && qi < N;
  const int rc = ok ? r : 0;
  const int qn = min(R, N - row0);
  const T* bp = bias_ptr(bias, g, mb.w, h);
  const T* mp = mask_ptr(mask, g, mb.l, mb.w);

  const size_t qrow = ok ? Layout::row(g, mb.b, mb.l, mb.w, qi) : 0;
  float qr[DPT], dor[DPT], dqa[DPT];
  load_row<T, DPT>(qr, qkv + qrow * 3 * C + h * D + d0, ok, g.scale);
  load_row<T, DPT>(dor, dout + qrow * C + h * D + d0, ok, 1.f);
  load_row<T, DPT>(dqa, out + qrow * C + h * D + d0, ok, 1.f);
  float part = 0.f;
#pragma unroll
  for (int d = 0; d < DPT; ++d) {
    part = fmaf(dor[d], dqa[d], part);
    dqa[d] = 0.f;
  }
  const float drow_r = row_sum<TPR>(part);
  const size_t li = (static_cast<size_t>(m) * g.nh + h) * N + qi;
  const float lse_r = ok ? lse[li] : 0.f;
  if (ok && d0 == 0) drow[li] = drow_r;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    const int kn = min(kTile, N - k0);
    __syncthreads();
    stage_pair<T, D, Layout>(k_s, qkv, 3 * C, C + h * D, 1.f, v_s, qkv, 3 * C,
                             2 * C + h * D, off_s, g, mb, k0, kn);
    stage_bias(b_s, bp, mp, N, R, k0, kn, row0, qn);
    __syncthreads();

    for (int j = 0; j < kn; ++j) {
      const float* kj = k_s + j * D + d0;
      const float s = row_sum<TPR>(dot_s<DPT>(qr, kj)) + b_s[j * R + rc];
      const float p = expf(s - lse_r);
      const float dp = row_sum<TPR>(dot_s<DPT>(dor, v_s + j * D + d0));
      axpy_s<DPT>(dqa, p * (dp - drow_r), kj);
    }
  }

  if (ok) {
    T* dqp = dqkv + qrow * 3 * C + h * D + d0;
#pragma unroll
    for (int d = 0; d < DPT; ++d) store_f(dqp + d, dqa[d] * g.scale);
  }
}

// ---------------------------------------------------------------- backward 2
// dbias partials.  Grid (query tiles x key tiles, heads, bW x n_chunks).
// The members sharing bias window wb are (b, l) with w = wb when bW > 1,
// and every (b, l, w) when the bias is shared; chunk c takes the members
// [c * per, (c + 1) * per) in order.  part is [n_chunks, bW, nh, N, N]
// fp32, key-major like the bias.
template <typename T, int D, typename Layout>
__global__ void __launch_bounds__(kMaxThreads)
wa_bwd_dbias_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                    const T* __restrict__ mask, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ drow,
                    float* __restrict__ part, Geom g, int n_chunks) {
  constexpr int TPR = Split<D>::TPR, DPT = Split<D>::DPT;
  extern __shared__ float4 smem4[];
  const int R = g.rows;
  float* k_s = reinterpret_cast<float*>(smem4);  // [kTile][D]
  float* v_s = k_s + kTile * D;                  // [kTile][D]
  float* b_s = v_s + kTile * D;                  // [kTile][R]
  __shared__ size_t off_s[kTile];
  float* a_s = b_s + kTile * R;                  // [R][kPitch]: sum of ds

  const int N = g.N;
  const int C = g.nh * D;
  const int row0 = (blockIdx.x % g.n_tiles) * R;
  const int k0 = (blockIdx.x / g.n_tiles) * kTile;
  const int kn = min(kTile, N - k0);
  const int qn = min(R, N - row0);
  const int h = blockIdx.y;
  const int wb = blockIdx.z / n_chunks;
  const int c = blockIdx.z % n_chunks;
  const int r = threadIdx.x / TPR;
  const int d0 = (threadIdx.x % TPR) * DPT;
  const int qi = row0 + r;
  const bool ok = r < R && qi < N;
  const int rc = ok ? r : 0;

  const int n_members = g.bW > 1 ? g.B * g.L : g.B * g.L * g.nW;
  const int per = (n_members + n_chunks - 1) / n_chunks;
  const int t_end = min(n_members, (c + 1) * per);

  for (int i = threadIdx.x; i < R * kPitch; i += blockDim.x) a_s[i] = 0.f;

  for (int t = c * per; t < t_end; ++t) {
    // member index m = (b * L + l) * nW + w
    const int m = g.bW > 1 ? t * g.nW + wb : t;
    const Member mb(g, m);
    __syncthreads();  // the previous member's tiles are consumed
    stage_pair<T, D, Layout>(k_s, qkv, 3 * C, C + h * D, 1.f, v_s, qkv, 3 * C,
                             2 * C + h * D, off_s, g, mb, k0, kn);
    stage_bias(b_s, bias_ptr(bias, g, mb.w, h), mask_ptr(mask, g, mb.l, mb.w),
               N, R, k0, kn, row0, qn);
    const size_t qrow = ok ? Layout::row(g, mb.b, mb.l, mb.w, qi) : 0;
    float qr[DPT], dor[DPT];
    load_row<T, DPT>(qr, qkv + qrow * 3 * C + h * D + d0, ok, g.scale);
    load_row<T, DPT>(dor, dout + qrow * C + h * D + d0, ok, 1.f);
    const size_t li = (static_cast<size_t>(m) * g.nh + h) * N + qi;
    const float lse_r = ok ? lse[li] : 0.f;
    const float drow_r = ok ? drow[li] : 0.f;
    __syncthreads();

    for (int j = 0; j < kn; ++j) {
      const float s = row_sum<TPR>(dot_s<DPT>(qr, k_s + j * D + d0)) +
                      b_s[j * R + rc];
      const float p = expf(s - lse_r);
      const float dp = row_sum<TPR>(dot_s<DPT>(dor, v_s + j * D + d0));
      if (ok && d0 == 0) a_s[r * kPitch + j] += p * (dp - drow_r);
    }
  }
  __syncthreads();

  float* pp = part + ((static_cast<size_t>(c) * g.bW + wb) * g.nh + h) * N * N;
  for (int i = threadIdx.x; i < kn * R; i += blockDim.x) {
    const int j = i / R;
    const int rr = i % R;
    if (rr < qn) pp[static_cast<size_t>(k0 + j) * N + row0 + rr] = a_s[rr * kPitch + j];
  }
}

// ---------------------------------------------------------------- backward 3
// dbias = sum over the chunks of part, in chunk order.
template <typename T>
__global__ void wa_bwd_dbias_sum_kernel(const float* __restrict__ part,
                                        T* __restrict__ dbias, size_t n,
                                        int n_chunks) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) acc += part[c * n + i];
    store_f(dbias + i, acc);
  }
}

// ---------------------------------------------------------------- backward 4
// dK + dV.  Grid (members, key tiles, heads).
template <typename T, int D, typename Layout>
__global__ void __launch_bounds__(kMaxThreads)
wa_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                  const T* __restrict__ mask, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ drow,
                  T* __restrict__ dqkv, Geom g) {
  constexpr int TPR = Split<D>::TPR, DPT = Split<D>::DPT;
  extern __shared__ float4 smem4[];
  const int R = g.rows;
  float* q_s = reinterpret_cast<float*>(smem4);  // [kTile][D], times scale
  float* do_s = q_s + kTile * D;                 // [kTile][D]
  float* lse_s = do_s + kTile * D;               // [kTile]
  float* drow_s = lse_s + kTile;                 // [kTile]
  float* b_s = drow_s + kTile;                   // [query][key - key0], pitch R
  __shared__ size_t off_s[kTile];

  const int m = blockIdx.x;
  const Member mb(g, m);
  const int h = blockIdx.z;
  const int N = g.N;
  const int C = g.nh * D;
  const int r = threadIdx.x / TPR;
  const int d0 = (threadIdx.x % TPR) * DPT;
  const int key0 = blockIdx.y * R;
  const int ki = key0 + r;
  const bool ok = r < R && ki < N;
  const int rc = ok ? r : 0;
  const int kn = min(R, N - key0);
  const T* bp = bias_ptr(bias, g, mb.w, h);
  const T* mp = mask_ptr(mask, g, mb.l, mb.w);
  const size_t lbase = (static_cast<size_t>(m) * g.nh + h) * N;

  const size_t krow = ok ? Layout::row(g, mb.b, mb.l, mb.w, ki) : 0;
  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
  load_row<T, DPT>(kr, qkv + krow * 3 * C + C + h * D + d0, ok, 1.f);
  load_row<T, DPT>(vr, qkv + krow * 3 * C + 2 * C + h * D + d0, ok, 1.f);
#pragma unroll
  for (int d = 0; d < DPT; ++d) dka[d] = dva[d] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kTile) {
    const int qn = min(kTile, N - q0);
    __syncthreads();
    stage_pair<T, D, Layout>(q_s, qkv, 3 * C, h * D, g.scale, do_s, dout, C, h * D,
                             off_s, g, mb, q0, qn);
    for (int i = threadIdx.x; i < qn; i += blockDim.x) {
      lse_s[i] = lse[lbase + q0 + i];
      drow_s[i] = drow[lbase + q0 + i];
    }
    // bias[key][query]: consecutive i walk the queries of one key
    for (int i = threadIdx.x; i < kTile * R; i += blockDim.x) {
      const int rr = i / kTile;
      const int j = i % kTile;
      const size_t o = static_cast<size_t>(key0 + rr) * N + q0 + j;
      b_s[j * R + rr] = (rr < kn && j < qn) ? load_f(bp + o) + load_f(mp + o) : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < qn; ++j) {
      const float* qj = q_s + j * D + d0;
      const float* doj = do_s + j * D + d0;
      const float s = row_sum<TPR>(dot_s<DPT>(kr, qj)) + b_s[j * R + rc];
      const float p = expf(s - lse_s[j]);
      axpy_s<DPT>(dva, p, doj);
      const float dp = row_sum<TPR>(dot_s<DPT>(vr, doj));
      axpy_s<DPT>(dka, p * (dp - drow_s[j]), qj);  // q carries `scale`
    }
  }

  if (ok) {
    T* dkp = dqkv + krow * 3 * C + C + h * D + d0;
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      store_f(dkp + d, dka[d]);
      store_f(dkp + C + d, dva[d]);
    }
  }
}

// ---------------------------------------------------------------- launch
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Rows per block and the block's threads (whole warps).
template <int D>
void plan_rows(Geom& g, int& threads) {
  constexpr int TPR = Split<D>::TPR;
  const int rmax = kMaxRows < kMaxThreads / TPR ? kMaxRows : kMaxThreads / TPR;
  g.n_tiles = (g.N + rmax - 1) / rmax;
  g.rows = (g.N + g.n_tiles - 1) / g.n_tiles;
  threads = (g.rows * TPR + 31) / 32 * 32;
  g.scale = 1.f / sqrtf(static_cast<float>(D));
}

template <typename T, int D, typename Layout>
cudaError_t launch_fwd(const void* qkv, const void* bias, const void* mask,
                       void* out, void* lse, Geom g, cudaStream_t stream) {
  int threads;
  plan_rows<D>(g, threads);
  const size_t smem = sizeof(float) * (2 * kTile * D + kTile * g.rows);
  auto kernel = wa_fwd_kernel<T, D, Layout>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int members = g.B * g.L * g.nW;
  kernel<<<dim3(members, g.n_tiles, g.nh), threads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(bias),
      static_cast<const T*>(mask), static_cast<T*>(out),
      static_cast<float*>(lse), g);
  return cudaGetLastError();
}

template <typename T, int D, typename Layout>
cudaError_t launch_bwd(const void* qkv, const void* bias, const void* mask,
                       const void* out, const void* dout, const void* lse,
                       void* dqkv, void* dbias, void* drow, void* part,
                       int n_chunks, Geom g, cudaStream_t stream) {
  int threads;
  plan_rows<D>(g, threads);
  const int members = g.B * g.L * g.nW;
  const int n_key_tiles = (g.N + kTile - 1) / kTile;
  const size_t smem_dq = sizeof(float) * (2 * kTile * D + kTile * g.rows);
  const size_t smem_db = sizeof(float) * (2 * kTile * D + kTile * g.rows + g.rows * kPitch);
  const size_t smem_dkv = sizeof(float) * (2 * kTile * D + 2 * kTile + kTile * g.rows);
  const T* tq = static_cast<const T*>(qkv);
  const T* tb = static_cast<const T*>(bias);
  const T* tm = static_cast<const T*>(mask);
  const T* tdo = static_cast<const T*>(dout);
  const float* tl = static_cast<const float*>(lse);
  float* tr = static_cast<float*>(drow);
  float* tp = static_cast<float*>(part);

  auto k_dq = wa_bwd_dq_kernel<T, D, Layout>;
  auto k_db = wa_bwd_dbias_kernel<T, D, Layout>;
  auto k_dkv = wa_bwd_dkv_kernel<T, D, Layout>;
  cudaError_t err;
  if ((err = allow_smem(k_dq, smem_dq)) != cudaSuccess) return err;
  if ((err = allow_smem(k_db, smem_db)) != cudaSuccess) return err;
  if ((err = allow_smem(k_dkv, smem_dkv)) != cudaSuccess) return err;

  k_dq<<<dim3(members, g.n_tiles, g.nh), threads, smem_dq, stream>>>(
      tq, tb, tm, static_cast<const T*>(out), tdo, tl, tr, static_cast<T*>(dqkv), g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k_db<<<dim3(g.n_tiles * n_key_tiles, g.nh, g.bW * n_chunks), threads, smem_db,
         stream>>>(tq, tb, tm, tdo, tl, tr, tp, g, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t n_bias = static_cast<size_t>(g.bW) * g.nh * g.N * g.N;
  const int sum_blocks = static_cast<int>((n_bias + 255) / 256 < 4096 ? (n_bias + 255) / 256 : 4096);
  wa_bwd_dbias_sum_kernel<T><<<sum_blocks, 256, 0, stream>>>(
      tp, static_cast<T*>(dbias), n_bias, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k_dkv<<<dim3(members, g.n_tiles, g.nh), threads, smem_dkv, stream>>>(
      tq, tb, tm, tdo, tl, tr, static_cast<T*>(dqkv), g);
  return cudaGetLastError();
}

// One switch over the head dims the kernels take (multiples of 8 to 128).
#define WA_HEAD_DIMS(X)                                                   \
  X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(72) X(80) X(88) X(96) \
  X(104) X(112) X(120) X(128)

template <typename T, typename Layout>
cudaError_t dispatch_fwd(int hd, const void* qkv, const void* bias,
                         const void* mask, void* out, void* lse, const Geom& g,
                         cudaStream_t s) {
  switch (hd) {
#define WA_FWD_CASE(DD) \
  case DD:              \
    return launch_fwd<T, DD, Layout>(qkv, bias, mask, out, lse, g, s);
    WA_HEAD_DIMS(WA_FWD_CASE)
#undef WA_FWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename Layout>
cudaError_t dispatch_bwd(int hd, const void* qkv, const void* bias,
                         const void* mask, const void* out, const void* dout,
                         const void* lse, void* dqkv, void* dbias, void* drow,
                         void* part, int n_chunks, const Geom& g,
                         cudaStream_t s) {
  switch (hd) {
#define WA_BWD_CASE(DD)                                                      \
  case DD:                                                                   \
    return launch_bwd<T, DD, Layout>(qkv, bias, mask, out, dout, lse, dqkv,  \
                                     dbias, drow, part, n_chunks, g, s);
    WA_HEAD_DIMS(WA_BWD_CASE)
#undef WA_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// Checks the shapes and fills the geometry; false on a shape the kernels
// do not take.  layout 0: token-major [B, L, nW, N, 3C]; layout 1: the 5D
// field [B, Pl, Lat, Lon, 3C] with window (wpl, wlat, wlon).
bool make_geom(Geom& g, int layout, int B, int L, int nW, int N, int nh,
               int bW, int mL, int mW, int Pl, int Lat, int Lon, int wpl,
               int wlat, int wlon) {
  if (layout == 1) {
    if (wpl <= 0 || wlat <= 0 || wlon <= 0 || Pl % wpl || Lat % wlat ||
        Lon % wlon) {
      return false;
    }
    L = Lon / wlon;
    nW = (Pl / wpl) * (Lat / wlat);
    N = wpl * wlat * wlon;
  } else if (layout != 0) {
    return false;
  }
  if (B <= 0 || L <= 0 || nW <= 0 || N <= 0 || N > 1023 || nh <= 0 ||
      nh > 65535) {
    return false;
  }
  if (!(bW == 1 || bW == nW) || !(mL == 1 || mL == L) || !(mW == 1 || mW == nW)) {
    return false;
  }
  if (static_cast<long long>(B) * L * nW > 2147483647LL) return false;
  g = Geom{B, L, nW, N, nh, bW, mL, mW, Pl, Lat, Lon, wpl, wlat, wlon, 0, 0, 0.f};
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (qkv, bias, mask, out); lse is float32
// [B, L, nW, nh, N].  For layout 0 the field and window arguments are
// ignored; for layout 1 L, nW and N are derived from them.  Launches on
// `stream`, never synchronises, and returns cudaGetLastError() (0 on
// success).
extern "C" int window_attention_qkv_fwd(const void* qkv, const void* bias,
                                        const void* mask, void* out, void* lse,
                                        int B, int L, int nW, int N, int nh,
                                        int hd, int bW, int mL, int mW, int Pl,
                                        int Lat, int Lon, int wpl, int wlat,
                                        int wlon, int layout, int dtype,
                                        void* stream) {
  Geom g;
  if (!make_geom(g, layout, B, L, nW, N, nh, bW, mL, mW, Pl, Lat, Lon, wpl,
                 wlat, wlon)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && layout == 0) {
    err = dispatch_fwd<float, TokenMajor>(hd, qkv, bias, mask, out, lse, g, s);
  } else if (dtype == 0 && layout == 1) {
    err = dispatch_fwd<float, Field5D>(hd, qkv, bias, mask, out, lse, g, s);
  } else if (dtype == 1 && layout == 0) {
    err = dispatch_fwd<__nv_bfloat16, TokenMajor>(hd, qkv, bias, mask, out, lse, g, s);
  } else if (dtype == 1 && layout == 1) {
    err = dispatch_fwd<__nv_bfloat16, Field5D>(hd, qkv, bias, mask, out, lse, g, s);
  }
  return static_cast<int>(err);
}

// The backward of `window_attention_qkv_fwd`: dqkv in qkv's layout and type,
// dbias [bW, nh, N, N] in the bias type.  Scratch from the caller: drow
// float32 shaped like lse, part float32 [n_chunks, bW, nh, N, N].
// n_chunks (>= 1) splits each bias window's members for the dbias pass.
extern "C" int window_attention_qkv_bwd(const void* qkv, const void* bias,
                                        const void* mask, const void* out,
                                        const void* dout, const void* lse,
                                        void* dqkv, void* dbias, void* drow,
                                        void* part, int B, int L, int nW, int N,
                                        int nh, int hd, int bW, int mL, int mW,
                                        int Pl, int Lat, int Lon, int wpl,
                                        int wlat, int wlon, int n_chunks,
                                        int layout, int dtype, void* stream) {
  Geom g;
  if (!make_geom(g, layout, B, L, nW, N, nh, bW, mL, mW, Pl, Lat, Lon, wpl,
                 wlat, wlon) ||
      n_chunks < 1 || n_chunks > 65535 / bW) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && layout == 0) {
    err = dispatch_bwd<float, TokenMajor>(hd, qkv, bias, mask, out, dout, lse,
                                          dqkv, dbias, drow, part, n_chunks, g, s);
  } else if (dtype == 0 && layout == 1) {
    err = dispatch_bwd<float, Field5D>(hd, qkv, bias, mask, out, dout, lse,
                                       dqkv, dbias, drow, part, n_chunks, g, s);
  } else if (dtype == 1 && layout == 0) {
    err = dispatch_bwd<__nv_bfloat16, TokenMajor>(hd, qkv, bias, mask, out, dout,
                                                  lse, dqkv, dbias, drow, part,
                                                  n_chunks, g, s);
  } else if (dtype == 1 && layout == 1) {
    err = dispatch_bwd<__nv_bfloat16, Field5D>(hd, qkv, bias, mask, out, dout,
                                               lse, dqkv, dbias, drow, part,
                                               n_chunks, g, s);
  }
  return static_cast<int>(err);
}
