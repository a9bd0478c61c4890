// Packed small-window attention (Pangu's earth attention on partitioned
// windows), forward and backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels behind `_packed_impl` (forward) and `_packed_bwd`
// (fused backward) in dlwpbench_tpu/ops/pallas_attention.py, whose bodies are
// `_packed_attn_kernel` and `_packed_bwd_kernel`.  For problem p of
// BW = B_ * nW (p = b_ * nW + w, b_ = sample * nLon + lon: the
// `window_partition_3d` batch layout) and head h, with w = p % nW,
// lon = (p / nW) % mL and scale = D^-1/2:
//
//     s[q, k] = q . k * scale + bias[w, h, q, k] + mask[lon, w or 0, q, k]
//     p       = softmax over k;  out[q] = sum_k p v;  lse[q] = max + log sum
//
// q, k, v and out are head-major [BW, nh, N, D]; bias [nW, nh, N, N] and
// mask [mL, mW, N, N] (mW = 1 or nW; a window axis of 1 means index 0) are
// QUERY-major and read as given, so the mask may be any additive mask,
// symmetric or not (the wrapper passes zeros for "no mask").  lse is
// [BW, nh, N] fp32.  Backward, with drow[q] = sum(dout * out):
//
//     ds = p * (dp - drow),  dq = scale * ds k,  dk = ds^T (q * scale),
//     dv = p^T dout,         dbias[w] = sum of ds over the B_ problems
//                            p = t * nW + w, t = 0 .. B_ - 1
//
// Design, simple and right first (the structure of window_attention_qkv.cu,
// on separate head-major q, k, v and query-major bias and mask).  A thread
// owns one query (or key) row of the head, or 1/2 or 1/4 of it for head
// dims up to 64 or 128 (the parts sum their partial dot products with warp
// shuffles).  A block holds up to 128 rows; K, V (or Q, dO) tiles of 64
// rows, contiguous in the head-major layout, are copied 4 elements at a
// time into shared memory as fp32, beside the tile's bias + mask block.
// The query-major bias is read along the keys of one query (coalesced) and
// stored key-major in shared memory with an odd pitch, so the staging
// stores and the compute loop's reads (one query per thread) are free of
// bank conflicts.  Every tile loop takes the place of the Pallas grid's
// sequential axis.
//  forward   two designs, chosen by shape before the launch (the wrapper
//            takes `window_attention.fwd_route`):
//   fused      N <= 144 and hd <= 48 (every Pangu shape): the window
//              kernel's tensor-core forward (`fused_fwd_body`,
//              small_window_common.cuh; the design is described in
//              window_attention_qkv.cu) through `PackedAccess`: one block
//              per (problem, head), one warp per 16 query rows, Q * scale,
//              K and V staged once, S and PV as 3xTF32 `mma.sync`, each
//              query's whole row of scores in registers (no online
//              rescale).  The query-major bias + mask element (key kc,
//              query qr) is read at [qr][kc] as given, so an asymmetric
//              mask is applied as it stands.  Bound at Pangu's stage 1
//              shifted: the bytes, 0.155 ms (0.52 GB at 3.35 TB/s), above
//              18.3 GFLOP at 165 TFLOP/s (3xTF32), 0.11 ms.
//   row        everything else up to N 1023: one block per (problem, query
//              tile, head), online softmax over key tiles of 64, 16 keys
//              per rescale, on the fp32 CUDA cores;
//  backward  two designs, chosen by shape before the launch (the wrapper
//            takes `window_attention.bwd_route`); neither uses
//            floating-point atomics and every sum runs in a fixed order, so
//            two calls give bit-identical results.
//   fused      N <= 144 and hd <= 48 (every Pangu shape): the window
//              kernel's one tensor-core pass per problem
//              (`fused_bwd_body`, small_window_common.cuh; the design is
//              described in window_attention_qkv.cu), through `PackedAccess`
//              below: rows of a (problem, head) are contiguous, the
//              query-major bias + mask element (key kr, query qc) is read
//              at [qc][kr] (the mask may be asymmetric, so the transpose is
//              explicit), and each block's dbias partial is written
//              query-major, which the ordered chunk sum finishes as it
//              stands.  One block per (window type, head, chunk of its
//              problems p = t * nW + w in order of t).
//   four-pass  everything else up to N 1023, four launches:
//   1. dQ (and drow into scratch): block per (problem, query tile, head),
//      walking the key tiles;
//   2. dbias partials: block per (query tile x key tile, head, window type
//      x member chunk); it walks its chunk of the problems of window type w
//      in order and sums their ds blocks in shared memory.  The TPU carries
//      this sum across sequential grid revisits, which Hopper does not
//      have; chunks fill the card, where Pangu has only 36 (w, h) pairs;
//   3. the partials summed over the chunks in order, into dbias;
//   4. dK + dV: block per (problem, key tile, head), walking the query tiles.
// A design that keeps each problem's [N, N] ds tile in shared memory does
// not fit above N of about 230; these passes take any N up to 1023 with
// one code path, at the price of recomputing s and dp in three passes.
//
// What bounds it on an H100 SXM: at Pangu's stage 1 (1,152 problems x 6
// heads, N 144, D 32) the forward does 4 BW nh N^2 D = 18.3 GFLOP on about
// 0.6 GB of fp32 operands: about 30 operations per byte, above the fp32
// ridge of 20, so fp32 operations bound it (0.27 ms at 67 TFLOP/s); the
// backward's five products 46 GFLOP (0.68 ms).  The row forward and the
// four-pass backward run their products on the fp32 CUDA cores; the fused
// designs on the tensor cores as 3xTF32 (the backward's 0.28 ms at 495 / 3
// TFLOP/s, so its bytes, about 1 GB, 0.31 ms, bound it).

#include "small_window_common.cuh"

namespace {

// Shapes of one call.
struct Geom {
  int BW, nh, N, nW;  // problems, heads, tokens, window types (bias)
  int mL, mW;         // mask leading dims: lon groups, window types or 1
  int rows;           // rows per block
  int n_tiles;        // ceil(N / rows)
  float scale;
};

// First row of problem p, head h in a [BW, nh, N, ..] tensor.
__device__ __forceinline__ size_t head_row(const Geom& g, int p, int h) {
  return (static_cast<size_t>(p) * g.nh + h) * g.N;
}

template <typename T>
__device__ __forceinline__ const T* bias_ptr(const T* bias, const Geom& g,
                                             int w, int h) {
  return bias + (static_cast<size_t>(w) * g.nh + h) * g.N * g.N;
}

template <typename T>
__device__ __forceinline__ const T* mask_ptr(const T* mask, const Geom& g,
                                             int p) {
  const int lon = (p / g.nW) % g.mL;
  const int w = g.mW > 1 ? p % g.nW : 0;
  return mask + (static_cast<size_t>(lon) * g.mW + w) * g.N * g.N;
}

// Stages rows [row0, row0 + n) of the [N, D] head block `src` (times mul)
// into dst[kTile][D] as fp32, zero-filling rows n .. kTile-1.  The rows are
// contiguous, copied 4 elements at a time (the wrapper guarantees 16-byte
// aligned tensors, and D is a multiple of 8).
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int row0,
                                           int n, float mul) {
  constexpr int V = D / 4;
  for (int i = threadIdx.x; i < kTile * V; i += blockDim.x) {
    const int j = i / V;
    const int c = (i % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < n) {
      x = load4(src + static_cast<size_t>(row0 + j) * D + c);
      x.x *= mul;
      x.y *= mul;
      x.z *= mul;
      x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + j * D + c) = x;
  }
}

// Stages bias + mask for queries [q0, q0 + qn) and keys [k0, k0 + kn) as
// dst[key - k0][query - q0] with pitch P (odd), zero outside.  Consecutive
// i read consecutive keys of one query row.
template <typename T>
__device__ __forceinline__ void stage_bias_by_key(float* dst, const T* bp,
                                                  const T* mp, int N, int R,
                                                  int P, int q0, int qn,
                                                  int k0, int kn) {
  for (int i = threadIdx.x; i < R * kTile; i += blockDim.x) {
    const int r = i / kTile;
    const int j = i % kTile;
    const size_t o = static_cast<size_t>(q0 + r) * N + k0 + j;
    dst[j * P + r] = (r < qn && j < kn) ? load_f(bp + o) + load_f(mp + o) : 0.f;
  }
}

// ---------------------------------------------------------------- forward
// Grid (problems, query tiles, heads).
template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
pw_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ bias,
              const T* __restrict__ mask, T* __restrict__ out,
              float* __restrict__ lse, Geom g) {
  constexpr int TPR = Split<D>::TPR, DPT = Split<D>::DPT;
  extern __shared__ float4 smem4[];
  const int R = g.rows;
  const int P = R | 1;
  float* k_s = reinterpret_cast<float*>(smem4);  // [kTile][D]
  float* v_s = k_s + kTile * D;                  // [kTile][D]
  float* b_s = v_s + kTile * D;                  // [kTile][P]: bias + mask

  const int p = blockIdx.x;
  const int h = blockIdx.z;
  const int N = g.N;
  const int r = threadIdx.x / TPR;
  const int d0 = (threadIdx.x % TPR) * DPT;
  const int row0 = blockIdx.y * R;
  const int qi = row0 + r;
  const bool ok = r < R && qi < N;
  const int rc = ok ? r : 0;  // clamped shared-memory column
  const int qn = min(R, N - row0);
  const size_t hr = head_row(g, p, h);
  const T* kp = k + hr * D;
  const T* vp = v + hr * D;
  const T* bp = bias_ptr(bias, g, p % g.nW, h);
  const T* mp = mask_ptr(mask, g, p);

  float qr[DPT], acc[DPT];
  load_row<T, DPT>(qr, q + (hr + (ok ? qi : 0)) * D + d0, ok, g.scale);
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  float mx = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    const int kn = min(kTile, N - k0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<T, D>(k_s, kp, k0, kn, 1.f);
    stage_rows<T, D>(v_s, vp, k0, kn, 1.f);
    stage_bias_by_key(b_s, bp, mp, N, R, P, row0, qn, k0, kn);
    __syncthreads();

    for (int c0 = 0; c0 < kn; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int kk = c0 + j;
        // keys past kn are zero-filled rows: finite dot, score -inf
        const float dot = row_sum<TPR>(dot_s<DPT>(qr, k_s + kk * D + d0));
        const float sv = kk < kn ? dot + b_s[kk * P + rc] : -INFINITY;
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
        const float pj = expf(s[j] - m_new);
        l += pj;
        axpy_s<DPT>(acc, pj, v_s + (c0 + j) * D + d0);
      }
      mx = m_new;
    }
  }

  if (ok) {
    const float inv_l = 1.f / l;
    T* op = out + (hr + qi) * D + d0;
#pragma unroll
    for (int d = 0; d < DPT; ++d) store_f(op + d, acc[d] * inv_l);
    if (d0 == 0) lse[hr + qi] = mx + logf(l);
  }
}

// ---------------------------------------------------------------- backward 1
// dQ, and drow = rowsum(dout * out) into scratch.  Grid (problems, query
// tiles, heads).
template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
pw_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ bias,
                 const T* __restrict__ mask, const T* __restrict__ out,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ drow, T* __restrict__ dq, Geom g) {
  constexpr int TPR = Split<D>::TPR, DPT = Split<D>::DPT;
  extern __shared__ float4 smem4[];
  const int R = g.rows;
  const int P = R | 1;
  float* k_s = reinterpret_cast<float*>(smem4);  // [kTile][D]
  float* v_s = k_s + kTile * D;                  // [kTile][D]
  float* b_s = v_s + kTile * D;                  // [kTile][P]

  const int p = blockIdx.x;
  const int h = blockIdx.z;
  const int N = g.N;
  const int r = threadIdx.x / TPR;
  const int d0 = (threadIdx.x % TPR) * DPT;
  const int row0 = blockIdx.y * R;
  const int qi = row0 + r;
  const bool ok = r < R && qi < N;
  const int rc = ok ? r : 0;
  const int qn = min(R, N - row0);
  const size_t hr = head_row(g, p, h);
  const T* kp = k + hr * D;
  const T* vp = v + hr * D;
  const T* bp = bias_ptr(bias, g, p % g.nW, h);
  const T* mp = mask_ptr(mask, g, p);

  const size_t qrow = (hr + (ok ? qi : 0)) * D + d0;
  float qr[DPT], dor[DPT], dqa[DPT];
  load_row<T, DPT>(qr, q + qrow, ok, g.scale);
  load_row<T, DPT>(dor, dout + qrow, ok, 1.f);
  load_row<T, DPT>(dqa, out + qrow, ok, 1.f);
  float part = 0.f;
#pragma unroll
  for (int d = 0; d < DPT; ++d) {
    part = fmaf(dor[d], dqa[d], part);
    dqa[d] = 0.f;
  }
  const float drow_r = row_sum<TPR>(part);
  const float lse_r = ok ? lse[hr + qi] : 0.f;
  if (ok && d0 == 0) drow[hr + qi] = drow_r;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    const int kn = min(kTile, N - k0);
    __syncthreads();
    stage_rows<T, D>(k_s, kp, k0, kn, 1.f);
    stage_rows<T, D>(v_s, vp, k0, kn, 1.f);
    stage_bias_by_key(b_s, bp, mp, N, R, P, row0, qn, k0, kn);
    __syncthreads();

    for (int j = 0; j < kn; ++j) {
      const float* kj = k_s + j * D + d0;
      const float s = row_sum<TPR>(dot_s<DPT>(qr, kj)) + b_s[j * P + rc];
      const float pj = expf(s - lse_r);
      const float dp = row_sum<TPR>(dot_s<DPT>(dor, v_s + j * D + d0));
      axpy_s<DPT>(dqa, pj * (dp - drow_r), kj);
    }
  }

  if (ok) {
    T* dqp = dq + qrow;
#pragma unroll
    for (int d = 0; d < DPT; ++d) store_f(dqp + d, dqa[d] * g.scale);
  }
}

// ---------------------------------------------------------------- backward 2
// dbias partials.  Grid (query tiles x key tiles, heads, nW x n_chunks).
// The problems of window type w are p = t * nW + w, t = 0 .. BW / nW - 1;
// chunk c takes t in [c * per, (c + 1) * per) in order.  part is
// [n_chunks, nW, nh, N, N] fp32, query-major like the bias.
template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
pw_bwd_dbias_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ bias,
                    const T* __restrict__ mask, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ drow,
                    float* __restrict__ part, Geom g, int n_chunks) {
  constexpr int TPR = Split<D>::TPR, DPT = Split<D>::DPT;
  extern __shared__ float4 smem4[];
  const int R = g.rows;
  const int P = R | 1;
  float* k_s = reinterpret_cast<float*>(smem4);  // [kTile][D]
  float* v_s = k_s + kTile * D;                  // [kTile][D]
  float* b_s = v_s + kTile * D;                  // [kTile][P]
  float* a_s = b_s + kTile * P;                  // [R][kPitch]: sum of ds

  const int N = g.N;
  const int row0 = (blockIdx.x % g.n_tiles) * R;
  const int k0 = (blockIdx.x / g.n_tiles) * kTile;
  const int kn = min(kTile, N - k0);
  const int qn = min(R, N - row0);
  const int h = blockIdx.y;
  const int w = blockIdx.z / n_chunks;
  const int c = blockIdx.z % n_chunks;
  const int r = threadIdx.x / TPR;
  const int d0 = (threadIdx.x % TPR) * DPT;
  const int qi = row0 + r;
  const bool ok = r < R && qi < N;
  const int rc = ok ? r : 0;
  const T* bp = bias_ptr(bias, g, w, h);

  const int members = g.BW / g.nW;
  const int per = (members + n_chunks - 1) / n_chunks;
  const int t_end = min(members, (c + 1) * per);

  for (int i = threadIdx.x; i < R * kPitch; i += blockDim.x) a_s[i] = 0.f;

  for (int t = c * per; t < t_end; ++t) {
    const int p = t * g.nW + w;
    const size_t hr = head_row(g, p, h);
    __syncthreads();  // the previous problem's tiles are consumed
    stage_rows<T, D>(k_s, k + hr * D, k0, kn, 1.f);
    stage_rows<T, D>(v_s, v + hr * D, k0, kn, 1.f);
    stage_bias_by_key(b_s, bp, mask_ptr(mask, g, p), N, R, P, row0, qn, k0, kn);
    const size_t qrow = (hr + (ok ? qi : 0)) * D + d0;
    float qr[DPT], dor[DPT];
    load_row<T, DPT>(qr, q + qrow, ok, g.scale);
    load_row<T, DPT>(dor, dout + qrow, ok, 1.f);
    const float lse_r = ok ? lse[hr + qi] : 0.f;
    const float drow_r = ok ? drow[hr + qi] : 0.f;
    __syncthreads();

    for (int j = 0; j < kn; ++j) {
      const float s = row_sum<TPR>(dot_s<DPT>(qr, k_s + j * D + d0)) +
                      b_s[j * P + rc];
      const float pj = expf(s - lse_r);
      const float dp = row_sum<TPR>(dot_s<DPT>(dor, v_s + j * D + d0));
      if (ok && d0 == 0) a_s[r * kPitch + j] += pj * (dp - drow_r);
    }
  }
  __syncthreads();

  float* pp = part + ((static_cast<size_t>(c) * g.nW + w) * g.nh + h) * N * N;
  for (int i = threadIdx.x; i < qn * kn; i += blockDim.x) {
    const int rr = i / kn;
    const int j = i % kn;
    pp[static_cast<size_t>(row0 + rr) * N + k0 + j] = a_s[rr * kPitch + j];
  }
}

// ---------------------------------------------------------------- backward 4
// dK + dV.  Grid (problems, key tiles, heads).
template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
pw_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ bias,
                  const T* __restrict__ mask, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ drow,
                  T* __restrict__ dk, T* __restrict__ dv, Geom g) {
  constexpr int TPR = Split<D>::TPR, DPT = Split<D>::DPT;
  extern __shared__ float4 smem4[];
  const int R = g.rows;
  float* q_s = reinterpret_cast<float*>(smem4);  // [kTile][D], times scale
  float* do_s = q_s + kTile * D;                 // [kTile][D]
  float* lse_s = do_s + kTile * D;               // [kTile]
  float* drow_s = lse_s + kTile;                 // [kTile]
  float* b_s = drow_s + kTile;                   // [query - q0][key - key0], pitch R

  const int p = blockIdx.x;
  const int h = blockIdx.z;
  const int N = g.N;
  const int r = threadIdx.x / TPR;
  const int d0 = (threadIdx.x % TPR) * DPT;
  const int key0 = blockIdx.y * R;
  const int ki = key0 + r;
  const bool ok = r < R && ki < N;
  const int rc = ok ? r : 0;
  const int kn = min(R, N - key0);
  const size_t hr = head_row(g, p, h);
  const T* qp = q + hr * D;
  const T* dop = dout + hr * D;
  const T* bp = bias_ptr(bias, g, p % g.nW, h);
  const T* mp = mask_ptr(mask, g, p);

  const size_t krow = (hr + (ok ? ki : 0)) * D + d0;
  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
  load_row<T, DPT>(kr, k + krow, ok, 1.f);
  load_row<T, DPT>(vr, v + krow, ok, 1.f);
#pragma unroll
  for (int d = 0; d < DPT; ++d) dka[d] = dva[d] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kTile) {
    const int qn = min(kTile, N - q0);
    __syncthreads();
    stage_rows<T, D>(q_s, qp, q0, qn, g.scale);
    stage_rows<T, D>(do_s, dop, q0, qn, 1.f);
    for (int i = threadIdx.x; i < qn; i += blockDim.x) {
      lse_s[i] = lse[hr + q0 + i];
      drow_s[i] = drow[hr + q0 + i];
    }
    // bias[query][key]: consecutive i walk the keys of one query
    for (int i = threadIdx.x; i < kTile * R; i += blockDim.x) {
      const int j = i / R;
      const int rr = i % R;
      const size_t o = static_cast<size_t>(q0 + j) * N + key0 + rr;
      b_s[j * R + rr] = (j < qn && rr < kn) ? load_f(bp + o) + load_f(mp + o) : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < qn; ++j) {
      const float* qj = q_s + j * D + d0;
      const float* doj = do_s + j * D + d0;
      const float s = row_sum<TPR>(dot_s<DPT>(kr, qj)) + b_s[j * R + rc];
      const float pj = expf(s - lse_s[j]);
      axpy_s<DPT>(dva, pj, doj);
      const float dp = row_sum<TPR>(dot_s<DPT>(vr, doj));
      axpy_s<DPT>(dka, pj * (dp - drow_s[j]), qj);  // q carries `scale`
    }
  }

  if (ok) {
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      store_f(dk + krow + d, dka[d]);
      store_f(dv + krow + d, dva[d]);
    }
  }
}

// ---------------------------------------------------------------- fused backward
// The fused body's (small_window_common.cuh) access policy on head-major
// operands: bias window wb is window type w, whose members are the problems
// p = t * nW + w in order of t (the JAX grid's (nW, nh, B_) order with t
// innermost); token j of (p, h) is row (p * nh + h) * N + j of q, k, v,
// out, dO, dq, dk and dv, so no row table is needed beyond that sum.  bias
// and mask are QUERY-major and the mask need not be symmetric, so the
// element at key kr, query qc is read at [qc][kr], and dbias partials are
// written query-major.
template <typename T, int D>
struct PackedAccess {
  const T* q_;
  const T* k_;
  const T* v_;
  const T* bias_;
  const T* mask_;
  const T* out_;
  const T* dout_;
  const float* lse;
  T* dq_;
  T* dk_;
  T* dv_;
  Geom g;
  T* out_w_ = nullptr;  // the forward's outputs
  float* lse_w_ = nullptr;

  struct Member {
    int m;
    const T* mask;
  };
  // the forward's member: problem p, with its window type's bias
  __device__ Member fwd_member(int p) const { return {p, mask_ptr(mask_, g, p)}; }
  __device__ const T* fwd_bias(const Member& mb, int h) const {
    return bias_ptr(bias_, g, mb.m % g.nW, h);
  }
  __device__ T* out_at(size_t row, int) const { return out_w_ + row * D; }
  __device__ float* lse_out() const { return lse_w_; }
  __device__ int N() const { return g.N; }
  __device__ int heads() const { return g.nh; }
  __device__ float scale() const { return g.scale; }
  __device__ int groups() const { return g.nW; }
  __device__ int members() const { return g.BW / g.nW; }
  __device__ const T* bias_block(int wb, int h) const { return bias_ptr(bias_, g, wb, h); }
  __device__ Member member(int t, int wb) const {
    const int p = t * g.nW + wb;
    return {p, mask_ptr(mask_, g, p)};
  }
  __device__ size_t row(const Member& mb, int h, int j) const { return head_row(g, mb.m, h) + j; }
  __device__ const T* q(size_t row, int) const { return q_ + row * D; }
  __device__ const T* k(size_t row, int) const { return k_ + row * D; }
  __device__ const T* v(size_t row, int) const { return v_ + row * D; }
  __device__ const T* o(size_t row, int) const { return out_ + row * D; }
  __device__ const T* dout(size_t row, int) const { return dout_ + row * D; }
  __device__ T* dq(size_t row, int) const { return dq_ + row * D; }
  __device__ T* dk(size_t row, int) const { return dk_ + row * D; }
  __device__ T* dv(size_t row, int) const { return dv_ + row * D; }
  __device__ float bm(const T* bp, const T* mp, int kr, int qc) const {
    const size_t o = static_cast<size_t>(qc) * g.N + kr;
    return load_f(bp + o) + load_f(mp + o);
  }
  __device__ size_t part_at(int kr, int qc) const { return static_cast<size_t>(qc) * g.N + kr; }
};

// Grid (member chunks, heads, window types); blockDim 32 * ceil(N / 16) <=
// 32 * NT.  part is [n_chunks, nW, nh, N, N] fp32, query-major.
template <typename T, int D, int NT>
__global__ void __launch_bounds__(32 * NT)
pw_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ bias,
                    const T* __restrict__ mask, const T* __restrict__ out,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                    float* __restrict__ part, Geom g, int n_chunks) {
  const PackedAccess<T, D> a{q, k, v, bias, mask, out, dout, lse, dq, dk, dv, g};
  fused_bwd_body<T, D, NT>(a, part, n_chunks);
}

// ---------------------------------------------------------------- fused forward
// Grid (problems, heads); blockDim 32 * ceil(N / 16) <= 32 * NT, one warp
// per 16 query rows; the window kernel's blocks per SM (4 at NT 4, 2 at NT 9).
template <typename T, int D, int NT>
__global__ void __launch_bounds__(32 * NT, NT <= 4 ? 4 : 2)
pw_fwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ bias,
                    const T* __restrict__ mask, T* __restrict__ out,
                    float* __restrict__ lse, Geom g) {
  const PackedAccess<T, D> a{q,       k,       v,       bias, mask, out, nullptr, lse,
                             nullptr, nullptr, nullptr, g,    out,  lse};
  fused_fwd_body<T, D, NT>(a);
}

// ---------------------------------------------------------------- launch
template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* bias, const void* mask, void* out, void* lse,
                       Geom g, cudaStream_t stream) {
  int threads;
  plan_rows<D>(g, threads);
  const size_t smem = sizeof(float) * (2 * kTile * D + kTile * (g.rows | 1));
  auto kernel = pw_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(g.BW, g.n_tiles, g.nh), threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), static_cast<const T*>(mask), static_cast<T*>(out),
      static_cast<float*>(lse), g);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* bias, const void* mask, const void* out,
                       const void* dout, const void* lse, void* dq, void* dk,
                       void* dv, void* dbias, void* drow, void* part,
                       int n_chunks, Geom g, cudaStream_t stream) {
  int threads;
  plan_rows<D>(g, threads);
  const int P = g.rows | 1;
  const int n_key_tiles = (g.N + kTile - 1) / kTile;
  const size_t smem_dq = sizeof(float) * (2 * kTile * D + kTile * P);
  const size_t smem_db = sizeof(float) * (2 * kTile * D + kTile * P + g.rows * kPitch);
  const size_t smem_dkv = sizeof(float) * (2 * kTile * D + 2 * kTile + kTile * g.rows);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tb = static_cast<const T*>(bias);
  const T* tm = static_cast<const T*>(mask);
  const T* tdo = static_cast<const T*>(dout);
  const float* tl = static_cast<const float*>(lse);
  float* tr = static_cast<float*>(drow);
  float* tp = static_cast<float*>(part);

  auto k_dq = pw_bwd_dq_kernel<T, D>;
  auto k_db = pw_bwd_dbias_kernel<T, D>;
  auto k_dkv = pw_bwd_dkv_kernel<T, D>;
  cudaError_t err;
  if ((err = allow_smem(k_dq, smem_dq)) != cudaSuccess) return err;
  if ((err = allow_smem(k_db, smem_db)) != cudaSuccess) return err;
  if ((err = allow_smem(k_dkv, smem_dkv)) != cudaSuccess) return err;

  k_dq<<<dim3(g.BW, g.n_tiles, g.nh), threads, smem_dq, stream>>>(
      tq, tk, tv, tb, tm, static_cast<const T*>(out), tdo, tl, tr,
      static_cast<T*>(dq), g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k_db<<<dim3(g.n_tiles * n_key_tiles, g.nh, g.nW * n_chunks), threads, smem_db,
         stream>>>(tq, tk, tv, tb, tm, tdo, tl, tr, tp, g, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 3. the partials summed over the chunks in order, into dbias
  err = launch_dbias_chunk_sum(tp, static_cast<T*>(dbias),
                               static_cast<size_t>(g.nW) * g.nh * g.N * g.N, n_chunks, stream);
  if (err != cudaSuccess) return err;
  k_dkv<<<dim3(g.BW, g.n_tiles, g.nh), threads, smem_dkv, stream>>>(
      tq, tk, tv, tb, tm, tdo, tl, tr, static_cast<T*>(dk), static_cast<T*>(dv), g);
  return cudaGetLastError();
}

// The fused route: the one-pass kernel, then the ordered chunk sum.
template <typename T, int D>
cudaError_t launch_bwd_fused(const void* q, const void* k, const void* v,
                             const void* bias, const void* mask, const void* out,
                             const void* dout, const void* lse, void* dq, void* dk,
                             void* dv, void* dbias, void* part, int n_chunks, Geom g,
                             cudaStream_t stream) {
  const int nt = (g.N + 15) / 16;
  g.scale = 1.f / sqrtf(static_cast<float>(D));
  const size_t smem = fused_smem_bytes(nt * 16, D);
  auto kernel = nt <= 4 ? &pw_bwd_fused_kernel<T, D, 4> : &pw_bwd_fused_kernel<T, D, 9>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  float* tp = static_cast<float*>(part);
  kernel<<<dim3(n_chunks, g.nh, g.nW), 32 * nt, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), static_cast<const T*>(mask), static_cast<const T*>(out),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), tp, g, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_dbias_chunk_sum(tp, static_cast<T*>(dbias),
                                static_cast<size_t>(g.nW) * g.nh * g.N * g.N, n_chunks,
                                stream);
}

// The fused forward: one block per (problem, head).
template <typename T, int D>
cudaError_t launch_fwd_fused(const void* q, const void* k, const void* v,
                             const void* bias, const void* mask, void* out, void* lse,
                             Geom g, cudaStream_t stream) {
  const int nt = (g.N + 15) / 16;
  g.scale = 1.f / sqrtf(static_cast<float>(D));
  const size_t smem = fwd_fused_smem_bytes(nt * 16, D);
  auto kernel = nt <= 4 ? &pw_fwd_fused_kernel<T, D, 4> : &pw_fwd_fused_kernel<T, D, 9>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(g.BW, g.nh), 32 * nt, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), static_cast<const T*>(mask), static_cast<T*>(out),
      static_cast<float*>(lse), g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd_fused(int D, const void* q, const void* k, const void* v,
                               const void* bias, const void* mask, void* out, void* lse,
                               const Geom& g, cudaStream_t s) {
  switch (D) {
#define PW_FWD_FUSED_CASE(DD) \
  case DD:                    \
    return launch_fwd_fused<T, DD>(q, k, v, bias, mask, out, lse, g, s);
    FUSED_HEAD_DIMS(PW_FWD_FUSED_CASE)
#undef PW_FWD_FUSED_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_bwd_fused(int D, const void* q, const void* k, const void* v,
                               const void* bias, const void* mask, const void* out,
                               const void* dout, const void* lse, void* dq, void* dk,
                               void* dv, void* dbias, void* part, int n_chunks,
                               const Geom& g, cudaStream_t s) {
  switch (D) {
#define PW_FUSED_CASE(DD)                                                           \
  case DD:                                                                          \
    return launch_bwd_fused<T, DD>(q, k, v, bias, mask, out, dout, lse, dq, dk, dv, \
                                   dbias, part, n_chunks, g, s);
    FUSED_HEAD_DIMS(PW_FUSED_CASE)
#undef PW_FUSED_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_fwd(int D, const void* q, const void* k, const void* v,
                         const void* bias, const void* mask, void* out,
                         void* lse, const Geom& g, cudaStream_t s) {
  switch (D) {
#define PW_FWD_CASE(DD) \
  case DD:              \
    return launch_fwd<T, DD>(q, k, v, bias, mask, out, lse, g, s);
    SMALL_WINDOW_HEAD_DIMS(PW_FWD_CASE)
#undef PW_FWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_bwd(int D, const void* q, const void* k, const void* v,
                         const void* bias, const void* mask, const void* out,
                         const void* dout, const void* lse, void* dq, void* dk,
                         void* dv, void* dbias, void* drow, void* part,
                         int n_chunks, const Geom& g, cudaStream_t s) {
  switch (D) {
#define PW_BWD_CASE(DD)                                                       \
  case DD:                                                                    \
    return launch_bwd<T, DD>(q, k, v, bias, mask, out, dout, lse, dq, dk, dv, \
                             dbias, drow, part, n_chunks, g, s);
    SMALL_WINDOW_HEAD_DIMS(PW_BWD_CASE)
#undef PW_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// Checks the shapes and fills the geometry; false on a shape the kernels
// do not take.
bool make_geom(Geom& g, int BW, int nh, int N, int nW, int mL, int mW) {
  if (BW <= 0 || nh <= 0 || nh > 65535 || N <= 0 || N > 1023 || nW <= 0 ||
      BW % nW || mL <= 0 || !(mW == 1 || mW == nW)) {
    return false;
  }
  g = Geom{BW, nh, N, nW, mL, mW, 0, 0, 0.f};
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, bias, mask, out); lse is
// float32 [BW, nh, N].  Launches on `stream`, never synchronises, and
// returns cudaGetLastError() (0 on success).
extern "C" int packed_window_attention_fwd(const void* q, const void* k,
                                           const void* v, const void* bias,
                                           const void* mask, void* out,
                                           void* lse, int BW, int nh, int N,
                                           int D, int nW, int mL, int mW,
                                           int dtype, void* stream) {
  Geom g;
  if (!make_geom(g, BW, nh, N, nW, mL, mW)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = dispatch_fwd<float>(D, q, k, v, bias, mask, out, lse, g, s);
  } else if (dtype == 1) {
    err = dispatch_fwd<__nv_bfloat16>(D, q, k, v, bias, mask, out, lse, g, s);
  }
  return static_cast<int>(err);
}

// The same forward by the fused route, for N <= 144 and head dims up to 48
// (anything else returns cudaErrorInvalidValue); the same arguments.
extern "C" int packed_window_attention_fwd_fused(const void* q, const void* k,
                                                 const void* v, const void* bias,
                                                 const void* mask, void* out, void* lse,
                                                 int BW, int nh, int N, int D, int nW,
                                                 int mL, int mW, int dtype, void* stream) {
  Geom g;
  if (!make_geom(g, BW, nh, N, nW, mL, mW) || N > kFusedMaxN || D > kFusedMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = dispatch_fwd_fused<float>(D, q, k, v, bias, mask, out, lse, g, s);
  } else if (dtype == 1) {
    err = dispatch_fwd_fused<__nv_bfloat16>(D, q, k, v, bias, mask, out, lse, g, s);
  }
  return static_cast<int>(err);
}

// The backward of `packed_window_attention_fwd`: dq, dk, dv in q's layout
// and type, dbias [nW, nh, N, N] in the bias type.  Scratch from the
// caller: drow float32 [BW, nh, N], part float32 [n_chunks, nW, nh, N, N].
// n_chunks (>= 1) splits each window type's BW / nW problems for the dbias
// pass.
extern "C" int packed_window_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* mask, const void* out, const void* dout, const void* lse,
    void* dq, void* dk, void* dv, void* dbias, void* drow, void* part, int BW,
    int nh, int N, int D, int nW, int mL, int mW, int n_chunks, int dtype,
    void* stream) {
  Geom g;
  if (!make_geom(g, BW, nh, N, nW, mL, mW) || n_chunks < 1 ||
      n_chunks > 65535 / nW) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = dispatch_bwd<float>(D, q, k, v, bias, mask, out, dout, lse, dq, dk,
                              dv, dbias, drow, part, n_chunks, g, s);
  } else if (dtype == 1) {
    err = dispatch_bwd<__nv_bfloat16>(D, q, k, v, bias, mask, out, dout, lse,
                                      dq, dk, dv, dbias, drow, part, n_chunks,
                                      g, s);
  }
  return static_cast<int>(err);
}

// The same backward by the fused route, for N <= 144 and head dims up to
// 48 (anything else returns cudaErrorInvalidValue).  Scratch from the
// caller: part float32 [n_chunks, nW, nh, N, N]; n_chunks (>= 1) splits
// each window type's BW / nW problems over blocks.
extern "C" int packed_window_attention_bwd_fused(
    const void* q, const void* k, const void* v, const void* bias,
    const void* mask, const void* out, const void* dout, const void* lse,
    void* dq, void* dk, void* dv, void* dbias, void* part, int BW, int nh, int N,
    int D, int nW, int mL, int mW, int n_chunks, int dtype, void* stream) {
  Geom g;
  if (!make_geom(g, BW, nh, N, nW, mL, mW) || N > kFusedMaxN || D > kFusedMaxD ||
      n_chunks < 1 || nW > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = dispatch_bwd_fused<float>(D, q, k, v, bias, mask, out, dout, lse, dq, dk, dv,
                                    dbias, part, n_chunks, g, s);
  } else if (dtype == 1) {
    err = dispatch_bwd_fused<__nv_bfloat16>(D, q, k, v, bias, mask, out, dout, lse, dq,
                                            dk, dv, dbias, part, n_chunks, g, s);
  }
  return static_cast<int>(err);
}
