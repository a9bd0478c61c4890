// Flash window attention, backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels behind `_flash_bwd_panel` (resident panels,
// 128-aligned N: `_bwd_dq_dbias_kernel_panel`, `_bwd_dkv_kernel_panel`)
// and `_flash_bwd_impl` (streaming, any N: `_bwd_dq_kernel`,
// `_bwd_dbias_kernel`, `_bwd_dkv_kernel`) in
// dlwpbench_tpu/ops/pallas_attention.py.  The split between the panel and
// the streaming route is a fact about the TPU's VMEM, not about the math,
// so one set of kernels takes any N.  Per batch member b and head h, with
// g = b % G and scale = D^-1/2:
//
//     s  = Q K^T * scale + bias[g]        p  = exp(s - lse)
//     dV = p^T dO                         dp = dO V^T
//     ds = p * (dp - drow)                dQ = (ds K) * scale
//     dK = ds^T (Q * scale)               dbias[g] = sum over members b of ds
//
// lse comes from the forward; drow = rowsum(dO * O) (minus the lse
// cotangent) is computed by the caller.  q, k, v, dO, dq, dk, dv are
// [B,H,N,D] row-major; lse and drow are [B,H,1,N] fp32; bias and dbias are
// [G,H,N,N] (the wrapper views a 3D bias as G = 1).  Inputs are fp32 or
// bf16, all one type; scores, p, ds and every accumulator are fp32; dq, dk,
// dv are written in the input type, dbias in the bias type.
//
// Two designs, chosen by shape before the launch (the wrapper's
// `bwd_route(N, D)`); both run three passes in this order, dQ, the dbias
// member sum, dK + dV, each over thousands of blocks of 128 threads.
// Neither uses floating-point atomics, and every sum runs in a fixed order:
// two calls on the same inputs give bit-identical results.  Each pass
// recomputes s and p (nine products in all instead of five) in exchange
// for blocks that own their outputs outright.
//
//  mma   D <= 64 (every model path: Swin D 24 and 48), any N.  The nine
//        products run on the tensor cores as `mma.sync` m16n8k8 TF32 with
//        the 3xTF32 split (a.b ~ a_big b_small + a_small b_big + a_big
//        b_big, fp32 accumulation: fp32-accurate; bf16 inputs are staged as
//        fp32 and take the same path).  Operand tiles of 64 rows are staged
//        in shared memory already split, as {big, small} pairs at pitch
//        D + 4, so each value is converted once per tile and not once per
//        product (a 3xTF32 product of operands split on the fly costs 12
//        conversions, and conversions run at a fraction of the FMA rate).
//        4 warps of 16 rows; a warp's S (or S^T) and dP tiles stay in
//        registers, P and dS go on as the A fragments of the next product
//        by taking each 8-column step in the order 0, 2, 4, 6, 1, 3, 5, 7
//        (the B fragment reads its rows in the same order), so no [N, N]
//        tile is ever in shared memory.  The bias is read from L2 into
//        registers ahead of the products that need it.  The next tile's
//        loads are issued into registers before the current tile's
//        products, so they stay in flight while those run.
//   1. dK + dV: block per (key tile, h, b); the block's K and V stay in
//      shared memory while it walks the query tiles (Q * scale, dO, lse,
//      drow), S^T = K (Q scale)^T, dP^T = V dO^T, dV += P^T dO,
//      dK += dS^T (Q scale).
//   2. dQ: block per (query tile, h, b), walking the key tiles:
//      S = (Q scale) K^T, dP = dO V^T, dQ += dS K.
//   3. dbias: block per (query tile x key tile, h, g), the 64 x 64 block's
//      bias and dS sum in registers, over the members b = g, g + G, ... in
//      order; S and dP per member.
//   Shared memory 4 x 64 (D + 4) x 8 B: 57 KB at D 24 (3 blocks an SM),
//   106 KB at D 48 (2), 139 KB at D 64 (1).
//  rows  D > 64 (up to 128), on the fp32 CUDA cores.  A thread owns one
//        row (D <= 32), or a half (D <= 64) or a quarter (D <= 128) of one;
//        the parts of a row sum their partial dot products with warp
//        shuffles, which keeps the dK/dV pass at 4 * D / parts <= 128 fp32
//        registers of row state.
//   1. dK + dV: one block per (b, key rows, h).  Each thread keeps its key
//      row's k, v and the dk, dv accumulators in registers and walks the
//      query tiles, staging q (pre-scaled), dO, lse, drow and the
//      [query tile, key rows] bias block in shared memory.  Only the tile's
//      real queries are visited, so phantom query rows never contribute.
//   2. dQ: one block per (b, query rows, h), walking the key tiles with k,
//      v and the bias block staged in shared memory; only real keys are
//      visited.
//   3. dbias: one block per (query rows, key tile, h, g).  It loops over
//      the members b = g + m*G, m = 0 .. B/G-1 in that order (one member
//      when G == B), recomputes the member's ds block and sums it in shared
//      memory, then writes the block once.
//   The mma design masks phantom rows and keys past N instead: their p and
//   ds are 0.
//
// What bounds it on an H100 SXM: at Swin's stage-0 global window
// (B 32, H 4, N 2048, D 24) the least work is the five products,
// 10*B*H*N^2*D = 128.8 GFLOP, on some 337 MB of operands (fp32): 0.78 ms at
// the 3xTF32 rate of 165 TFLOP/s (495 / 3), far above its 0.10 ms of
// bytes, so operations bound it.  The nine products the passes run take
// 1.41 ms at that rate; wgmma and TMA staging are later work.

#include "small_window_common.cuh"

namespace {

constexpr int kThreads = 128;  // threads per block

// Rows per block of the row passes: kThreads / TPR.
template <int D>
constexpr int kRows = kThreads / Split<D>::TPR;

// ---------------------------------------------------------------- pass 1
// dK + dV.  Grid (B, key row blocks, H).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ bias,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ drow, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int N, int G, float scale) {
  constexpr int TPR = Split<D>::TPR, DPT = Split<D>::DPT, ROWS = kRows<D>;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kTile][D], times scale
  float* do_s = q_s + kTile * D;                 // [kTile][D]
  float* lse_s = do_s + kTile * D;               // [kTile]
  float* drow_s = lse_s + kTile;                 // [kTile]
  float* b_s = drow_s + kTile;                   // [kTile][ROWS]: bias[query][key]

  const int b = blockIdx.x;
  const int key0 = blockIdx.y * ROWS;
  const int h = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int d0 = (tid % TPR) * DPT;
  const int key = key0 + r;
  const bool key_ok = key < N;

  const size_t bh = static_cast<size_t>(b) * H + h;
  const T* qp = q + bh * N * D;
  const T* dop = dout + bh * N * D;
  const float* lp = lse + bh * N;
  const float* rp = drow + bh * N;
  const T* bp = bias + (static_cast<size_t>(b % G) * H + h) * N * N;
  const size_t kofs = bh * N * D + static_cast<size_t>(key) * D + d0;

  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
  load_row<T, DPT>(kr, k + kofs, key_ok, 1.f);
  load_row<T, DPT>(vr, v + kofs, key_ok, 1.f);
#pragma unroll
  for (int d = 0; d < DPT; ++d) dka[d] = dva[d] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kTile) {
    const int qn = min(kTile, N - q0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < qn * D; i += kThreads) {
      const size_t g = static_cast<size_t>(q0) * D + i;
      q_s[i] = load_f(qp + g) * scale;
      do_s[i] = load_f(dop + g);
    }
    for (int i = tid; i < qn; i += kThreads) {
      lse_s[i] = lp[q0 + i];
      drow_s[i] = rp[q0 + i];
    }
    for (int i = tid; i < qn * ROWS; i += kThreads) {
      const int jj = i / ROWS;
      const int cc = i % ROWS;
      b_s[i] = key0 + cc < N
                   ? load_f(bp + static_cast<size_t>(q0 + jj) * N + key0 + cc)
                   : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < qn; ++j) {
      const float* qj = q_s + j * D + d0;
      const float* doj = do_s + j * D + d0;
      const float s = row_sum<TPR>(dot_s<DPT>(kr, qj)) + b_s[j * ROWS + r];
      const float p = expf(s - lse_s[j]);
      axpy_s<DPT>(dva, p, doj);
      const float dp = row_sum<TPR>(dot_s<DPT>(vr, doj));
      axpy_s<DPT>(dka, p * (dp - drow_s[j]), qj);  // q carries `scale`
    }
  }

  if (key_ok) {
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      store_f(dk + kofs + d, dka[d]);
      store_f(dv + kofs + d, dva[d]);
    }
  }
}

// ---------------------------------------------------------------- pass 2
// dQ.  Grid (B, query row blocks, H).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ bias,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ drow, T* __restrict__ dq,
                    int H, int N, int G, float scale) {
  constexpr int TPR = Split<D>::TPR, DPT = Split<D>::DPT, ROWS = kRows<D>;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kTile][D]
  float* v_s = k_s + kTile * D;                  // [kTile][D]
  float* b_s = v_s + kTile * D;                  // [ROWS][kPitch] bias block

  const int b = blockIdx.x;
  const int row0 = blockIdx.y * ROWS;
  const int h = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int d0 = (tid % TPR) * DPT;
  const int row = row0 + r;
  const bool row_ok = row < N;

  const size_t bh = static_cast<size_t>(b) * H + h;
  const T* kp = k + bh * N * D;
  const T* vp = v + bh * N * D;
  const T* bp = bias + (static_cast<size_t>(b % G) * H + h) * N * N;
  const size_t qofs = bh * N * D + static_cast<size_t>(row) * D + d0;

  float qr[DPT], dor[DPT], dqa[DPT];
  load_row<T, DPT>(qr, q + qofs, row_ok, scale);
  load_row<T, DPT>(dor, dout + qofs, row_ok, 1.f);
#pragma unroll
  for (int d = 0; d < DPT; ++d) dqa[d] = 0.f;
  const float lse_r = row_ok ? lse[bh * N + row] : 0.f;
  const float drow_r = row_ok ? drow[bh * N + row] : 0.f;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    const int kn = min(kTile, N - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kn * D; i += kThreads) {
      const size_t g = static_cast<size_t>(k0) * D + i;
      k_s[i] = load_f(kp + g);
      v_s[i] = load_f(vp + g);
    }
    for (int i = tid; i < ROWS * kTile; i += kThreads) {
      const int rr = i / kTile;
      const int cc = i % kTile;
      const int grow = row0 + rr;
      b_s[rr * kPitch + cc] =
          (grow < N && cc < kn)
              ? load_f(bp + static_cast<size_t>(grow) * N + k0 + cc)
              : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < kn; ++j) {
      const float* kj = k_s + j * D + d0;
      const float s = row_sum<TPR>(dot_s<DPT>(qr, kj)) + b_s[r * kPitch + j];
      const float p = expf(s - lse_r);
      const float dp = row_sum<TPR>(dot_s<DPT>(dor, v_s + j * D + d0));
      axpy_s<DPT>(dqa, p * (dp - drow_r), kj);
    }
  }

  if (row_ok) {
#pragma unroll
    for (int d = 0; d < DPT; ++d) store_f(dq + qofs + d, dqa[d] * scale);
  }
}

// ---------------------------------------------------------------- pass 3
// dbias: the sum over the members of each bias group.  Grid
// (query row blocks x key tiles, H, G).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dbias_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ bias,
                       const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ drow, T* __restrict__ dbias,
                       int B, int H, int N, int G, float scale, int n_row_blocks) {
  constexpr int TPR = Split<D>::TPR, DPT = Split<D>::DPT, ROWS = kRows<D>;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kTile][D]
  float* v_s = k_s + kTile * D;                  // [kTile][D]
  float* b_s = v_s + kTile * D;                  // [ROWS][kPitch] bias block
  float* a_s = b_s + ROWS * kPitch;              // [ROWS][kPitch] ds sum

  const int row0 = (blockIdx.x % n_row_blocks) * ROWS;
  const int k0 = (blockIdx.x / n_row_blocks) * kTile;
  const int h = blockIdx.y;
  const int g = blockIdx.z;
  const int kn = min(kTile, N - k0);
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int d0 = (tid % TPR) * DPT;
  const int row = row0 + r;
  const bool row_ok = row < N;

  const T* bp = bias + (static_cast<size_t>(g) * H + h) * N * N;
  for (int i = tid; i < ROWS * kTile; i += kThreads) {
    const int rr = i / kTile;
    const int cc = i % kTile;
    const int grow = row0 + rr;
    b_s[rr * kPitch + cc] =
        (grow < N && cc < kn)
            ? load_f(bp + static_cast<size_t>(grow) * N + k0 + cc)
            : 0.f;
    a_s[rr * kPitch + cc] = 0.f;
  }

  for (int b = g; b < B; b += G) {  // members in order: m = 0 .. B/G-1
    const size_t bh = static_cast<size_t>(b) * H + h;
    __syncthreads();  // the previous member's k/v tile is consumed
    for (int i = tid; i < kn * D; i += kThreads) {
      const size_t gi = bh * N * D + static_cast<size_t>(k0) * D + i;
      k_s[i] = load_f(k + gi);
      v_s[i] = load_f(v + gi);
    }
    const size_t qofs = bh * N * D + static_cast<size_t>(row) * D + d0;
    float qr[DPT], dor[DPT];
    load_row<T, DPT>(qr, q + qofs, row_ok, scale);
    load_row<T, DPT>(dor, dout + qofs, row_ok, 1.f);
    const float lse_r = row_ok ? lse[bh * N + row] : 0.f;
    const float drow_r = row_ok ? drow[bh * N + row] : 0.f;
    __syncthreads();

    for (int j = 0; j < kn; ++j) {
      const float s = row_sum<TPR>(dot_s<DPT>(qr, k_s + j * D + d0)) +
                      b_s[r * kPitch + j];
      const float p = expf(s - lse_r);
      const float dp = row_sum<TPR>(dot_s<DPT>(dor, v_s + j * D + d0));
      if (d0 == 0) a_s[r * kPitch + j] += p * (dp - drow_r);
    }
  }
  __syncthreads();

  T* dbp = dbias + (static_cast<size_t>(g) * H + h) * N * N;
  for (int i = tid; i < ROWS * kTile; i += kThreads) {
    const int rr = i / kTile;
    const int cc = i % kTile;
    const int grow = row0 + rr;
    if (grow < N && cc < kn) {
      store_f(dbp + static_cast<size_t>(grow) * N + k0 + cc, a_s[rr * kPitch + cc]);
    }
  }
}

// ---------------------------------------------------------------- tensor cores
// The "mma" design (header comment): every operand tile of 64 rows is
// staged once as {TF32 big part, TF32 remainder} pairs at pitch D + 4 (the
// fragment reads of both access patterns below are free of bank conflicts
// or 2-way at most), so no product converts a staged operand; 4 warps of
// 16 rows.
constexpr int kMmaMaxD = 64;
// 8-column tiles a warp takes per step in passes 1 and 2: a wider step
// reuses each A fragment over more columns, at the cost of C-fragment
// registers
constexpr int kDkvSteps = 4;
constexpr int kDqSteps = 4;

// A 64-row tile of a [rows, D] operand in registers, D / 8 float4 a thread
// of the 128-thread block: the next tile's loads stay in flight while the
// current tile computes.
template <typename T, int D>
struct TileRegs {
  static constexpr int V4 = D / 4;                   // float4 per row
  static constexpr int PER = kTile * V4 / kThreads;  // D / 8
  float4 x[PER];
  // rows [0, n) of src (row stride D), zeros past n
  __device__ __forceinline__ void load(const T* src, int n) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int j = i / V4, c = (i % V4) * 4;
      x[u] = j < n ? load4(src + static_cast<size_t>(j) * D + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  // times mul, split, into dst[kTile][D + 4]
  __device__ __forceinline__ void store(uint2* dst, float mul) const {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int j = i / V4, c = (i % V4) * 4;
      const uint2 a = split2(x[u].x * mul), b = split2(x[u].y * mul);
      const uint2 e = split2(x[u].z * mul), f = split2(x[u].w * mul);
      uint4* d = reinterpret_cast<uint4*>(dst + j * (D + 4) + c);
      d[0] = make_uint4(a.x, a.y, b.x, b.y);
      d[1] = make_uint4(e.x, e.y, f.x, f.y);
    }
  }
};

// ---------------------------------------------------------------- mma pass 1
// dK + dV.  Grid (key tiles, H, B); warp w owns key rows 16w .. 16w + 15
// of the tile and walks the query tiles, 8 * kDkvSteps queries a step.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ bias,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ drow, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int N, int G, float scale) {
  constexpr int P = D + 4, ND = D / 8;
  extern __shared__ uint4 smem_u4[];
  uint2* k_s = reinterpret_cast<uint2*>(smem_u4);  // [kTile][P]: the block's keys
  uint2* v_s = k_s + kTile * P;
  uint2* q_s = v_s + kTile * P;                    // the query tile, times scale
  uint2* do_s = q_s + kTile * P;
  float* lse_s = reinterpret_cast<float*>(do_s + kTile * P);
  float* drow_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int gq = (tid % 32) / 4, tq = tid % 4;
  const int r0 = (tid / 32) * 16;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const T* qp = q + bh * N * D;
  const T* dop = dout + bh * N * D;
  const float* lp = lse + bh * N;
  const float* rp = drow + bh * N;
  const T* bp = bias + (static_cast<size_t>(b % G) * H + h) * N * N;

  {
    TileRegs<T, D> kt, vt;
    kt.load(k + (bh * N + k0) * D, min(kTile, N - k0));
    vt.load(v + (bh * N + k0) * D, min(kTile, N - k0));
    kt.store(k_s, 1.f);
    vt.store(v_s, 1.f);
  }
  TileRegs<T, D> qt, dt;  // the next query tile, in flight
  qt.load(qp, min(kTile, N));
  dt.load(dop, min(kTile, N));
  float lr = 0.f, dr = 0.f;
  if (tid < min(kTile, N)) lr = lp[tid], dr = rp[tid];

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kTile) {
    const int qn = min(kTile, N - q0);
    __syncthreads();  // the previous tile is consumed
    qt.store(q_s, scale);
    dt.store(do_s, 1.f);
    if (tid < kTile) lse_s[tid] = lr, drow_s[tid] = dr;
    __syncthreads();
    if (q0 + kTile < N) {
      const int nn = min(kTile, N - q0 - kTile);
      qt.load(qp + static_cast<size_t>(q0 + kTile) * D, nn);
      dt.load(dop + static_cast<size_t>(q0 + kTile) * D, nn);
      lr = tid < nn ? lp[q0 + kTile + tid] : 0.f;
      dr = tid < nn ? rp[q0 + kTile + tid] : 0.f;
    }

    for (int j0 = 0; j0 < qn; j0 += 8 * kDkvSteps) {
      float bm[kDkvSteps][4], s[kDkvSteps][4], dp[kDkvSteps][4];  // bm: bias[query][key], loaded first
#pragma unroll
      for (int n = 0; n < kDkvSteps; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kr = k0 + r0 + gq + 8 * (i / 2);
          const int qc = q0 + j0 + 8 * n + 2 * tq + i % 2;
          bm[n][i] = kr < N && qc < N ? load_f(bp + static_cast<size_t>(qc) * N + kr) : 0.f;
          s[n][i] = dp[n][i] = 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {  // S^T = K (Q scale)^T, dP^T = V dO^T
        uint32_t kb[4], ks[4], vb[4], vs[4];
        sfrag_a(kb, ks, k_s, P, r0, kk * 8, gq, tq);
        sfrag_a(vb, vs, v_s, P, r0, kk * 8, gq, tq);
#pragma unroll
        for (int n = 0; n < kDkvSteps; ++n) {
          uint32_t bb[2], bs[2];
          sfrag_bt(bb, bs, q_s, P, kk * 8, j0 + 8 * n, gq, tq);
          mma_3xtf32_split(s[n], kb, ks, bb, bs);
          sfrag_bt(bb, bs, do_s, P, kk * 8, j0 + 8 * n, gq, tq);
          mma_3xtf32_split(dp[n], vb, vs, bb, bs);
        }
      }
#pragma unroll
      for (int n = 0; n < kDkvSteps; ++n) {  // P^T into s, dS^T into dp
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kr = k0 + r0 + gq + 8 * (i / 2);
          const int jl = j0 + 8 * n + 2 * tq + i % 2;
          float p = 0.f, ds = 0.f;
          if (kr < N && q0 + jl < N) {
            p = expf(s[n][i] + bm[n][i] - lse_s[jl]);
            ds = p * (dp[n][i] - drow_s[jl]);
          }
          s[n][i] = p;
          dp[n][i] = ds;
        }
      }
#pragma unroll
      for (int n = 0; n < kDkvSteps; ++n) {  // dV += P^T dO, dK += dS^T (Q scale)
        uint32_t pb[4], ps[4], db[4], ds[4];
        frag_ac(pb, ps, s[n]);
        frag_ac(db, ds, dp[n]);
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          uint32_t bb[2], bs[2];
          sfrag_bp(bb, bs, do_s, P, j0 + 8 * n, nd * 8, gq, tq);
          mma_3xtf32_split(dva[nd], pb, ps, bb, bs);
          sfrag_bp(bb, bs, q_s, P, j0 + 8 * n, nd * 8, gq, tq);
          mma_3xtf32_split(dka[nd], db, ds, bb, bs);
        }
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = k0 + r0 + gq + 8 * (i / 2);
      if (kr < N) {
        const size_t o = (bh * N + kr) * D + nd * 8 + 2 * tq + i % 2;
        store_f(dk + o, dka[nd][i]);
        store_f(dv + o, dva[nd][i]);
      }
    }
  }
}

// ---------------------------------------------------------------- mma pass 2
// dQ.  Grid (query tiles, H, B); warp w owns query rows 16w .. 16w + 15 of
// the tile and walks the key tiles, 8 * kDqSteps keys a step.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ bias,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ drow, T* __restrict__ dq, int H, int N,
                        int G, float scale) {
  constexpr int P = D + 4, ND = D / 8;
  extern __shared__ uint4 smem_u4[];
  uint2* q_s = reinterpret_cast<uint2*>(smem_u4);  // [kTile][P]: the block's queries, times scale
  uint2* do_s = q_s + kTile * P;
  uint2* k_s = do_s + kTile * P;                   // the key tile
  uint2* v_s = k_s + kTile * P;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int gq = (tid % 32) / 4, tq = tid % 4;
  const int r0 = (tid / 32) * 16;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const T* kp = k + bh * N * D;
  const T* vp = v + bh * N * D;
  const T* bp = bias + (static_cast<size_t>(b % G) * H + h) * N * N;

  {
    TileRegs<T, D> qt, dt;
    qt.load(q + (bh * N + q0) * D, min(kTile, N - q0));
    dt.load(dout + (bh * N + q0) * D, min(kTile, N - q0));
    qt.store(q_s, scale);
    dt.store(do_s, 1.f);
  }
  float lr[2], dr[2];  // lse and drow of the rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = q0 + r0 + gq + 8 * r;
    lr[r] = qr < N ? lse[bh * N + qr] : 0.f;
    dr[r] = qr < N ? drow[bh * N + qr] : 0.f;
  }
  TileRegs<T, D> kt, vt;  // the next key tile, in flight
  kt.load(kp, min(kTile, N));
  vt.load(vp, min(kTile, N));

  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dqa[n][i] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    const int kn = min(kTile, N - k0);
    __syncthreads();  // the previous tile is consumed
    kt.store(k_s, 1.f);
    vt.store(v_s, 1.f);
    __syncthreads();
    if (k0 + kTile < N) {
      const int nn = min(kTile, N - k0 - kTile);
      kt.load(kp + static_cast<size_t>(k0 + kTile) * D, nn);
      vt.load(vp + static_cast<size_t>(k0 + kTile) * D, nn);
    }

    for (int j0 = 0; j0 < kn; j0 += 8 * kDqSteps) {
      float bm[kDqSteps][4], s[kDqSteps][4], dp[kDqSteps][4];
#pragma unroll
      for (int n = 0; n < kDqSteps; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qr = q0 + r0 + gq + 8 * (i / 2);
          const int kc = k0 + j0 + 8 * n + 2 * tq + i % 2;
          bm[n][i] = qr < N && kc < N ? load_f(bp + static_cast<size_t>(qr) * N + kc) : 0.f;
          s[n][i] = dp[n][i] = 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {  // S = (Q scale) K^T, dP = dO V^T
        uint32_t qb[4], qs[4], ob[4], os[4];
        sfrag_a(qb, qs, q_s, P, r0, kk * 8, gq, tq);
        sfrag_a(ob, os, do_s, P, r0, kk * 8, gq, tq);
#pragma unroll
        for (int n = 0; n < kDqSteps; ++n) {
          uint32_t bb[2], bs[2];
          sfrag_bt(bb, bs, k_s, P, kk * 8, j0 + 8 * n, gq, tq);
          mma_3xtf32_split(s[n], qb, qs, bb, bs);
          sfrag_bt(bb, bs, v_s, P, kk * 8, j0 + 8 * n, gq, tq);
          mma_3xtf32_split(dp[n], ob, os, bb, bs);
        }
      }
#pragma unroll
      for (int n = 0; n < kDqSteps; ++n) {  // dS into dp
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qr = q0 + r0 + gq + 8 * (i / 2);
          const int kc = k0 + j0 + 8 * n + 2 * tq + i % 2;
          float ds = 0.f;
          if (qr < N && kc < N) {
            ds = expf(s[n][i] + bm[n][i] - lr[i / 2]) * (dp[n][i] - dr[i / 2]);
          }
          dp[n][i] = ds;
        }
      }
#pragma unroll
      for (int n = 0; n < kDqSteps; ++n) {  // dQ += dS K
        uint32_t db[4], ds[4];
        frag_ac(db, ds, dp[n]);
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          uint32_t bb[2], bs[2];
          sfrag_bp(bb, bs, k_s, P, j0 + 8 * n, nd * 8, gq, tq);
          mma_3xtf32_split(dqa[nd], db, ds, bb, bs);
        }
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + r0 + gq + 8 * (i / 2);
      if (qr < N) store_f(dq + (bh * N + qr) * D + nd * 8 + 2 * tq + i % 2, dqa[nd][i] * scale);
    }
  }
}

// ---------------------------------------------------------------- mma pass 3
// dbias: the sum over the members of each bias group.  Grid (query tiles x
// key tiles, H, G); warp w owns query rows 16w .. 16w + 15 of the block's
// 64 x 64 block, whose bias sits in shared memory and whose dS sum the warp
// keeps in registers over the members b = g, g + G, ... in that order, the
// next member's tiles in flight while the current one computes.
constexpr int kBiasPitch = kTile + 8;  // conflict-free float2 reads

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dbias_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ bias,
                           const T* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ drow, T* __restrict__ dbias, int B,
                           int H, int N, int G, float scale, int n_q_tiles) {
  constexpr int P = D + 4, ND = D / 8;
  extern __shared__ uint4 smem_u4[];
  uint2* q_s = reinterpret_cast<uint2*>(smem_u4);  // [kTile][P], times scale
  uint2* do_s = q_s + kTile * P;
  uint2* k_s = do_s + kTile * P;
  uint2* v_s = k_s + kTile * P;
  float* b_s = reinterpret_cast<float*>(v_s + kTile * P);  // [query][key], kBiasPitch

  const int q0 = (blockIdx.x % n_q_tiles) * kTile;
  const int k0 = (blockIdx.x / n_q_tiles) * kTile;
  const int h = blockIdx.y;
  const int g = blockIdx.z;
  const int tid = threadIdx.x;
  const int gq = (tid % 32) / 4, tq = tid % 4;
  const int r0 = (tid / 32) * 16;
  const int qn = min(kTile, N - q0), kn = min(kTile, N - k0);
  const size_t gh = static_cast<size_t>(g) * H + h;

  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    b_s[r * kBiasPitch + c] =
        r < qn && c < kn ? load_f(bias + (gh * N + q0 + r) * N + k0 + c) : 0.f;
  }
  float db[8][4];  // the dS sum of rows g (+8) x the 64 keys
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) db[n][i] = 0.f;

  // the next member's Q, dO, K, V tiles and its lse and drow rows, in flight
  // while the current one computes; past D 32 the four tiles do not fit in
  // the registers beside the products', so they load just before the
  // barrier that precedes their stores
  constexpr bool kPrefetch = D <= 32;
  TileRegs<T, D> nq, ndo, nk, nv;
  float lr[2], dr[2];
  auto fetch = [&](int b) {
    const size_t bh = static_cast<size_t>(b) * H + h;
    nq.load(q + (bh * N + q0) * D, qn);
    ndo.load(dout + (bh * N + q0) * D, qn);
    nk.load(k + (bh * N + k0) * D, kn);
    nv.load(v + (bh * N + k0) * D, kn);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = q0 + r0 + gq + 8 * r;
      lr[r] = qr < N ? lse[bh * N + qr] : 0.f;
      dr[r] = qr < N ? drow[bh * N + qr] : 0.f;
    }
  };
  if (kPrefetch) fetch(g);

  for (int b = g; b < B; b += G) {  // members in order: m = 0 .. B/G-1
    if (!kPrefetch) fetch(b);
    __syncthreads();  // the previous member's tiles are consumed
    nq.store(q_s, scale);
    ndo.store(do_s, 1.f);
    nk.store(k_s, 1.f);
    nv.store(v_s, 1.f);
    const float l[2] = {lr[0], lr[1]}, d[2] = {dr[0], dr[1]};
    __syncthreads();
    if (kPrefetch && b + G < B) fetch(b + G);

#pragma unroll
    for (int half = 0; half < 2; ++half) {  // keys 32 half .. 32 half + 31
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        uint32_t qb[4], qs[4], ob[4], os[4];
        sfrag_a(qb, qs, q_s, P, r0, kk * 8, gq, tq);
        sfrag_a(ob, os, do_s, P, r0, kk * 8, gq, tq);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t bb[2], bs[2];
          sfrag_bt(bb, bs, k_s, P, kk * 8, half * 32 + 8 * n, gq, tq);
          mma_3xtf32_split(s[n], qb, qs, bb, bs);
          sfrag_bt(bb, bs, v_s, P, kk * 8, half * 32 + 8 * n, gq, tq);
          mma_3xtf32_split(dp[n], ob, os, bb, bs);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int ql = r0 + gq + 8 * r;
          const int kl = half * 32 + 8 * n + 2 * tq;
          const float2 bm = *reinterpret_cast<const float2*>(b_s + ql * kBiasPitch + kl);
          const float bv[2] = {bm.x, bm.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * r + e;
            if (q0 + ql < N && k0 + kl + e < N) {
              db[half * 4 + n][i] += expf(s[n][i] + bv[e] - l[r]) * (dp[n][i] - d[r]);
            }
          }
        }
      }
    }
  }

  T* dbp = dbias + gh * N * N;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + r0 + gq + 8 * (i / 2);
      const int kc = k0 + 8 * n + 2 * tq + i % 2;
      if (qr < N && kc < N) store_f(dbp + static_cast<size_t>(qr) * N + kc, db[n][i]);
    }
  }
}

// ---------------------------------------------------------------- launch
// The row design's three launches.
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* dout, const void* lse,
                   const void* drow, void* dq, void* dk, void* dv, void* dbias,
                   int B, int H, int N, int G, cudaStream_t stream) {
  constexpr int ROWS = kRows<D>;
  const size_t smem_dkv = sizeof(float) * (2 * kTile * D + 2 * kTile + kTile * ROWS);
  const size_t smem_dq = sizeof(float) * (2 * kTile * D + ROWS * kPitch);
  const size_t smem_db = sizeof(float) * (2 * kTile * D + 2 * ROWS * kPitch);
  const int n_row_blocks = (N + ROWS - 1) / ROWS;
  const int n_key_tiles = (N + kTile - 1) / kTile;
  if (n_row_blocks > 65535 || H > 65535 || G > 65535 ||
      static_cast<long long>(n_row_blocks) * n_key_tiles > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tb = static_cast<const T*>(bias);
  const T* tdo = static_cast<const T*>(dout);
  const float* tl = static_cast<const float*>(lse);
  const float* tr = static_cast<const float*>(drow);

  auto k_dq = flash_bwd_dq_kernel<T, D>;
  auto k_db = flash_bwd_dbias_kernel<T, D>;
  auto k_dkv = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err;
  if ((err = allow_smem(k_dq, smem_dq)) != cudaSuccess) return err;
  if ((err = allow_smem(k_db, smem_db)) != cudaSuccess) return err;
  if ((err = allow_smem(k_dkv, smem_dkv)) != cudaSuccess) return err;

  k_dq<<<dim3(B, n_row_blocks, H), kThreads, smem_dq, stream>>>(
      tq, tk, tv, tb, tdo, tl, tr, static_cast<T*>(dq), H, N, G, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k_db<<<dim3(n_row_blocks * n_key_tiles, H, G), kThreads, smem_db, stream>>>(
      tq, tk, tv, tb, tdo, tl, tr, static_cast<T*>(dbias), B, H, N, G, scale,
      n_row_blocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k_dkv<<<dim3(B, n_row_blocks, H), kThreads, smem_dkv, stream>>>(
      tq, tk, tv, tb, tdo, tl, tr, static_cast<T*>(dk), static_cast<T*>(dv),
      H, N, G, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* bias, const void* dout, const void* lse,
                     const void* drow, void* dq, void* dk, void* dv,
                     void* dbias, int B, int H, int N, int G, cudaStream_t s) {
  switch (D) {
#define FWB_CASE(DD)                                                        \
  case DD:                                                                  \
    return launch<T, DD>(q, k, v, bias, dout, lse, drow, dq, dk, dv, dbias, \
                         B, H, N, G, s);
    FWB_CASE(8) FWB_CASE(16) FWB_CASE(24) FWB_CASE(32)
    FWB_CASE(40) FWB_CASE(48) FWB_CASE(56) FWB_CASE(64)
    FWB_CASE(72) FWB_CASE(80) FWB_CASE(88) FWB_CASE(96)
    FWB_CASE(104) FWB_CASE(112) FWB_CASE(120) FWB_CASE(128)
#undef FWB_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// The mma design's three launches, in the row design's order.
template <typename T, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* bias,
                       const void* dout, const void* lse, const void* drow, void* dq,
                       void* dk, void* dv, void* dbias, int B, int H, int N, int G,
                       cudaStream_t stream) {
  const size_t tiles = 4 * sizeof(uint2) * kTile * (D + 4);  // 4 split operand tiles
  const size_t smem_dkv = tiles + 2 * kTile * sizeof(float);  // + lse, drow
  const size_t smem_db = tiles + kTile * kBiasPitch * sizeof(float);  // + the bias block
  const int n_tiles = (N + kTile - 1) / kTile;
  if (H > 65535 || B > 65535 || G > 65535 ||
      static_cast<long long>(n_tiles) * n_tiles > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tb = static_cast<const T*>(bias);
  const T* tdo = static_cast<const T*>(dout);
  const float* tl = static_cast<const float*>(lse);
  const float* tr = static_cast<const float*>(drow);

  auto k_dq = flash_bwd_dq_mma_kernel<T, D>;
  auto k_db = flash_bwd_dbias_mma_kernel<T, D>;
  auto k_dkv = flash_bwd_dkv_mma_kernel<T, D>;
  cudaError_t err;
  if ((err = allow_smem(k_dq, tiles)) != cudaSuccess) return err;
  if ((err = allow_smem(k_db, smem_db)) != cudaSuccess) return err;
  if ((err = allow_smem(k_dkv, smem_dkv)) != cudaSuccess) return err;

  k_dq<<<dim3(n_tiles, H, B), kThreads, tiles, stream>>>(tq, tk, tv, tb, tdo, tl, tr,
                                                         static_cast<T*>(dq), H, N, G, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k_db<<<dim3(n_tiles * n_tiles, H, G), kThreads, smem_db, stream>>>(
      tq, tk, tv, tb, tdo, tl, tr, static_cast<T*>(dbias), B, H, N, G, scale, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k_dkv<<<dim3(n_tiles, H, B), kThreads, smem_dkv, stream>>>(
      tq, tk, tv, tb, tdo, tl, tr, static_cast<T*>(dk), static_cast<T*>(dv), H, N, G, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mma(int D, const void* q, const void* k, const void* v,
                         const void* bias, const void* dout, const void* lse,
                         const void* drow, void* dq, void* dk, void* dv, void* dbias,
                         int B, int H, int N, int G, cudaStream_t s) {
  switch (D) {
#define FWB_MMA_CASE(DD)                                                        \
  case DD:                                                                      \
    return launch_mma<T, DD>(q, k, v, bias, dout, lse, drow, dq, dk, dv, dbias, \
                             B, H, N, G, s);
    FWB_MMA_CASE(8) FWB_MMA_CASE(16) FWB_MMA_CASE(24) FWB_MMA_CASE(32)
    FWB_MMA_CASE(40) FWB_MMA_CASE(48) FWB_MMA_CASE(56) FWB_MMA_CASE(64)
#undef FWB_MMA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, bias, dO, dq, dk, dv, dbias);
// lse and drow are float32.  Launches the passes on `stream` (dQ, then the
// dbias member sum, then dK/dV), never synchronises, and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_window_attention_bwd(const void* q, const void* k,
                                          const void* v, const void* bias,
                                          const void* dout, const void* lse,
                                          const void* drow, void* dq, void* dk,
                                          void* dv, void* dbias, int B, int H,
                                          int N, int D, int G, int dtype,
                                          void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || G <= 0 || B % G != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(D, q, k, v, bias, dout, lse, drow, dq, dk, dv, dbias,
                          B, H, N, G, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(D, q, k, v, bias, dout, lse, drow, dq, dk,
                                  dv, dbias, B, H, N, G, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The same backward by the mma design, for head dims up to 64 (anything
// else returns cudaErrorInvalidValue); the same arguments.
extern "C" int flash_window_attention_bwd_mma(const void* q, const void* k,
                                              const void* v, const void* bias,
                                              const void* dout, const void* lse,
                                              const void* drow, void* dq, void* dk,
                                              void* dv, void* dbias, int B, int H,
                                              int N, int D, int G, int dtype,
                                              void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || G <= 0 || B % G != 0 || D > kMmaMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_mma<float>(D, q, k, v, bias, dout, lse, drow, dq, dk, dv, dbias,
                              B, H, N, G, s);
  } else if (dtype == 1) {
    err = dispatch_mma<__nv_bfloat16>(D, q, k, v, bias, dout, lse, drow, dq, dk, dv,
                                      dbias, B, H, N, G, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
