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
// Three designs, chosen by shape before the launch (the wrapper's
// `bwd_route(N, D)`); all run three passes in this order, dQ, the dbias
// member sum, dK + dV, each over thousands of blocks.  None uses
// floating-point atomics, and every sum runs in a fixed order: two calls on
// the same inputs give bit-identical results.  Each pass recomputes s and p
// (nine products in all instead of five) in exchange for blocks that own
// their outputs outright: a pass that held dS for the dbias sum would have
// to keep the members' dQ, or dK and dV, of a tile at once (32 members x
// 64 x D), or sum dbias through memory.
//
//  wgmma D <= 48 (every model path: Swin D 24 and 48, Pangu's flash route
//        D 32), any N.  Hopper's own route to the tensor cores: the nine
//        products run as `wgmma.mma_async` m64nNk8 TF32 with the same 3xTF32
//        split as the mma design (each product three wgmma, small x big,
//        big x small, big x big, fp32 accumulation; bf16 inputs staged as
//        fp32).  A block is one or two warpgroups of 128 threads, each
//        owning a 64-row tile (warp w the accumulator rows 16w .. 16w + 15),
//        and one producer warp that streams the other operands' tiles by TMA
//        into a ring of two slots, each guarded by a "full" mbarrier (the
//        copies' bytes) and an "empty" one (the consumers' arrivals).  The 4D tensor
//        map of each [B*H, N, D] tensor lands a 64-row box as [D/4][64][4]:
//        already the core-matrix layout `wgmma` reads without swizzle, rows
//        past N as zeros.  lse and drow come as 1D boxes from the 16-byte
//        boundary before the tile (a box starts 16-byte aligned).  The
//        consumers split each tile into TF32 {big, small} parts in that
//        layout, and the tiles a product contracts over their rows also
//        transposed (`wgmma` reads TF32 only K-major), in the order of the
//        accumulator columns whose values become the next product's A
//        fragments in registers (P^T, dS^T, dS), so no 64 x 64 tile is ever
//        in shared memory.  Products into one accumulator run in order on
//        the tensor cores, and a k8 TF32 step at N = D is small (64 x 24 x 8
//        at D 24): the dQ products run as three chains and dK, dV as two
//        up to D 40 (registers), big x big and the remainders, summed once
//        at the end (also closer to fp32 than one chain: at N 2047 the
//        error halves), and the S and dP chains interleave.  exp
//        is `ex2` with log2 e folded into the scale, the bias and lse.
//   1. dK + dV: block per (b, 64 keys a warpgroup, h), K and V split once,
//      walking the query tiles (Q, dO, lse, drow): S^T = K Q^T and dP^T =
//      V dO^T from shared memory, P^T then dS^T in registers as the A
//      operands of dV += P^T dO and dK += dS^T Q.  At D <= 24 two
//      warpgroups share each query tile's conversion (they then run in
//      lockstep, one block an SM); one past it.  Registers set the form:
//      where an SM holds more than 8 warps a thread has 168, and the bias
//      tile loads once S^T is in; with 255 it loads a tile ahead.
//   2. dQ: block per (b, 64 queries, h) walking the key tiles: S, dP, then
//      dQ += dS K, the bias a tile ahead; one warpgroup a block (two in
//      lockstep ran slower than two blocks).
//   3. dbias: block per (64 queries x 64 keys a warpgroup, h, g) walking
//      the members b = g, g + G, ... in order, all tiles of each streamed
//      (at D <= 24 two warpgroups share the query tile); the bias and dS
//      sum stay in registers.
//   Shared memory 86 KB (dQ at D 24, two blocks an SM) .. 199 KB (D 48).
//
// What bounds it on an H100 SXM: at Swin's stage-0 global window
// (B 32, H 4, N 2048, D 24) the least work is the five products,
// 10*B*H*N^2*D = 128.8 GFLOP, on some 337 MB of operands (fp32): 0.78 ms at
// the 3xTF32 rate of 165 TFLOP/s (495 / 3), far above its 0.10 ms of
// bytes, so operations bound it.  The nine products the passes run take
// 1.41 ms at that rate.  What holds the wgmma design above that: each
// 64 x 64 tile's softmax, splits and conversions run between its products
// on the same warps (two warpgroups an SM at most overlap them), and the
// dbias pass streams three or four tiles a member through L2 for two
// products a warpgroup.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda at run time

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

// ---------------------------------------------------------------- wgmma design
// The Hopper design (header comment): per block one or two consumer
// warpgroups (threads 0 .. 128 NWG - 1), each owning a 64-row tile, and
// one producer warp (the next 32) that streams the other operands' 64-row
// tiles into a ring of kWgStages slots by TMA, each slot guarded by a
// "full" mbarrier (the copies' bytes) and an "empty" one (an arrival from
// each consumer thread).  The
// consumers split every tile into TF32 {big, small} parts in the operand
// layout `wgmma` reads without swizzle (core matrices of 8 rows x 16 bytes),
// the tiles that a product contracts over their 64 rows also transposed,
// and run the products as `wgmma.mma_async` m64nNk8 TF32, three per
// 3xTF32 product (small x big, big x small, big x big, as `mma_3xtf32_split`).
constexpr int kWgmmaMaxD = 48;
constexpr int kWgStages = 2;
constexpr int kSmemPerSm = 233472;  // an H100 SM's shared memory, 1 KB a block reserved
// lse and drow of a 64-row tile come as a box of kVecBox floats that starts
// at the 16-byte boundary at or before the tile's first row (a TMA box
// starts 16-byte aligned in its innermost dimension), kVecBytes apart
constexpr int kVecBox = kTile + 4;
constexpr int kVecBytes = 384;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// Waits for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// the consumer warpgroups' barrier (the producer warp never joins)
template <int NT = 128>
__device__ __forceinline__ void wg_sync() { asm volatile("bar.sync 1, %0;" ::"n"(NT) : "memory"); }
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps registers that an asynchronous product reads or writes in place
// until its wait: the compiler sees each one touched here.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][4]) {
#pragma unroll
  for (int j = 0; j < M; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[j][i])::"memory");
}

// exp(x) = 2^(x log2 e) on the SFU, with log2 e folded into the scores'
// scale, the bias and lse: one multiply-add and `ex2` a score (within 2e-7
// of `expf`'s result relative to the gradient, far inside its tolerance).
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The descriptor of a K-major operand in shared memory without swizzle:
// core matrices of 8 rows x 16 bytes, `lbo` bytes from a k8 step's first
// 4 columns to its last 4, `sbo` bytes from one 8-row group to the next.
__device__ __forceinline__ uint64_t wg_desc(const float* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32;
}
// A 64-row tile in the plain layout [D / 4][64][4] (rows a product's M or
// N, head dims its K): k8 step kk.
__device__ __forceinline__ uint64_t desc_plain(const float* tile, int kk) {
  return wg_desc(tile + kk * 512, 1024, 128);
}
// A transposed tile [D / 8][16][8][4] (head dims the product's N, the 64
// rows its K): k8 step j.
__device__ __forceinline__ uint64_t desc_trans(const float* tile, int j) {
  return wg_desc(tile + j * 64, 128, 2048);
}

// d += A B (d = A B where acc is 0), m64nNk8 TF32 with f32 accumulators:
// A and B in shared memory (N = 64) or A in registers (N = the head dim).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<24>(float (&d)[12], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<40>(float (&d)[20], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<56>(float (&d)[28], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, {%28, %29, %30, %31}, %32, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The TMA box of a [B * H, N, D] tensor's 64 rows: fp32 [D / 4][64][4],
// bf16 [D / 8][64][8] (16 bytes of head dims innermost, as the 4D map of
// `map_rows` lays them out).
__device__ __forceinline__ float4 raw4(const float* r, int row, int c4) {
  return *reinterpret_cast<const float4*>(r + c4 * 256 + row * 4);
}
__device__ __forceinline__ float4 raw4(const __nv_bfloat16* r, int row, int c4) {
  return load4(r + (c4 / 2) * 512 + row * 8 + (c4 % 2) * 4);
}
__device__ __forceinline__ float raw1(const float* r, int row, int d) {
  return r[(d / 4) * 256 + row * 4 + d % 4];
}
__device__ __forceinline__ float raw1(const __nv_bfloat16* r, int row, int d) {
  return __bfloat162float(r[(d / 8) * 512 + row * 8 + d % 8]);
}

__device__ __forceinline__ void split4(const float4& x, float4& big, float4& small) {
  const uint2 a = split2(x.x), b = split2(x.y), c = split2(x.z), e = split2(x.w);
  big = make_float4(__uint_as_float(a.x), __uint_as_float(b.x), __uint_as_float(c.x),
                    __uint_as_float(e.x));
  small = make_float4(__uint_as_float(a.y), __uint_as_float(b.y), __uint_as_float(c.y),
                      __uint_as_float(e.y));
}

// A raw tile, split, into the plain layout [D / 4][64][4].
template <typename T, int D, int NT = 128>
__device__ __forceinline__ void split_plain(const T* raw, float* big, float* small, int tid) {
#pragma unroll
  for (int u = 0; u < (16 * D + NT - 1) / NT; ++u) {  // 16 D float4 over NT threads
    const int i = tid + u * NT;
    if (16 * D % NT != 0 && i >= 16 * D) break;
    float4 b, s;
    split4(raw4(raw, i % 64, i / 64), b, s);
    reinterpret_cast<float4*>(big)[i] = b;
    reinterpret_cast<float4*>(small)[i] = s;
  }
}
// A raw tile, split, transposed into [D / 8][16][8][4] for a product that
// contracts over its rows: logical row 8 j + 4 c + e holds row 8 j + 2 e + c,
// the column order of the accumulator the product's A fragments come from
// (`frag_acc`).  A warp writes 8 head dims x 4 logical row quads a step:
// 16-byte stores without conflicts.
template <typename T, int D, int NT = 128>
__device__ __forceinline__ void split_trans(const T* raw, float* big, float* small, int tid) {
  constexpr int W = NT / 32;  // warps
#pragma unroll
  for (int u = 0; u < (D / 2 + W - 1) / W; ++u) {
    const int w = tid / 32 + W * u, lane = tid % 32;
    if (D / 2 % W != 0 && w >= D / 2) break;
    const int kc = 4 * (w % 4) + lane / 8, d = 8 * (w / 4) + lane % 8;
    const int r0 = 8 * (kc / 2) + kc % 2;
    float4 b, s;
    split4(make_float4(raw1(raw, r0, d), raw1(raw, r0 + 2, d), raw1(raw, r0 + 4, d),
                       raw1(raw, r0 + 6, d)),
           b, s);
    const int o = (d / 8) * 128 + kc * 8 + d % 8;  // float4 index
    reinterpret_cast<float4*>(big)[o] = b;
    reinterpret_cast<float4*>(small)[o] = s;
  }
}
// The accumulator of a 64 x 64 product, split, as the A fragments of a
// product over its 64 columns: k8 step j takes columns 8 j + {2t, 2t + 1}
// as its logical columns {t, t + 4}.
__device__ __forceinline__ void frag_acc(uint32_t (&ab)[8][4], uint32_t (&as)[8][4],
                                         const float (&c)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) frag_ac(ab[j], as[j], *reinterpret_cast<const float(*)[4]>(c + 4 * j));
}

// Shared memory of the three kernels, in bytes, and how many blocks share
// an SM (2 where both fit, which caps registers at 200 a thread).
template <typename T, int D>
struct WgPlan {
  static constexpr int CV = 64 * D;  // floats of a split operand tile
  static constexpr int RAW = 64 * D;  // elements of a raw tile
  static constexpr size_t kRawBytes = RAW * sizeof(T);
  static constexpr size_t kBars = 8 * (2 * kWgStages + 1);
  // dK + dV: kDkvWg warpgroups of 64 keys share each query tile's
  // conversion (two at D <= 24, where the block still fits an SM's shared
  // memory); own split K, V (4 CV a warpgroup); the streamed tile's Q, dO
  // plain and transposed (8 CV; the own raw K, V land there first); the
  // ring: raw Q, dO, lse, drow
  static constexpr int kDkvWg = D <= 24 ? 2 : 1;
  static constexpr size_t kDkvSlot = 2 * kRawBytes + 2 * kVecBytes;
  static constexpr size_t dkv = (4 * kDkvWg + 8) * CV * 4 + kWgStages * kDkvSlot + kBars;
  // dQ: own split Q, dO (4 CV); K, V plain and K transposed (6 CV; own raw
  // Q, dO first); the ring: raw K, V
  static constexpr size_t kDqSlot = 2 * kRawBytes;
  static constexpr size_t dq = 10 * CV * 4 + kWgStages * kDqSlot + kBars;
  // dbias: kDbWg warpgroups of 64 keys share each member's query tile;
  // Q, dO plain (4 CV) and each warpgroup's K, V plain (4 CV); the ring:
  // raw Q, dO, the warpgroups' K, V, lse, drow
  static constexpr int kDbWg = D <= 24 ? 2 : 1;
  static constexpr size_t kDbSlot = (2 + 2 * kDbWg) * kRawBytes + 2 * kVecBytes;
  static constexpr size_t db = (4 + 4 * kDbWg) * CV * 4 + kWgStages * kDbSlot + kBars;
  __host__ __device__ static constexpr int occ(size_t bytes) { return 2 * (bytes + 1024) <= kSmemPerSm ? 2 : 1; }
};

// Barriers at the end of a kernel's shared memory: full[S], empty[S] (an
// arrival from each consumer thread), own.
__device__ __forceinline__ void init_bars(uint64_t* bars, int consumers) {
#pragma unroll
  for (int s = 0; s < kWgStages; ++s) {
    mbar_init(bars + s, 1);
    mbar_init(bars + kWgStages + s, consumers);
  }
  mbar_init(bars + 2 * kWgStages, 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// ---------------------------------------------------------------- wgmma pass 1
// dK + dV.  Grid (B, key blocks of 64 kDkvWg, H); warpgroup wg owns keys
// 64 wg .. 64 wg + 63 of the block (its warp w the accumulator rows 16w ..
// 16w + 15), and the warpgroups walk the query tiles together.
template <typename T, int D>
__global__ void __launch_bounds__(WgPlan<T, D>::kDkvWg * 128 + 32,
                                  WgPlan<T, D>::occ(WgPlan<T, D>::dkv))
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mdo,
                           const __grid_constant__ CUtensorMap mlse,
                           const __grid_constant__ CUtensorMap mdrow, const T* __restrict__ bias,
                           T* __restrict__ dk, T* __restrict__ dv, int H, int N, int G,
                           float scale) {
  using P = WgPlan<T, D>;
  constexpr int CV = P::CV, NWG = P::kDkvWg, NT = 128 * NWG;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  float* own = reinterpret_cast<float*>(wg_smem);  // Kb, Ks, Vb, Vs a warpgroup
  float* cv = own + 4 * NWG * CV;                  // Qb, Qs, Ob, Os, QTb, QTs, OTb, OTs
  unsigned char* ring = reinterpret_cast<unsigned char*>(cv + 8 * CV);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * P::kDkvSlot);
  uint64_t* empty = full + kWgStages;
  uint64_t* own_full = full + 2 * kWgStages;

  const int b = blockIdx.x, h = blockIdx.z;
  const int bh = b * H + h;
  const int tid = threadIdx.x;
  const int n_tiles = (N + kTile - 1) / kTile;
  if (tid == 0) init_bars(full, NT);
  __syncthreads();

  if (tid >= NT) {  // the producer warp: one thread issues every copy
    if (tid == NT) {
      mbar_expect_tx(own_full, 2 * NWG * P::kRawBytes);
      for (int w = 0; w < NWG; ++w) {
        T* raw = reinterpret_cast<T*>(cv) + 2 * w * P::RAW;
        tma_load_4d(raw, &mk, own_full, 0, (blockIdx.y * NWG + w) * kTile, 0, bh);
        tma_load_4d(raw + P::RAW, &mv, own_full, 0, (blockIdx.y * NWG + w) * kTile, 0, bh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kWgStages;
        if (it >= kWgStages) mbar_wait(empty + s, (it / kWgStages - 1) & 1);
        unsigned char* slot = ring + s * P::kDkvSlot;
        const int v0 = (bh * N + it * kTile) & ~3;
        mbar_expect_tx(full + s, 2 * P::kRawBytes + 2 * kVecBox * 4);
        tma_load_4d(slot, &mq, full + s, 0, it * kTile, 0, bh);
        tma_load_4d(slot + P::kRawBytes, &mdo, full + s, 0, it * kTile, 0, bh);
        tma_load_1d(slot + 2 * P::kRawBytes, &mlse, full + s, v0);
        tma_load_1d(slot + 2 * P::kRawBytes + kVecBytes, &mdrow, full + s, v0);
      }
    }
    return;
  }

  const float sl2 = scale * kLog2e;  // the scores' scale, in powers of 2
  const int wg = tid / 128, warp = tid % 128 / 32, g = (tid % 32) / 4, t = tid % 4;
  const int k0 = (blockIdx.y * NWG + wg) * kTile;  // this warpgroup's keys
  mbar_wait(own_full, 0);
  own += 4 * wg * CV;
  const T* own_raw = reinterpret_cast<const T*>(cv) + 2 * wg * P::RAW;
  split_plain<T, D>(own_raw, own, own + CV, tid % 128);
  split_plain<T, D>(own_raw + P::RAW, own + 2 * CV, own + 3 * CV, tid % 128);
  fence_proxy_async();
  wg_sync<NT>();

  const T* bp = bias + (static_cast<size_t>(b % G) * H + h) * N * N;
  // dK and dV as two chains each, the big x big products and the
  // remainders (closer to fp32 over long key walks: at N 2047 the error
  // halves), up to D 40; at D 48 the registers hold one chain each
  constexpr bool kTwo = D <= 40;
  float dka[D / 2], dva[D / 2], dkr[D / 2], dvr[D / 2];  // dkr, dvr unused past D 40
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = dkr[i] = dvr[i] = 0.f;

  // bias[query][key] at the S^T accumulator's places: a tile ahead where
  // a thread has 255 registers (at most 8 warps an SM), else once the
  // tile's S^T and dP^T are in, the other warpgroup's work hiding the loads
  constexpr bool kAhead = P::occ(P::dkv) * (4 * NWG + 1) <= 8;
  float bm[32];
  auto load_bias = [&](int q0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 16 * warp + g + 8 * (i / 2);
        const int q = q0 + 8 * j + 2 * t + i % 2;
        bm[4 * j + i] = key < N && q < N ? load_f(bp + static_cast<size_t>(q) * N + key) : 0.f;
      }
  };
  if (kAhead) load_bias(0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kWgStages;
    const int q0 = it * kTile;
    mbar_wait(full + s, (it / kWgStages) & 1);
    const unsigned char* slot = ring + s * P::kDkvSlot;
    const T* qraw = reinterpret_cast<const T*>(slot);
    const T* oraw = qraw + P::RAW;
    const int v_off = (bh * N + q0) & 3;
    const float* lse_s = reinterpret_cast<const float*>(slot + 2 * P::kRawBytes) + v_off;
    const float* drow_s = reinterpret_cast<const float*>(slot + 2 * P::kRawBytes + kVecBytes) + v_off;
    split_plain<T, D, NT>(qraw, cv, cv + CV, tid);
    split_plain<T, D, NT>(oraw, cv + 2 * CV, cv + 3 * CV, tid);
    split_trans<T, D, NT>(qraw, cv + 4 * CV, cv + 5 * CV, tid);
    split_trans<T, D, NT>(oraw, cv + 6 * CV, cv + 7 * CV, tid);
    fence_proxy_async();
    wg_sync<NT>();

    float sa[32], pa[32];  // S^T = K Q^T, dP^T = V dO^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint64_t kb = desc_plain(own, kk), ks = desc_plain(own + CV, kk);
      const uint64_t vb = desc_plain(own + 2 * CV, kk), vs = desc_plain(own + 3 * CV, kk);
      const uint64_t qb = desc_plain(cv, kk), qs = desc_plain(cv + CV, kk);
      const uint64_t ob = desc_plain(cv + 2 * CV, kk);
      const uint64_t os = desc_plain(cv + 3 * CV, kk);
      wgmma_ss64(sa, ks, qb, kk > 0);
      wgmma_ss64(pa, vs, ob, kk > 0);
      wgmma_ss64(sa, kb, qs, 1);
      wgmma_ss64(pa, vb, os, 1);
      wgmma_ss64(sa, kb, qb, 1);
      wgmma_ss64(pa, vb, ob, 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sa);
    fence_regs(pa);
    if (!kAhead) load_bias(q0);

#pragma unroll
    for (int j = 0; j < 8; ++j) {  // P^T into sa, dS^T into pa (phantom queries 0)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = 8 * j + 2 * t + e;
        const float l = lse_s[ql] * kLog2e, r = drow_s[ql];
        const bool ok = q0 + ql < N;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int i = 4 * j + 2 * h2 + e;
          const float x = ok ? exp2_sfu(fmaf(sa[i], sl2, fmaf(bm[i], kLog2e, -l))) : 0.f;
          sa[i] = x;
          pa[i] = x * (pa[i] - r);
        }
      }
    }
    mbar_arrive(empty + s);  // this thread is done with the slot

    uint32_t fb[8][4], fs[8][4];  // P^T's fragments, then dS^T's
    frag_acc(fb, fs, sa);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // dV += P^T dO
      const uint64_t otb = desc_trans(cv + 6 * CV, j), ots = desc_trans(cv + 7 * CV, j);
      wgmma_rs<D>(kTwo ? dvr : dva, fs[j], otb);
      wgmma_rs<D>(dva, fb[j], otb);
      wgmma_rs<D>(kTwo ? dvr : dva, fb[j], ots);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dva);
    if (kTwo) fence_regs(dvr);
    fence_regs(fb);
    fence_regs(fs);
    frag_acc(fb, fs, pa);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // dK += dS^T Q
      const uint64_t qtb = desc_trans(cv + 4 * CV, j), qts = desc_trans(cv + 5 * CV, j);
      wgmma_rs<D>(kTwo ? dkr : dka, fs[j], qtb);
      wgmma_rs<D>(dka, fb[j], qtb);
      wgmma_rs<D>(kTwo ? dkr : dka, fb[j], qts);
    }
    wgmma_commit();
    if (kAhead && it + 1 < n_tiles) load_bias(q0 + kTile);  // in flight while the products run
    wgmma_wait0();
    fence_regs(dka);
    if (kTwo) fence_regs(dkr);
    fence_regs(fb);
    fence_regs(fs);
    wg_sync<NT>();  // every warp's products are done before the tiles are rewritten
  }

#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 16 * warp + g + 8 * (i / 2);
      if (key < N) {
        const size_t o = (static_cast<size_t>(bh) * N + key) * D + 8 * j + 2 * t + i % 2;
        store_f(dk + o, (dka[4 * j + i] + dkr[4 * j + i]) * scale);  // dS^T (Q scale)
        store_f(dv + o, dva[4 * j + i] + dvr[4 * j + i]);
      }
    }
}

// ---------------------------------------------------------------- wgmma pass 2
// dQ.  Grid (B, query tiles, H); the warpgroup owns 64 queries and walks
// the key tiles.  Two warpgroups sharing each key tile's conversion run in
// lockstep and overlap less than two blocks do: one warpgroup a block.
template <typename T, int D>
__global__ void __launch_bounds__(160, WgPlan<T, D>::occ(WgPlan<T, D>::dq))
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mdo, const T* __restrict__ bias,
                          const float* __restrict__ lse, const float* __restrict__ drow,
                          T* __restrict__ dq, int H, int N, int G, float scale) {
  using P = WgPlan<T, D>;
  constexpr int CV = P::CV;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  float* own = reinterpret_cast<float*>(wg_smem);  // Qb, Qs, Ob, Os
  float* cv = own + 4 * CV;                        // Kb, Ks, Vb, Vs, KTb, KTs
  unsigned char* ring = reinterpret_cast<unsigned char*>(cv + 6 * CV);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * P::kDqSlot);
  uint64_t* empty = full + kWgStages;
  uint64_t* own_full = full + 2 * kWgStages;

  const int b = blockIdx.x, q0 = blockIdx.y * kTile, h = blockIdx.z;
  const int bh = b * H + h;
  const int tid = threadIdx.x;
  const int n_tiles = (N + kTile - 1) / kTile;
  if (tid == 0) init_bars(full, 128);
  __syncthreads();

  if (tid >= 128) {
    if (tid == 128) {
      mbar_expect_tx(own_full, 2 * P::kRawBytes);
      tma_load_4d(cv, &mq, own_full, 0, q0, 0, bh);
      tma_load_4d(reinterpret_cast<T*>(cv) + P::RAW, &mdo, own_full, 0, q0, 0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kWgStages;
        if (it >= kWgStages) mbar_wait(empty + s, (it / kWgStages - 1) & 1);
        unsigned char* slot = ring + s * P::kDqSlot;
        mbar_expect_tx(full + s, P::kDqSlot);
        tma_load_4d(slot, &mk, full + s, 0, it * kTile, 0, bh);
        tma_load_4d(slot + P::kRawBytes, &mv, full + s, 0, it * kTile, 0, bh);
      }
    }
    return;
  }

  const float sl2 = scale * kLog2e;  // the scores' scale, in powers of 2
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  mbar_wait(own_full, 0);
  split_plain<T, D>(reinterpret_cast<const T*>(cv), own, own + CV, tid);
  split_plain<T, D>(reinterpret_cast<const T*>(cv) + P::RAW, own + 2 * CV, own + 3 * CV, tid);
  fence_proxy_async();
  wg_sync();

  float lr[2], dr[2];  // lse and drow of the rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + 16 * warp + g + 8 * r;
    lr[r] = q < N ? lse[static_cast<size_t>(bh) * N + q] * kLog2e : 0.f;
    dr[r] = q < N ? drow[static_cast<size_t>(bh) * N + q] : 0.f;
  }
  const T* bp = bias + (static_cast<size_t>(b % G) * H + h) * N * N;
  float dqa[D / 2], dqr[D / 2], dqs[D / 2];  // dS K: big x big and each remainder product
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = dqr[i] = dqs[i] = 0.f;

  float bm[32];  // bias[query][key] at the S accumulator's places, a tile ahead
  auto load_bias = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + 16 * warp + g + 8 * (i / 2);
        const int key = k0 + 8 * j + 2 * t + i % 2;
        bm[4 * j + i] = key < N && q < N ? load_f(bp + static_cast<size_t>(q) * N + key) : 0.f;
      }
  };
  load_bias(0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kWgStages;
    const int k0 = it * kTile;
    mbar_wait(full + s, (it / kWgStages) & 1);
    const T* kraw = reinterpret_cast<const T*>(ring + s * P::kDqSlot);
    const T* vraw = kraw + P::RAW;
    split_plain<T, D>(kraw, cv, cv + CV, tid);
    split_plain<T, D>(vraw, cv + 2 * CV, cv + 3 * CV, tid);
    split_trans<T, D>(kraw, cv + 4 * CV, cv + 5 * CV, tid);
    mbar_arrive(empty + s);  // this thread is done with the slot
    fence_proxy_async();
    wg_sync();

    float sa[32], pa[32];  // S = Q K^T, dP = dO V^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint64_t qb = desc_plain(own, kk), qs = desc_plain(own + CV, kk);
      const uint64_t ob = desc_plain(own + 2 * CV, kk), os = desc_plain(own + 3 * CV, kk);
      const uint64_t kb = desc_plain(cv, kk), ks = desc_plain(cv + CV, kk);
      const uint64_t vb = desc_plain(cv + 2 * CV, kk);
      const uint64_t vs = desc_plain(cv + 3 * CV, kk);
      wgmma_ss64(sa, qs, kb, kk > 0);
      wgmma_ss64(pa, os, vb, kk > 0);
      wgmma_ss64(sa, qb, ks, 1);
      wgmma_ss64(pa, ob, vs, 1);
      wgmma_ss64(sa, qb, kb, 1);
      wgmma_ss64(pa, ob, vb, 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sa);
    fence_regs(pa);

#pragma unroll
    for (int j = 0; j < 8; ++j)  // dS into pa (phantom keys 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = exp2_sfu(fmaf(sa[4 * j + i], sl2, fmaf(bm[4 * j + i], kLog2e, -lr[i / 2]))) *
                         (pa[4 * j + i] - dr[i / 2]);
        pa[4 * j + i] = k0 + 8 * j + 2 * t + i % 2 < N ? ds : 0.f;
      }

    uint32_t dab[8][4], das[8][4];
    frag_acc(dab, das, pa);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // dQ += dS K
      const uint64_t ktb = desc_trans(cv + 4 * CV, j), kts = desc_trans(cv + 5 * CV, j);
      wgmma_rs<D>(dqr, das[j], ktb);
      wgmma_rs<D>(dqs, dab[j], kts);
      wgmma_rs<D>(dqa, dab[j], ktb);
    }
    wgmma_commit();
    if (it + 1 < n_tiles) load_bias(k0 + kTile);  // in flight while the products run
    wgmma_wait0();
    fence_regs(dqa);
    fence_regs(dqr);
    fence_regs(dqs);
    fence_regs(dab);
    fence_regs(das);
    wg_sync();
  }

#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + 16 * warp + g + 8 * (i / 2);
      if (q < N) {
        store_f(dq + (static_cast<size_t>(bh) * N + q) * D + 8 * j + 2 * t + i % 2,
                (dqa[4 * j + i] + (dqr[4 * j + i] + dqs[4 * j + i])) * scale);
      }
    }
}

// ---------------------------------------------------------------- wgmma pass 3
// dbias: the sum over the members of each bias group.  Grid (query tiles x
// key blocks of 64 kDbWg, H, G); warpgroup wg keeps the bias and dS sum of
// the query tile x keys 64 wg .. 64 wg + 63 of the block in registers over
// the members b = g, g + G, ... in that order, the next members' tiles in
// flight in the ring.
template <typename T, int D>
__global__ void __launch_bounds__(WgPlan<T, D>::kDbWg * 128 + 32,
                                  WgPlan<T, D>::occ(WgPlan<T, D>::db))
flash_bwd_dbias_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                             const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv,
                             const __grid_constant__ CUtensorMap mdo,
                             const __grid_constant__ CUtensorMap mlse,
                             const __grid_constant__ CUtensorMap mdrow,
                             const T* __restrict__ bias, T* __restrict__ dbias, int B, int H,
                             int N, int G, float scale, int n_q_tiles) {
  using P = WgPlan<T, D>;
  constexpr int CV = P::CV, NWG = P::kDbWg, NT = 128 * NWG;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  float* cv = reinterpret_cast<float*>(wg_smem);  // Qb, Qs, Ob, Os, then Kb, Ks, Vb, Vs a warpgroup
  unsigned char* ring = reinterpret_cast<unsigned char*>(cv + (4 + 4 * NWG) * CV);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * P::kDbSlot);
  uint64_t* empty = full + kWgStages;

  const int q0 = (blockIdx.x % n_q_tiles) * kTile;
  const int kb = blockIdx.x / n_q_tiles * NWG;  // the block's first key tile
  const int h = blockIdx.y, grp = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_members = B / G;
  if (tid == 0) init_bars(full, NT);
  __syncthreads();

  if (tid >= NT) {
    if (tid == NT) {
      for (int m = 0; m < n_members; ++m) {
        const int s = m % kWgStages;
        const int bh = (grp + m * G) * H + h;
        if (m >= kWgStages) mbar_wait(empty + s, (m / kWgStages - 1) & 1);
        unsigned char* slot = ring + s * P::kDbSlot;
        const int v0 = (bh * N + q0) & ~3;
        mbar_expect_tx(full + s, (2 + 2 * NWG) * P::kRawBytes + 2 * kVecBox * 4);
        tma_load_4d(slot, &mq, full + s, 0, q0, 0, bh);
        tma_load_4d(slot + P::kRawBytes, &mdo, full + s, 0, q0, 0, bh);
        for (int w = 0; w < NWG; ++w) {
          unsigned char* kv = slot + (2 + 2 * w) * P::kRawBytes;
          tma_load_4d(kv, &mk, full + s, 0, (kb + w) * kTile, 0, bh);
          tma_load_4d(kv + P::kRawBytes, &mv, full + s, 0, (kb + w) * kTile, 0, bh);
        }
        unsigned char* vec = slot + (2 + 2 * NWG) * P::kRawBytes;
        tma_load_1d(vec, &mlse, full + s, v0);
        tma_load_1d(vec + kVecBytes, &mdrow, full + s, v0);
      }
    }
    return;
  }

  const float sl2 = scale * kLog2e;  // the scores' scale, in powers of 2
  const int wg = tid / 128, warp = tid % 128 / 32, g = (tid % 32) / 4, t = tid % 4;
  const int k0 = (kb + wg) * kTile;  // this warpgroup's keys
  float* kvcv = cv + (4 + 4 * wg) * CV;
  const T* bp = bias + (static_cast<size_t>(grp) * H + h) * N * N;
  float bm[32], dba[32];  // the block's bias and dS sum at the S accumulator's places
  bool ok[32];             // the place holds a real query and key
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + 16 * warp + g + 8 * (i / 2);
      const int key = k0 + 8 * j + 2 * t + i % 2;
      ok[4 * j + i] = key < N && q < N;
      bm[4 * j + i] = ok[4 * j + i] ? load_f(bp + static_cast<size_t>(q) * N + key) : 0.f;
      dba[4 * j + i] = 0.f;
    }

  for (int m = 0; m < n_members; ++m) {
    const int s = m % kWgStages;
    mbar_wait(full + s, (m / kWgStages) & 1);
    const unsigned char* slot = ring + s * P::kDbSlot;
    const T* raw = reinterpret_cast<const T*>(slot);
    const int v_off = ((grp + m * G) * H * N + h * N + q0) & 3;
    const unsigned char* vec = slot + (2 + 2 * NWG) * P::kRawBytes;
    const float* lse_s = reinterpret_cast<const float*>(vec) + v_off;
    const float* drow_s = reinterpret_cast<const float*>(vec + kVecBytes) + v_off;
    split_plain<T, D, NT>(raw, cv, cv + CV, tid);
    split_plain<T, D, NT>(raw + P::RAW, cv + 2 * CV, cv + 3 * CV, tid);
    const T* kvraw = raw + (2 + 2 * wg) * P::RAW;
    split_plain<T, D>(kvraw, kvcv, kvcv + CV, tid % 128);
    split_plain<T, D>(kvraw + P::RAW, kvcv + 2 * CV, kvcv + 3 * CV, tid % 128);
    float lr[2], dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lr[r] = lse_s[16 * warp + g + 8 * r] * kLog2e;
      dr[r] = drow_s[16 * warp + g + 8 * r];
    }
    mbar_arrive(empty + s);  // this thread is done with the slot
    fence_proxy_async();
    wg_sync<NT>();

    float sa[32], pa[32];  // S = Q K^T, dP = dO V^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint64_t qb = desc_plain(cv, kk), qs = desc_plain(cv + CV, kk);
      const uint64_t ob = desc_plain(cv + 2 * CV, kk);
      const uint64_t os = desc_plain(cv + 3 * CV, kk);
      const uint64_t kdb = desc_plain(kvcv, kk), ks = desc_plain(kvcv + CV, kk);
      const uint64_t vb = desc_plain(kvcv + 2 * CV, kk), vs = desc_plain(kvcv + 3 * CV, kk);
      wgmma_ss64(sa, qs, kdb, kk > 0);
      wgmma_ss64(pa, os, vb, kk > 0);
      wgmma_ss64(sa, qb, ks, 1);
      wgmma_ss64(pa, ob, vs, 1);
      wgmma_ss64(sa, qb, kdb, 1);
      wgmma_ss64(pa, ob, vb, 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sa);
    fence_regs(pa);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = exp2_sfu(fmaf(sa[4 * j + i], sl2, fmaf(bm[4 * j + i], kLog2e, -lr[i / 2]))) *
                         (pa[4 * j + i] - dr[i / 2]);
        dba[4 * j + i] += ok[4 * j + i] ? ds : 0.f;
      }
    wg_sync<NT>();
  }

  T* dbp = dbias + (static_cast<size_t>(grp) * H + h) * N * N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + 16 * warp + g + 8 * (i / 2);
      const int key = k0 + 8 * j + 2 * t + i % 2;
      if (q < N && key < N) store_f(dbp + static_cast<size_t>(q) * N + key, dba[4 * j + i]);
    }
}

// ---------------------------------------------------------------- wgmma launch
// cuTensorMapEncodeTiled, looked up in libcuda at first use (the library
// links only the CUDA runtime).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The rows of a [BH, N, D] tensor as a 4D map {E, N, D / E, BH}, E the
// elements of 16 bytes: a box of 64 rows lands as [D / E][64][E], rows past
// N as zeros.
template <typename T>
bool map_rows(CUtensorMap* m, const void* p, int BH, int N, int D) {
  constexpr int E = 16 / sizeof(T);
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(E), static_cast<cuuint64_t>(N),
                        static_cast<cuuint64_t>(D / E), static_cast<cuuint64_t>(BH)};
  cuuint64_t strides[3] = {D * sizeof(T), 16, static_cast<cuuint64_t>(N) * D * sizeof(T)};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(E), static_cast<cuuint32_t>(kTile),
                       static_cast<cuuint32_t>(D / E), 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  return encoder()(m,
                   sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   4, const_cast<void*>(p), dims, strides, box, step,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [n] fp32 vector as a 1D map of kVecBox-element boxes.
bool map_vec(CUtensorMap* m, const void* p, long long n) {
  cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  cuuint64_t strides[1] = {0};
  cuuint32_t box[1] = {static_cast<cuuint32_t>(kVecBox)};
  cuuint32_t step[1] = {1};
  return encoder()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(p), dims, strides,
                   box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// The wgmma design's three launches, in the other designs' order.
template <typename T, int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* bias,
                         const void* dout, const void* lse, const void* drow, void* dq,
                         void* dk, void* dv, void* dbias, int B, int H, int N, int G,
                         cudaStream_t stream) {
  using P = WgPlan<T, D>;
  const int n_tiles = (N + kTile - 1) / kTile;
  const long long rows = static_cast<long long>(B) * H * N;
  if (H > 65535 || n_tiles > 65535 || G > 65535 || rows + kTile > 2147483647LL ||
      static_cast<long long>(n_tiles) * n_tiles > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  if (encoder() == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mdo, ml, mr;
  if (!map_rows<T>(&mq, q, B * H, N, D) || !map_rows<T>(&mk, k, B * H, N, D) ||
      !map_rows<T>(&mv, v, B * H, N, D) || !map_rows<T>(&mdo, dout, B * H, N, D) ||
      !map_vec(&ml, lse, rows) || !map_vec(&mr, drow, rows)) {
    return cudaErrorInvalidValue;
  }
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const T* tb = static_cast<const T*>(bias);
  auto k_dq = flash_bwd_dq_wgmma_kernel<T, D>;
  auto k_db = flash_bwd_dbias_wgmma_kernel<T, D>;
  auto k_dkv = flash_bwd_dkv_wgmma_kernel<T, D>;
  cudaError_t err;
  if ((err = allow_smem(k_dq, P::dq)) != cudaSuccess) return err;
  if ((err = allow_smem(k_db, P::db)) != cudaSuccess) return err;
  if ((err = allow_smem(k_dkv, P::dkv)) != cudaSuccess) return err;

  k_dq<<<dim3(B, n_tiles, H), 160, P::dq, stream>>>(
      mq, mk, mv, mdo, tb, static_cast<const float*>(lse), static_cast<const float*>(drow),
      static_cast<T*>(dq), H, N, G, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n_db_blocks = (n_tiles + P::kDbWg - 1) / P::kDbWg;
  k_db<<<dim3(n_tiles * n_db_blocks, H, G), P::kDbWg * 128 + 32, P::db, stream>>>(
      mq, mk, mv, mdo, ml, mr, tb, static_cast<T*>(dbias), B, H, N, G, scale, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n_key_blocks = (n_tiles + P::kDkvWg - 1) / P::kDkvWg;
  k_dkv<<<dim3(B, n_key_blocks, H), P::kDkvWg * 128 + 32, P::dkv, stream>>>(
      mq, mk, mv, mdo, ml, mr, tb, static_cast<T*>(dk), static_cast<T*>(dv), H, N, G, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_wgmma(int D, const void* q, const void* k, const void* v,
                           const void* bias, const void* dout, const void* lse,
                           const void* drow, void* dq, void* dk, void* dv, void* dbias,
                           int B, int H, int N, int G, cudaStream_t s) {
  switch (D) {
#define FWB_WG_CASE(DD)                                                           \
  case DD:                                                                        \
    return launch_wgmma<T, DD>(q, k, v, bias, dout, lse, drow, dq, dk, dv, dbias, \
                               B, H, N, G, s);
    FWB_WG_CASE(8) FWB_WG_CASE(16) FWB_WG_CASE(24) FWB_WG_CASE(32)
    FWB_WG_CASE(40) FWB_WG_CASE(48)
#undef FWB_WG_CASE
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

// The same backward by the wgmma design, for head dims up to 48 (anything
// else returns cudaErrorInvalidValue); the same arguments.
extern "C" int flash_window_attention_bwd_wgmma(const void* q, const void* k,
                                                const void* v, const void* bias,
                                                const void* dout, const void* lse,
                                                const void* drow, void* dq, void* dk,
                                                void* dv, void* dbias, int B, int H,
                                                int N, int D, int G, int dtype,
                                                void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || G <= 0 || B % G != 0 || D > kWgmmaMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_wgmma<float>(D, q, k, v, bias, dout, lse, drow, dq, dk, dv, dbias,
                                B, H, N, G, s);
  } else if (dtype == 1) {
    err = dispatch_wgmma<__nv_bfloat16>(D, q, k, v, bias, dout, lse, drow, dq, dk, dv,
                                        dbias, B, H, N, G, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
