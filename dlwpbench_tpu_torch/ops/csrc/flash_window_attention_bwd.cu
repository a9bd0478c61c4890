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
// Design, simple and right first: three passes, each with thousands of
// blocks of 128 threads.  A thread owns one row (D <= 32), or a half
// (D <= 64) or a quarter (D <= 128) of one; the parts of a row sum their
// partial dot products with warp shuffles.  Splitting rows keeps the
// dK/dV pass at 4 * D / parts <= 128 fp32 registers of row state.
//  1. dK + dV: one block per (b, key rows, h).  Each thread keeps its key
//     row's k, v and the dk, dv accumulators in registers and walks the
//     query tiles, staging q (pre-scaled), dO, lse, drow and the
//     [query tile, key rows] bias block in shared memory.  Only the tile's
//     real queries are visited, so phantom query rows never contribute.
//  2. dQ: one block per (b, query rows, h), walking the key tiles with k,
//     v and the bias block staged in shared memory; only real keys are
//     visited.
//  3. dbias: one block per (query rows, key tile, h, g).  It loops over
//     the members b = g + m*G, m = 0 .. B/G-1 in that order (one member
//     when G == B), recomputes the member's ds block and sums it in shared
//     memory, then writes the block once.
// No floating-point atomics anywhere, and every sum runs in a fixed
// order: two calls on the same inputs give bit-identical results.
//
// What bounds it on an H100 SXM: at Swin's stage-0 global window
// (B 32, H 4, N 2048, D 24) the least work is the five products,
// 10*B*H*N^2*D = 128.8 GFLOP, on some 337 MB of operands (fp32): far above
// the fp32 ridge of 20 operations per byte, so fp32 operations bound it.
// The passes recompute s and dp (nine products in all instead of five) in
// exchange for parallelism and determinism; tensor cores (wgmma) and TMA
// staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;         // threads per block
constexpr int kTile = 64;             // queries (pass 1) or keys (2, 3) per tile
constexpr int kPitch = kTile + 1;     // +1: conflict-free row-wise access

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// How a row of D head dims is split over threads: TPR threads per row,
// DPT dims each, ROWS rows per block.
template <int D>
struct Split {
  static constexpr int TPR = D <= 32 ? 1 : (D <= 64 ? 2 : 4);
  static constexpr int DPT = D / TPR;
  static constexpr int ROWS = kThreads / TPR;
  static_assert(DPT % 2 == 0, "head-dim slice must be float2 aligned");
};

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
// calls it the same number of times.
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

// ---------------------------------------------------------------- pass 1
// dK + dV.  Grid (B, key row blocks, H).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ bias,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ drow, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int N, int G, float scale) {
  constexpr int TPR = Split<D>::TPR, DPT = Split<D>::DPT, ROWS = Split<D>::ROWS;
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
  constexpr int TPR = Split<D>::TPR, DPT = Split<D>::DPT, ROWS = Split<D>::ROWS;
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
  constexpr int TPR = Split<D>::TPR, DPT = Split<D>::DPT, ROWS = Split<D>::ROWS;
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

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* dout, const void* lse,
                   const void* drow, void* dq, void* dk, void* dv, void* dbias,
                   int B, int H, int N, int G, cudaStream_t stream) {
  constexpr int ROWS = Split<D>::ROWS;
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
