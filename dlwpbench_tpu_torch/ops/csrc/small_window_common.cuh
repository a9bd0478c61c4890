// Building blocks shared by the small-window attention kernels
// (window_attention_qkv.cu, packed_window_attention.cu): row-per-thread
// fp32 arithmetic on shared-memory tiles, the block plan and the ordered
// dbias chunk sum.  Each source includes this once, so everything here has
// internal linkage.

#pragma once

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

// dbias = sum over the chunks of part ([n_chunks, n] fp32), in chunk order.
template <typename T>
__global__ void dbias_chunk_sum_kernel(const float* __restrict__ part,
                                       T* __restrict__ dbias, size_t n,
                                       int n_chunks) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) acc += part[c * n + i];
    store_f(dbias + i, acc);
  }
}

template <typename T>
cudaError_t launch_dbias_chunk_sum(const float* part, T* dbias, size_t n,
                                   int n_chunks, cudaStream_t stream) {
  const int blocks = static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  dbias_chunk_sum_kernel<T><<<blocks, 256, 0, stream>>>(part, dbias, n, n_chunks);
  return cudaGetLastError();
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Rows per block and the block's threads (whole warps), into a geometry
// with fields N, rows, n_tiles and scale.
template <int D, typename Geom>
void plan_rows(Geom& g, int& threads) {
  constexpr int TPR = Split<D>::TPR;
  const int rmax = kMaxRows < kMaxThreads / TPR ? kMaxRows : kMaxThreads / TPR;
  g.n_tiles = (g.N + rmax - 1) / rmax;
  g.rows = (g.N + g.n_tiles - 1) / g.n_tiles;
  threads = (g.rows * TPR + 31) / 32 * 32;
  g.scale = 1.f / sqrtf(static_cast<float>(D));
}

}  // namespace

// One switch over the head dims the kernels take (multiples of 8 to 128).
#define SMALL_WINDOW_HEAD_DIMS(X)                                         \
  X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(72) X(80) X(88) X(96) \
  X(104) X(112) X(120) X(128)
