// Building blocks shared by the attention kernels (window_attention_qkv.cu,
// packed_window_attention.cu, flash_window_attention{,_bwd}.cu):
// row-per-thread fp32 arithmetic on shared-memory tiles, the block plan,
// the ordered dbias chunk sum, the 3xTF32 `mma.sync` helpers, the split
// operand tiles of the flash kernels and the fused forward's and
// backward's bodies, templates over each source's addressing.  Each source
// includes this once, so everything here has internal linkage.

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

// ---------------------------------------------------------------- tensor cores
// The fused designs' region: N up to 9 tiles of 16 rows, head dims up to 48.
constexpr int kFusedMaxN = 144;
constexpr int kFusedMaxD = 48;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An fp32 value as a TF32 big part and a TF32 remainder.
struct Split3 {
  uint32_t big, small;
};
__device__ __forceinline__ Split3 split_tf32(float x) {
  const uint32_t b = to_tf32(x);
  return {b, to_tf32(x - __uint_as_float(b))};
}

// d += a b on one m16n8k8 tile from operands already split (3xTF32).
__device__ __forceinline__ void mma_3xtf32_split(float (&d)[4], const uint32_t (&ab)[4],
                                                 const uint32_t (&as)[4],
                                                 const uint32_t (&bb)[2],
                                                 const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

// d += a b on one m16n8k8 tile, fp32-accurate: each operand split into a
// TF32 big part and a TF32 remainder, three products, the small ones first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const float (&a)[4],
                                           const float (&b)[2]) {
  uint32_t ab[4], as[4], bb[2], bs[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ab[i] = to_tf32(a[i]);
    as[i] = to_tf32(a[i] - __uint_as_float(ab[i]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bb[i] = to_tf32(b[i]);
    bs[i] = to_tf32(b[i] - __uint_as_float(bb[i]));
  }
  mma_3xtf32_split(d, ab, as, bb, bs);
}

// Fragments of the m16n8k8 TF32 product, lane = 4 g + t.  A is 16 x 8
// (row-major), B 8 x 8 (k x n), C 16 x 8 with c[i] at row g + 8 (i / 2),
// column 2 t + i % 2.  s is a shared tile of pitch p.
// A[r][c] = s[r0 + r][c0 + c]
__device__ __forceinline__ void frag_a(float (&a)[4], const float* s, int p, int r0,
                                       int c0, int g, int t) {
  a[0] = s[(r0 + g) * p + c0 + t];
  a[1] = s[(r0 + g + 8) * p + c0 + t];
  a[2] = s[(r0 + g) * p + c0 + t + 4];
  a[3] = s[(r0 + g + 8) * p + c0 + t + 4];
}
// A[r][c] = s[c0 + c][r0 + r]
__device__ __forceinline__ void frag_at(float (&a)[4], const float* s, int p, int r0,
                                        int c0, int g, int t) {
  a[0] = s[(c0 + t) * p + r0 + g];
  a[1] = s[(c0 + t) * p + r0 + g + 8];
  a[2] = s[(c0 + t + 4) * p + r0 + g];
  a[3] = s[(c0 + t + 4) * p + r0 + g + 8];
}
// B[k][n] = s[n0 + n][k0 + k]
__device__ __forceinline__ void frag_bt(float (&b)[2], const float* s, int p, int k0,
                                        int n0, int g, int t) {
  b[0] = s[(n0 + g) * p + k0 + t];
  b[1] = s[(n0 + g) * p + k0 + t + 4];
}
// B[k][n] = s[k0 + k][n0 + n]
__device__ __forceinline__ void frag_b(float (&b)[2], const float* s, int p, int k0,
                                       int n0, int g, int t) {
  b[0] = s[(k0 + t) * p + n0 + g];
  b[1] = s[(k0 + t + 4) * p + n0 + g];
}
// s[r0 + r][c0 + c] = C[r][c]
__device__ __forceinline__ void store_c(float* s, int p, int r0, int c0,
                                        const float (&c)[4], int g, int t) {
  *reinterpret_cast<float2*>(s + (r0 + g) * p + c0 + 2 * t) = make_float2(c[0], c[1]);
  *reinterpret_cast<float2*>(s + (r0 + g + 8) * p + c0 + 2 * t) = make_float2(c[2], c[3]);
}

// ---------------------------------------------------------------- split tiles
// Operand tiles staged once already split into their TF32 parts, for the
// flash kernels' tensor-core designs (flash_window_attention{,_bwd}.cu).

// x as a TF32 big part (x with its 13 low mantissa bits cleared) and the
// remainder x - big (exact in fp32), its low bits cleared too: two bit
// masks and a subtraction, where `split_tf32`'s two conversions run on a
// slower pipe.  Truncating instead of rounding leaves the product within
// about 2^-20 of fp32's, far inside every tolerance here.
__device__ __forceinline__ uint2 split2(float x) {
  const uint32_t big = __float_as_uint(x) & 0xffffe000u;
  const float rest = x - __uint_as_float(big);
  return make_uint2(big, __float_as_uint(rest) & 0xffffe000u);
}

// Fragments (lane = 4 g + t, as `frag_a` and friends) of a split tile s of
// pitch p, big parts into *b, remainders into *s.
// A[r][c] = s[r0 + r][c0 + c]
__device__ __forceinline__ void sfrag_a(uint32_t (&ab)[4], uint32_t (&as)[4], const uint2* s,
                                        int p, int r0, int c0, int g, int t) {
  const uint2 x0 = s[(r0 + g) * p + c0 + t], x1 = s[(r0 + g + 8) * p + c0 + t];
  const uint2 x2 = s[(r0 + g) * p + c0 + t + 4], x3 = s[(r0 + g + 8) * p + c0 + t + 4];
  ab[0] = x0.x, ab[1] = x1.x, ab[2] = x2.x, ab[3] = x3.x;
  as[0] = x0.y, as[1] = x1.y, as[2] = x2.y, as[3] = x3.y;
}
// B[k][n] = s[n0 + n][k0 + k]
__device__ __forceinline__ void sfrag_bt(uint32_t (&bb)[2], uint32_t (&bs)[2], const uint2* s,
                                         int p, int k0, int n0, int g, int t) {
  const uint2 x0 = s[(n0 + g) * p + k0 + t], x1 = s[(n0 + g) * p + k0 + t + 4];
  bb[0] = x0.x, bb[1] = x1.x;
  bs[0] = x0.y, bs[1] = x1.y;
}
// B[k][n] = s[k0 + k'][n0 + n], the step's 8 rows k' taken in the order
// 0, 2, 4, 6, 1, 3, 5, 7 (k = t reads row 2t, k = t + 4 row 2t + 1), the
// order `frag_ac` gives the columns of its C fragment.
__device__ __forceinline__ void sfrag_bp(uint32_t (&bb)[2], uint32_t (&bs)[2], const uint2* s,
                                         int p, int k0, int n0, int g, int t) {
  const uint2 x0 = s[(k0 + 2 * t) * p + n0 + g], x1 = s[(k0 + 2 * t + 1) * p + n0 + g];
  bb[0] = x0.x, bb[1] = x1.x;
  bs[0] = x0.y, bs[1] = x1.y;
}
// The C fragment of a 16 x 8 product, its columns taken in that order, as
// the A fragment of the next (a = c0, c2, c1, c3), split.
__device__ __forceinline__ void frag_ac(uint32_t (&ab)[4], uint32_t (&as)[4], const float (&c)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint2 x = split2(a[i]);
    ab[i] = x.x;
    as[i] = x.y;
  }
}

// 2 consecutive elements as fp32 (8-byte fp32 or 4-byte bf16 load: p must
// be aligned to two elements), and their store in the element type.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Floats of the fused backward's [Np, Np + 4] P^T / dS^T tile, which first
// holds O at pitch hd + 1 for the drow sums.
__host__ __device__ constexpr int fused_tile_floats(int Np, int D) {
  return Np * (Np + 4) > Np * (D + 1) ? Np * (Np + 4) : Np * (D + 1);
}

inline size_t fused_smem_bytes(int Np, int D) {
  return sizeof(float) * (4 * Np * (D + 4) + fused_tile_floats(Np, D) + 2 * Np) +
         sizeof(size_t) * Np;
}

// ---------------------------------------------------------------- fused backward
// The body of the fused backward (one tensor-core pass per member), shared
// by the window kernel (window_attention_qkv.cu) and the packed kernel
// (packed_window_attention.cu); its design is described in the former's
// header comment.  It runs for block (chunk c, head h, bias window wb) with
// blockDim 32 * ceil(N / 16) <= 32 * NT and `fused_smem_bytes` of dynamic
// shared memory.  Only the addressing differs between the callers, so it
// is a template over an access policy `Acc`, which gives
//  - N(), heads(), scale(), members() (those sharing one bias window) and
//    groups() (bias windows: dbias's leading dim);
//  - bias_block(wb, h): the bias block of (wb, h); member(t, wb): member t
//    of bias window wb, with its mask block `mask` and its index `m`
//    (its lse row is lse + (m * heads + h) * N, `lse` a field);
//  - row(mb, h, j): token j's row; q/k/v/o/dout(row, h) and
//    dq/dk/dv(row, h): where its head's D values lie;
//  - bm(bp, mp, kr, qc): bias + mask at key kr, query qc;
//  - part_at(kr, qc): where that element of a dbias partial goes.
// Chunk c takes the members [c * per, (c + 1) * per) in order; the chunk's
// dbias sum goes to part[c, wb, h] ([n_chunks, groups, heads, N, N] fp32).
template <typename T, int D, int NT, typename Acc>
__device__ __forceinline__ void fused_bwd_body(const Acc& a, float* __restrict__ part,
                                               int n_chunks) {
  constexpr int DP = D + 4;  // operand pitch: conflict-free A fragments
  constexpr int ND = D / 8;  // 8-wide slices of the head dim
  constexpr int V4 = D / 4;
  const int N = a.N();
  const int nt = blockDim.x / 32;  // 16-row tiles, one warp each
  const int Np = nt * 16;
  const int TP = Np + 4;
  const float scale = a.scale();
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [Np][DP], times scale
  float* k_s = q_s + Np * DP;
  float* v_s = k_s + Np * DP;
  float* do_s = v_s + Np * DP;
  float* t_s = do_s + Np * DP;                   // [key][query], pitch TP
  float* lse_s = t_s + fused_tile_floats(Np, D);
  float* drow_s = lse_s + Np;
  size_t* off_s = reinterpret_cast<size_t*>(drow_s + Np);

  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int wb = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int gq = (threadIdx.x % 32) / 4;
  const int tq = threadIdx.x % 4;
  const int r0 = warp * 16;  // the warp's key rows, then its query rows for dQ
  const T* bp = a.bias_block(wb, h);

  const int n_members = a.members();
  const int per = (n_members + n_chunks - 1) / n_chunks;
  const int t_end = min(n_members, (c + 1) * per);

  float db[NT][2][4];  // dbias of key rows r0 + g (+8) x queries, summed
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) db[j][n][i] = 0.f;

  for (int t = c * per; t < t_end; ++t) {
    const typename Acc::Member mb = a.member(t, wb);
    const T* mp = mb.mask;
    const size_t lbase = (static_cast<size_t>(mb.m) * a.heads() + h) * N;

    __syncthreads();  // the previous member's tiles are consumed
    for (int j = threadIdx.x; j < N; j += blockDim.x) off_s[j] = a.row(mb, h, j);
    __syncthreads();
    for (int i = threadIdx.x; i < Np * V4; i += blockDim.x) {
      const int j = i / V4;
      const int cc = (i % V4) * 4;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 q4 = z, k4 = z, v4 = z, d4 = z, o4 = z;
      if (j < N) {
        q4 = load4(a.q(off_s[j], h) + cc);
        k4 = load4(a.k(off_s[j], h) + cc);
        v4 = load4(a.v(off_s[j], h) + cc);
        d4 = load4(a.dout(off_s[j], h) + cc);
        o4 = load4(a.o(off_s[j], h) + cc);
        q4 = make_float4(q4.x * scale, q4.y * scale, q4.z * scale, q4.w * scale);
      }
      *reinterpret_cast<float4*>(q_s + j * DP + cc) = q4;
      *reinterpret_cast<float4*>(k_s + j * DP + cc) = k4;
      *reinterpret_cast<float4*>(v_s + j * DP + cc) = v4;
      *reinterpret_cast<float4*>(do_s + j * DP + cc) = d4;
      float* o = t_s + j * (D + 1) + cc;
      o[0] = o4.x;
      o[1] = o4.y;
      o[2] = o4.z;
      o[3] = o4.w;
    }
    for (int j = threadIdx.x; j < N; j += blockDim.x) lse_s[j] = a.lse[lbase + j];
    __syncthreads();
    for (int j = threadIdx.x; j < Np; j += blockDim.x) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(do_s[j * DP + d], t_s[j * (D + 1) + d], acc);
      drow_s[j] = acc;
    }
    __syncthreads();  // O is read; the tile is free for P^T and dS^T

    // Key rows r0 .. r0 + 15 against the queries, 16 at a time.
    float dk[ND][4], dv[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;
    // The loop is not unrolled (code size, build time): db[0] is always
    // the current tile's accumulator, and the array rotates one tile a
    // step, NT steps a member, so registers are indexed statically.
#pragma unroll 1
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const int q0 = j * 16;
        float s[2][4], dp[2][4], bm[2][4];  // bm: bias + mask, loaded first
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kr = r0 + gq + 8 * (i / 2);
            const int qc = q0 + 8 * n + 2 * tq + i % 2;
            bm[n][i] = kr < N && qc < N ? a.bm(bp, mp, kr, qc) : 0.f;
            s[n][i] = dp[n][i] = 0.f;
          }
        }
#pragma unroll
        for (int kk = 0; kk < ND; ++kk) {  // S^T = K Q^T, dP^T = V dO^T
          float ak[4], av[4];
          frag_a(ak, k_s, DP, r0, kk * 8, gq, tq);
          frag_a(av, v_s, DP, r0, kk * 8, gq, tq);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            float bq[2], bd[2];
            frag_bt(bq, q_s, DP, kk * 8, q0 + 8 * n, gq, tq);
            frag_bt(bd, do_s, DP, kk * 8, q0 + 8 * n, gq, tq);
            mma_3xtf32(s[n], ak, bq);
            mma_3xtf32(dp[n], av, bd);
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {  // P^T into s, dS^T into dp
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kr = r0 + gq + 8 * (i / 2);
            const int qc = q0 + 8 * n + 2 * tq + i % 2;
            float p = 0.f, ds = 0.f;
            if (kr < N && qc < N) {
              p = expf(s[n][i] + bm[n][i] - lse_s[qc]);
              ds = p * (dp[n][i] - drow_s[qc]);
            }
            s[n][i] = p;
            dp[n][i] = ds;
            db[0][n][i] += ds;
          }
        }
        // dV += P^T dO and dK += dS^T (Q scale), through the warp's own
        // rows of the tile (the C fragments become A fragments there)
#pragma unroll
        for (int n = 0; n < 2; ++n) store_c(t_s, TP, r0, q0 + 8 * n, s[n], gq, tq);
        __syncwarp();
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          float af[4];
          frag_a(af, t_s, TP, r0, q0 + 8 * ks, gq, tq);
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            float bb[2];
            frag_b(bb, do_s, DP, q0 + 8 * ks, n * 8, gq, tq);
            mma_3xtf32(dv[n], af, bb);
          }
        }
        __syncwarp();
#pragma unroll
        for (int n = 0; n < 2; ++n) store_c(t_s, TP, r0, q0 + 8 * n, dp[n], gq, tq);
        __syncwarp();
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          float af[4];
          frag_a(af, t_s, TP, r0, q0 + 8 * ks, gq, tq);
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            float bb[2];
            frag_b(bb, q_s, DP, q0 + 8 * ks, n * 8, gq, tq);
            mma_3xtf32(dk[n], af, bb);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float first = db[0][n][i];
#pragma unroll
          for (int r = 0; r + 1 < NT; ++r) db[r][n][i] = db[r + 1][n][i];
          db[NT - 1][n][i] = first;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = r0 + gq + 8 * (i / 2);
        if (kr < N) {
          const int col = n * 8 + 2 * tq + i % 2;
          store_f(a.dk(off_s[kr], h) + col, dk[n][i]);
          store_f(a.dv(off_s[kr], h) + col, dv[n][i]);
        }
      }
    }
    __syncthreads();  // every warp's dS^T is in the tile

    // dQ of query rows r0 .. r0 + 15 = scale * dS K over all keys
    float dq[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;
    for (int k0 = 0; k0 < Np; k0 += 8) {
      float af[4];
      frag_at(af, t_s, TP, r0, k0, gq, tq);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        float bb[2];
        frag_b(bb, k_s, DP, k0, n * 8, gq, tq);
        mma_3xtf32(dq[n], af, bb);
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qr = r0 + gq + 8 * (i / 2);
        if (qr < N) {
          store_f(a.dq(off_s[qr], h) + n * 8 + 2 * tq + i % 2, dq[n][i] * scale);
        }
      }
    }
  }

  float* pp = part + ((static_cast<size_t>(c) * a.groups() + wb) * a.heads() + h) * N * N;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kr = r0 + gq + 8 * (i / 2);
          const int qc = j * 16 + 8 * n + 2 * tq + i % 2;
          if (kr < N && qc < N) pp[a.part_at(kr, qc)] = db[j][n][i];
        }
      }
    }
  }
}

// ---------------------------------------------------------------- fused forward
// Shared memory of one fused forward block: Q * scale, K, V as fp32
// [Np][D + 4], and the rows' token offsets.
inline size_t fwd_fused_smem_bytes(int Np, int D) {
  return sizeof(float) * 3 * Np * (D + 4) + sizeof(size_t) * Np;
}

// The body of the fused forward (one tensor-core pass per (member, head)),
// shared by the window kernel (window_attention_qkv.cu, whose header
// comment describes the design) and the packed kernel
// (packed_window_attention.cu).  It runs for block (member m, head h) with
// blockDim 32 * ceil(N / 16) <= 32 * NT, one warp per 16 query rows, and
// `fwd_fused_smem_bytes` of dynamic shared memory.  Besides the backward's
// N(), heads(), scale(), row(), q/k/v() and bm(), the access policy gives
//  - fwd_member(m): member m, with its mask block `mask` and its index `m`
//    (its lse row is lse_out() + (m * heads + h) * N);
//  - fwd_bias(mb, h): the bias block of member mb, head h;
//  - out_at(row, h): where the head's D output values of a row go.
template <typename T, int D, int NT, typename Acc>
__device__ __forceinline__ void fused_fwd_body(const Acc& a) {
  constexpr int DP = D + 4;  // operand pitch: conflict-free fragments
  constexpr int ND = D / 8;  // 8-wide slices of the head dim
  constexpr int V4 = D / 4;
  const int N = a.N();
  const int nt = blockDim.x / 32;
  const int Np = nt * 16;
  const float scale = a.scale();
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [Np][DP], times scale
  float* k_s = q_s + Np * DP;
  float* v_s = k_s + Np * DP;
  size_t* off_s = reinterpret_cast<size_t*>(v_s + Np * DP);

  const typename Acc::Member mb = a.fwd_member(blockIdx.x);
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int gq = (threadIdx.x % 32) / 4;
  const int tq = threadIdx.x % 4;
  const int r0 = warp * 16;  // the warp's query rows
  const T* bp = a.fwd_bias(mb, h);
  const T* mp = mb.mask;

  for (int j = threadIdx.x; j < N; j += blockDim.x) off_s[j] = a.row(mb, h, j);
  __syncthreads();
  for (int i = threadIdx.x; i < Np * V4; i += blockDim.x) {
    const int j = i / V4;
    const int cc = (i % V4) * 4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 q4 = z, k4 = z, v4 = z;
    if (j < N) {
      q4 = load4(a.q(off_s[j], h) + cc);
      k4 = load4(a.k(off_s[j], h) + cc);
      v4 = load4(a.v(off_s[j], h) + cc);
      q4 = make_float4(q4.x * scale, q4.y * scale, q4.z * scale, q4.w * scale);
    }
    *reinterpret_cast<float4*>(q_s + j * DP + cc) = q4;
    *reinterpret_cast<float4*>(k_s + j * DP + cc) = k4;
    *reinterpret_cast<float4*>(v_s + j * DP + cc) = v4;
  }

  // The scores of query rows r0 + g (+8) against every key, 16 keys a
  // tile, start as bias + mask (-inf past N); their loads are issued
  // before the barrier, so they overlap the staging.
  float s[NT][2][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qr = r0 + gq + 8 * (i / 2);
        const int kc = j * 16 + 8 * n + 2 * tq + i % 2;
        s[j][n][i] = kc >= N ? -INFINITY : (qr < N ? a.bm(bp, mp, kc, qr) : 0.f);
      }
    }
  }
  __syncthreads();

  // S += (Q scale) K^T: each Q fragment split once, used for every key tile
#pragma unroll
  for (int kk = 0; kk < ND; ++kk) {
    float af[4];
    frag_a(af, q_s, DP, r0, kk * 8, gq, tq);
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Split3 x = split_tf32(af[i]);
      ab[i] = x.big;
      as[i] = x.small;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float bk[2];
          frag_bt(bk, k_s, DP, kk * 8, j * 16 + 8 * n, gq, tq);
          const Split3 b0 = split_tf32(bk[0]), b1 = split_tf32(bk[1]);
          const uint32_t bb[2] = {b0.big, b1.big}, bs[2] = {b0.small, b1.small};
          mma_3xtf32_split(s[j][n], ab, as, bb, bs);
        }
      }
    }
  }

  // The full-row softmax in registers: rows g and g + 8 of the warp's
  // tile, each spread over the quad's 4 lanes.
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i / 2] = fmaxf(mx[i / 2], s[j][n][i]);
      }
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][n][i] = expf(s[j][n][i] - mx[i / 2]);
          sum[i / 2] += s[j][n][i];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }

  // O = P V.  The keys of each 8-key step are taken in the order 0, 2, 4,
  // 6, 1, 3, 5, 7, so the C fragment of P is its A fragment as it stands
  // (a = c0, c2, c1, c3) and no shuffle or shared tile is needed; V's B
  // fragment reads the same order.
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float pa[4] = {s[j][n][0], s[j][n][2], s[j][n][1], s[j][n][3]};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const Split3 x = split_tf32(pa[i]);
          ab[i] = x.big;
          as[i] = x.small;
        }
        const float* vr = v_s + (j * 16 + 8 * n + 2 * tq) * DP + gq;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          const Split3 b0 = split_tf32(vr[nd * 8]), b1 = split_tf32(vr[DP + nd * 8]);
          const uint32_t bb[2] = {b0.big, b1.big}, bs[2] = {b0.small, b1.small};
          mma_3xtf32_split(o[nd], ab, as, bb, bs);
        }
      }
    }
  }

  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = r0 + gq + 8 * (i / 2);
      if (qr < N) store_f(a.out_at(off_s[qr], h) + nd * 8 + 2 * tq + i % 2, o[nd][i] * inv[i / 2]);
    }
  }
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = r0 + gq + 8 * r;
      if (qr < N) {
        a.lse_out()[(static_cast<size_t>(mb.m) * a.heads() + h) * N + qr] = mx[r] + logf(sum[r]);
      }
    }
  }
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

// The head dims the fused designs take (multiples of 8 to kFusedMaxD).
#define FUSED_HEAD_DIMS(X) X(8) X(16) X(24) X(32) X(40) X(48)
