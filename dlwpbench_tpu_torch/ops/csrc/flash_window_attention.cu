// Flash window attention, forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels behind `_flash_impl` in
// dlwpbench_tpu/ops/pallas_attention.py: `_attn_kernel_panel` (resident
// K/V panels, 128-aligned N) and `_attn_kernel` (streamed K/V blocks, any
// N).  Per batch member b and head h it computes
//
//     O[b,h]   = softmax(Q[b,h] K[b,h]^T * D^-1/2 + bias[b % G, h]) V[b,h]
//     lse[b,h] = logsumexp over keys of the same scores      ([B,H,1,N] f32)
//
// with the online-softmax recurrence, so the [N, N] score matrix never
// reaches device memory.  q, k, v, out are [B,H,N,D] row-major; bias is
// [G,H,N,N] (the wrapper views a 3D [H,N,N] bias as G = 1).  Inputs are
// fp32 or bf16 (bias in the same type); scores, statistics and the
// accumulator are fp32; out is written in the input type.  Both designs
// launch one block of 128 threads per (b, query tile, h), b fastest, so
// the members that share a bias tile run together and read it from L2;
// the block walks the keys in tiles of 64 in place of the Pallas grid's
// sequential k axis.  The key tail (N not a multiple of 64) is zero-filled
// in shared memory and its scores set to -inf; query rows past N compute
// on zeros and write nothing.  No operand is padded on the host, no atomic
// is used, and every sum runs in a fixed order: two calls on the same
// inputs give bit-identical results.
//
// Two designs, chosen by shape before the launch (the wrapper's
// `fwd_route(N, D)`):
//
//  mma   D <= 64 (every model path: Swin D 24 and 48, Pangu's flash route
//        D 32), any N.  FlashAttention-2 on the tensor cores: `mma.sync`
//        m16n8k8 TF32 with the 3xTF32 split (a.b ~ a_small b_big + a_big
//        b_small + a_big b_big, fp32 accumulation: fp32-accurate).  4 warps
//        of 16 query rows; each warp keeps its rows' Q * D^-1/2 * log2(e)
//        as split A fragments in registers for the whole walk, so the
//        scores are in base 2 and each exp is one exp2.  The next key
//        tile's K and V are copied into shared memory by cp.async while the
//        current tile computes, then split once into {big, small} pairs at
//        pitch D + 4, so no product converts a staged operand.  The tile
//        goes 32 keys a step: the step's bias is read from L2 into
//        registers in the C layout (pairs along the keys) ahead of its
//        product, S = (Q scale) K^T runs in C fragments, the running max of
//        each row is reduced over the 4 lanes that share it, and
//        P = exp2(S - m) goes on as the A fragment of P V as it stands, by
//        taking each 8-key step in the order 0, 2, 4, 6, 1, 3, 5, 7 (V's B
//        fragment reads its rows in the same order), so no [N, N] tile is
//        ever in shared memory.  Each step's P V starts from zero and is
//        added to the rescaled O in fp32 (O = O alpha + P V), so the tensor
//        cores' accumulation, which rounds less carefully than an fp32 FMA,
//        sums 32 keys and not all N.  Each lane keeps a partial row sum,
//        reduced over the quad once at the end.  bf16 inputs are staged as
//        fp32 and take the same path; a bf16 value is exact in TF32, so K's
//        and V's small parts are 0 and the products by them are skipped
//        (2 mma a product, not 3).  Shared memory 64 (D + 4) x 16 B of split
//        tiles + 64 D x 8 B of copies (fp32): 40.9 KB at D 24, 77.8 KB at
//        D 48, 102.4 KB at D 64.
//  rows  D > 64 (up to 128), on the fp32 CUDA cores: a thread owns one
//        query row (D <= 64) or half of one (the halves sum their partial
//        dot products with one warp shuffle) and keeps that row's q slice,
//        accumulator and (m, l) in registers; K, V and the tile's [rows,
//        64] bias block are staged in shared memory as fp32 and read as
//        float4 broadcasts; inside a tile keys go 16 at a time.
//
// What bounds it on an H100 SXM: at Swin's stage-0 global window
// (B 32, H 4, N 2048, D 24) one launch does 4*B*H*N^2*D = 51.5 GFLOP on
// 169 MB of q, k, v, out, bias and lse (fp32): 0.31 ms at the 3xTF32 rate
// of 165 TFLOP/s (495 / 3) against 0.05 ms of bytes, so operations bound
// it.  At D 24 a score costs as many exp, max and split instructions as
// it costs `mma.sync`, and each step's chain (bias, S, max, exp2, P V)
// runs on 12 warps an SM (3 blocks at about 140 registers): latency, not
// the tensor cores, sets the pace.  Each block also reads the bias row
// panel of its 64 queries from L2 (the members that share it run
// together).  `wgmma` with both split operands in shared memory, TMA
// staging and a ping-pong of the softmax against the products of two
// warp groups are the way past it.

#include <type_traits>

#include "small_window_common.cuh"

namespace {

constexpr int kThreads = 128;  // threads per block, both designs: 4 warps
constexpr int kBiasStride = kTile + 1;  // +1: conflict-free row reads

// ---------------------------------------------------------------- rows
// T: element type of q, k, v, bias and out.  D: head dim.  TPR: threads
// per query row (1 or 2); each holds DPT = D / TPR consecutive head dims.
template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ lse,
                 int H, int N, int G, float scale) {
  constexpr int DPT = D / TPR;
  constexpr int ROWS = kThreads / TPR;
  static_assert(DPT % 4 == 0, "head-dim slice must be float4 aligned");

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kTile][D]
  float* v_s = k_s + kTile * D;                  // [kTile][D]
  float* b_s = v_s + kTile * D;                  // [ROWS][kBiasStride]

  const int b = blockIdx.x;
  const int row0 = blockIdx.y * ROWS;
  const int h = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int d0 = (tid % TPR) * DPT;
  const int row = row0 + r;
  const bool row_ok = row < N;

  const size_t bh = static_cast<size_t>(b) * H + h;
  const T* qp = q + bh * N * D;
  const T* kp = k + bh * N * D;
  const T* vp = v + bh * N * D;
  const T* bp = bias + (static_cast<size_t>(b % G) * H + h) * N * N;

  float qr[DPT];
  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) {
    qr[d] = row_ok ? load_f(qp + static_cast<size_t>(row) * D + d0 + d) * scale
                   : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    const int kn = min(kTile, N - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kTile * D; i += kThreads) {
      const bool ok = i < kn * D;
      const size_t g = static_cast<size_t>(k0) * D + i;
      k_s[i] = ok ? load_f(kp + g) : 0.f;
      v_s[i] = ok ? load_f(vp + g) : 0.f;  // zero rows: p = 0 times 0
    }
    for (int i = tid; i < ROWS * kTile; i += kThreads) {
      const int rr = i / kTile;
      const int cc = i % kTile;
      const int grow = row0 + rr;
      b_s[rr * kBiasStride + cc] =
          (grow < N && cc < kn)
              ? load_f(bp + static_cast<size_t>(grow) * N + k0 + cc)
              : 0.f;
    }
    __syncthreads();

    for (int c0 = 0; c0 < kn; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = k_s + (c0 + j) * D + d0;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DPT; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + d);
          dot = fmaf(qr[d], kk.x, dot);
          dot = fmaf(qr[d + 1], kk.y, dot);
          dot = fmaf(qr[d + 2], kk.z, dot);
          dot = fmaf(qr[d + 3], kk.w, dot);
        }
#pragma unroll
        for (int o = 1; o < TPR; o <<= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        }
        const float sv =
            (c0 + j < kn) ? dot + b_s[r * kBiasStride + c0 + j] : -INFINITY;
        s[j] = sv;
        cmax = fmaxf(cmax, sv);
      }
      // every chunk holds at least one real key, so m_new is finite and
      // the first chunk's alpha is exp(-inf) = 0
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
        const float* vr = v_s + (c0 + j) * D + d0;
#pragma unroll
        for (int d = 0; d < DPT; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + d);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float inv_l = 1.f / l;
    T* op = out + bh * N * D + static_cast<size_t>(row) * D + d0;
#pragma unroll
    for (int d = 0; d < DPT; ++d) store_f(op + d, acc[d] * inv_l);
    if (d0 == 0) lse[bh * N + row] = m + logf(l);
  }
}

// ---------------------------------------------------------------- mma
constexpr int kMmaMaxD = 64;
constexpr int kSteps = 4;  // 8-key column tiles per online-softmax step: 32 keys
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A copy of BYTES (16 or 8) from device to shared memory that bypasses the
// registers; ok == false writes zeros and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// A 64-row tile of a [rows, D] operand copied as it is into shared memory
// (`load`, by cp.async, 4 elements a copy), then split into its TF32
// parts at pitch D + 4 (`split`).  Each thread splits the elements it
// copied, so its own cp_async_wait_all() is all `split` waits for.
template <typename T, int D>
struct RawTile {
  static constexpr int V4 = D / 4;                   // copies per row
  static constexpr int PER = kTile * V4 / kThreads;  // copies per thread: D / 8
  // rows [0, n) of src (row stride D) into raw[kTile][D], zeros past n
  __device__ __forceinline__ static void load(T* raw, const T* src, int n) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int j = i / V4, c = (i % V4) * 4;
      cp_async<4 * sizeof(T)>(raw + j * D + c, j < n ? src + static_cast<size_t>(j) * D + c : src,
                              j < n);
    }
  }
  __device__ __forceinline__ static void split(uint2* dst, const T* raw) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int j = i / V4, c = (i % V4) * 4;
      const float4 x = load4(raw + j * D + c);
      const uint2 a = split2(x.x), b = split2(x.y), e = split2(x.z), f = split2(x.w);
      uint4* d = reinterpret_cast<uint4*>(dst + j * (D + 4) + c);
      d[0] = make_uint4(a.x, a.y, b.x, b.y);
      d[1] = make_uint4(e.x, e.y, f.x, f.y);
    }
  }
};

// d += a b on one m16n8k8 tile from split operands; kExactB: b is exact
// in TF32 (its small part is 0), so its product is skipped.
template <bool kExactB>
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                          const uint32_t (&bs)[2]) {
  if constexpr (kExactB) {
    mma_tf32(d, as, bb);
    mma_tf32(d, ab, bb);
  } else {
    mma_3xtf32_split(d, ab, as, bb, bs);
  }
}

// Grid (B, query tiles, H); warp w owns query rows 16w .. 16w + 15 of the
// tile.  pair: the bias rows can be read two elements at a time (N even,
// bias aligned to two elements).  At least 1 block an SM: without the
// bound ptxas capped some instances at 128 registers and spilled.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ bias,
                     T* __restrict__ out, float* __restrict__ lse, int H, int N,
                     int G, float scale, bool pair) {
  constexpr int P = D + 4, ND = D / 8;
  constexpr bool kExactB = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ uint4 smem_u4[];
  uint2* k_s = reinterpret_cast<uint2*>(smem_u4);  // [kTile][P]: the key tile, split
  uint2* v_s = k_s + kTile * P;
  T* k_raw = reinterpret_cast<T*>(v_s + kTile * P);  // [kTile][D]: the next key tile
  T* v_raw = k_raw + kTile * D;

  const int b = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int h = blockIdx.z;
  const int tid = threadIdx.x;
  const int gq = (tid % 32) / 4, tq = tid % 4;
  const int rows[2] = {q0 + (tid / 32) * 16 + gq, q0 + (tid / 32) * 16 + gq + 8};
  const size_t bh = static_cast<size_t>(b) * H + h;
  const T* kp = k + bh * N * D;
  const T* vp = v + bh * N * D;
  const T* bp = bias + (static_cast<size_t>(b % G) * H + h) * N * N;

  RawTile<T, D>::load(k_raw, kp, min(kTile, N));
  RawTile<T, D>::load(v_raw, vp, min(kTile, N));
  cp_async_commit();

  // the warp's rows of Q * scale * log2(e) as split A fragments (A[r][c]
  // at row g + 8 (i % 2), column t + 4 (i / 2)), zeros past N: the scores
  // are kept in base 2, so each exp is one exp2
  const float qmul = scale * kLog2e;
  uint32_t qb[ND][4], qs[ND][4];
#pragma unroll
  for (int kk = 0; kk < ND; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rows[i % 2];
      const float x =
          row < N ? load_f(q + (bh * N + row) * D + kk * 8 + tq + 4 * (i / 2)) * qmul : 0.f;
      const uint2 sp = split2(x);
      qb[kk][i] = sp.x;
      qs[kk][i] = sp.y;
    }
  }

  // bias of the step of 32 keys from kb (C layout: rows g, g + 8, keys
  // 2t, 2t + 1 of each 8-key tile), -inf past N, 0 on phantom rows
  auto load_bias = [&](float (&bm)[kSteps][4], int kb) {
#pragma unroll
    for (int n = 0; n < kSteps; ++n) {
      const int kc = kb + 8 * n + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool row_ok = rows[r] < N;
        const T* br = bp + static_cast<size_t>(rows[r]) * N + kc;
        float2 x = make_float2(-INFINITY, -INFINITY);
        if (pair) {  // N even: kc < N implies kc + 1 < N
          if (kc < N) x = row_ok ? load2(br) : make_float2(0.f, 0.f);
        } else {
          if (kc < N) x.x = row_ok ? load_f(br) : 0.f;
          if (kc + 1 < N) x.y = row_ok ? load_f(br + 1) : 0.f;
        }
        bm[n][2 * r] = x.x;
        bm[n][2 * r + 1] = x.y;
      }
    }
  };

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};              // this lane's share of their sums

  for (int k0 = 0; k0 < N; k0 += kTile) {
    const int kn = min(kTile, N - k0);
    cp_async_wait_all();
    __syncthreads();  // the previous tile is consumed
    RawTile<T, D>::split(k_s, k_raw);
    RawTile<T, D>::split(v_s, v_raw);
    __syncthreads();
    if (k0 + kTile < N) {  // the next tile's copies run during this one's products
      const int nn = min(kTile, N - k0 - kTile);
      RawTile<T, D>::load(k_raw, kp + static_cast<size_t>(k0 + kTile) * D, nn);
      RawTile<T, D>::load(v_raw, vp + static_cast<size_t>(k0 + kTile) * D, nn);
      cp_async_commit();
    }

    for (int j0 = 0; j0 < kn; j0 += 8 * kSteps) {  // every step holds a real key
      float bm[kSteps][4];  // in flight during the product
      load_bias(bm, k0 + j0);
      float s[kSteps][4];  // S = (Q scale) K^T, base 2
#pragma unroll
      for (int n = 0; n < kSteps; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
#pragma unroll
        for (int n = 0; n < kSteps; ++n) {
          uint32_t bb[2], bs[2];
          sfrag_bt(bb, bs, k_s, P, kk * 8, j0 + 8 * n, gq, tq);
          mma_split<kExactB>(s[n], qb[kk], qs[kk], bb, bs);
        }
      }

      // online softmax: the step's row max over the quad's 4 lanes
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[n][i] = fmaf(bm[n][i], kLog2e, s[n][i]);
          mx[i / 2] = fmaxf(mx[i / 2], s[n][i]);
        }
      }
      float base[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row whose scores are all -inf so far keeps p = 0, not NaN
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
        alpha[r] = exp2f(m[r] - base[r]);  // 0 on the first step
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[n][i] = exp2f(s[n][i] - base[i / 2]);
          l[i / 2] += s[n][i];
        }
      }

      // the step's P V, P's C fragment as the A fragment (keys 0,2,4,6,1,
      // 3,5,7), into a fresh accumulator: the tensor cores sum only the
      // step's 32 keys, and O = O alpha + P V runs in fp32
      float pv[ND][4];
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[nd][i] = 0.f;
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        uint32_t pb[4], ps[4];
        frag_ac(pb, ps, s[n]);
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          uint32_t bb[2], bs[2];
          sfrag_bp(bb, bs, v_s, P, j0 + 8 * n, nd * 8, gq, tq);
          mma_split<kExactB>(pv[nd], pb, ps, bb, bs);
        }
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[nd][i] = fmaf(o[nd][i], alpha[i / 2], pv[nd][i]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rows[r] < N) {
      const float inv = 1.f / l[r];
      T* op = out + (bh * N + rows[r]) * D + 2 * tq;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        store2(op + nd * 8, o[nd][2 * r] * inv, o[nd][2 * r + 1] * inv);
      }
      if (tq == 0) lse[bh * N + rows[r]] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

// ---------------------------------------------------------------- launch
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, void* lse, int B, int H,
                   int N, int G, cudaStream_t stream) {
  constexpr int TPR = D <= 64 ? 1 : 2;
  constexpr int ROWS = kThreads / TPR;
  const size_t smem =
      sizeof(float) * (2 * kTile * D + ROWS * kBiasStride);
  auto kernel = flash_fwd_kernel<T, D, TPR>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (N + ROWS - 1) / ROWS, H);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(bias),
      static_cast<T*>(out), static_cast<float*>(lse), H, N, G,
      1.f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* bias,
                       void* out, void* lse, int B, int H, int N, int G,
                       cudaStream_t stream) {
  // split K and V tiles, and the next tiles as they are
  const size_t smem = 2 * sizeof(uint2) * kTile * (D + 4) + 2 * sizeof(T) * kTile * D;
  auto kernel = flash_fwd_mma_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (N + kTile - 1) / kTile, H);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  const bool pair = N % 2 == 0 && reinterpret_cast<uintptr_t>(bias) % (2 * sizeof(T)) == 0;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), static_cast<T*>(out), static_cast<float*>(lse), H, N, G,
      1.f / sqrtf(static_cast<float>(D)), pair);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* bias, void* out, void* lse, int B, int H,
                     int N, int G, cudaStream_t s) {
  switch (D) {
#define FWA_CASE(DD) \
  case DD:           \
    return launch<T, DD>(q, k, v, bias, out, lse, B, H, N, G, s);
    SMALL_WINDOW_HEAD_DIMS(FWA_CASE)
#undef FWA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_mma(int D, const void* q, const void* k, const void* v,
                         const void* bias, void* out, void* lse, int B, int H,
                         int N, int G, cudaStream_t s) {
  switch (D) {
#define FWA_MMA_CASE(DD) \
  case DD:               \
    return launch_mma<T, DD>(q, k, v, bias, out, lse, B, H, N, G, s);
    FWA_MMA_CASE(8) FWA_MMA_CASE(16) FWA_MMA_CASE(24) FWA_MMA_CASE(32)
    FWA_MMA_CASE(40) FWA_MMA_CASE(48) FWA_MMA_CASE(56) FWA_MMA_CASE(64)
#undef FWA_MMA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); launches on `stream`, never synchronises.
extern "C" int flash_window_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* bias,
                                          void* out, void* lse, int B, int H,
                                          int N, int D, int G, int dtype,
                                          void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || G <= 0 || B % G != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(D, q, k, v, bias, out, lse, B, H, N, G, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(D, q, k, v, bias, out, lse, B, H, N, G, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The same forward by the mma design, for head dims up to 64 (anything
// else returns cudaErrorInvalidValue); the same arguments.  K and V are
// read 4 elements at a time, so k and v must be aligned to 4 elements
// (cudaErrorMisalignedAddress otherwise).
extern "C" int flash_window_attention_fwd_mma(const void* q, const void* k,
                                              const void* v, const void* bias,
                                              void* out, void* lse, int B, int H,
                                              int N, int D, int G, int dtype,
                                              void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || G <= 0 || B % G != 0 || D > kMmaMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t align = 4 * (dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16));
  if (reinterpret_cast<uintptr_t>(k) % align || reinterpret_cast<uintptr_t>(v) % align) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_mma<float>(D, q, k, v, bias, out, lse, B, H, N, G, s);
  } else if (dtype == 1) {
    err = dispatch_mma<__nv_bfloat16>(D, q, k, v, bias, out, lse, B, H, N, G, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
