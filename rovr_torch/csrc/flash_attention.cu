// K2-K4: flash attention, forward (K2), dq (K3) and dk/dv (K4), bf16
// q/k/v/dO in the (B*H, L, D) layout, f32 accumulation, f32 LSE.
//
// Replaces rovr_tpu/ops/pallas/attention.py: `_fwd_kernel` (K2), `_dq_kernel`
// (K3) and `_dkv_kernel` (K4). Same arithmetic, not the same layout: the TPU
// kernels ran on copies padded to D = 128 lanes and a block multiple of L,
// with LSE and delta broadcast over 128 lanes. Here nothing is padded on the
// host. A tile's rows past L and columns past D are zero-filled in the copy
// to shared memory (a 16-byte cp.async with source size 0), keys past Lk are
// masked in the kernel, and LSE and delta are plain (B*H, Lq) f32 rows.
//
//   K2: one block per (b*h, 64-query tile); 4 warps of 16 query rows each.
//       K/V tiles of 64 keys stream through a 2-stage cp.async ring. S = Q K^T
//       and O += P V run on bf16 mma.sync.m16n8k16 with f32 accumulators; the
//       online softmax (running max m, sum l, rescale of O) stays in f32
//       registers in the log2 domain; P is rounded to bf16 for the PV product.
//       Outputs O (bf16) and LSE = m + log(l) (f32, natural log).
//   K3: one block per (b*h, 64-query tile), streaming K/V tiles; recomputes
//       P = exp(S - LSE), dP = dO V^T, dS = P (dP - delta), dQ += dS K.
//   K4: one block per (b*h, 64-key tile), streaming Q/dO tiles with their LSE
//       and delta rows; P^T, dV += P^T dO, dP^T = V dO^T, dS^T, dK += dS^T Q.
//   Each output element is written by one block: no atomics, deterministic.
//
// What bounds them on an H100: at the PPO shape (2048 heads x 256 x 64) each
// does 34-69 GFLOP on 270-406 MB, about 128 operations per byte, under the
// ~295 where the bf16 tensor cores become the limit: device memory bounds
// them. The design reads each operand tile once per block from device memory
// (Q once per query block, K/V once per key block) and keeps S, P and dS in
// registers, never in device memory. It is the simple version (mma.sync, no
// wgmma or TMA, K/V read by every query block of a head).
//
// The C fragments of S are reused as the A fragments of P (and dS) for the
// second product: the m16n8k16 accumulator of two neighbouring n8 tiles holds
// exactly the bf16 A fragment of their 16 columns.
//
// Requirements (checked by the Python wrapper): bf16 q/k/v/dO, f32 lse and
// delta, contiguous, 16-byte aligned, 1 <= D <= 256. D % 8 == 0 takes the
// cp.async path; any other D is copied element by element.
//
// Built by rovr_torch/ops/cuda_build.py (nvcc, sm_90a, plain C interface).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BR = 64;        // rows of the block's own tile (4 warps x 16)
constexpr int BC = 64;        // rows of each streamed tile
constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DP>
struct Tile {
  static constexpr int LD = DP + 8;     // padded row: fragments hit distinct banks
  static constexpr int ELEMS = BR * LD;
  static constexpr int BYTES = ELEMS * int(sizeof(bf16));
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// p[0] in the low half, p[ld] in the high half
__device__ __forceinline__ uint32_t ld_pair(const bf16* p, int ld) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + ld);
  return lo | (hi << 16);
}

// A fragment: rows r0..r0+15, columns c0..c0+15 of a row-major tile.
// Lane (g = lane/4, t = lane%4) holds rows g, g+8 and columns 2t, 2t+1, 2t+8, 2t+9.
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* s, int ld, int r0,
                                       int c0, int g, int t) {
  a[0] = ld32(s + (r0 + g) * ld + c0 + 2 * t);
  a[1] = ld32(s + (r0 + g + 8) * ld + c0 + 2 * t);
  a[2] = ld32(s + (r0 + g) * ld + c0 + 8 + 2 * t);
  a[3] = ld32(s + (r0 + g + 8) * ld + c0 + 8 + 2 * t);
}

// B fragment with B[k][n] = tile[n0 + n][k0 + k]: the tile's rows are B's columns.
__device__ __forceinline__ void frag_bt(uint32_t* b, const bf16* s, int ld, int n0,
                                        int k0, int g, int t) {
  b[0] = ld32(s + (n0 + g) * ld + k0 + 2 * t);
  b[1] = ld32(s + (n0 + g) * ld + k0 + 8 + 2 * t);
}

// B fragment with B[k][n] = tile[k0 + k][n0 + n].
__device__ __forceinline__ void frag_b(uint32_t* b, const bf16* s, int ld, int k0,
                                       int n0, int g, int t) {
  b[0] = ld_pair(s + (k0 + 2 * t) * ld + n0 + g, ld);
  b[1] = ld_pair(s + (k0 + 2 * t + 8) * ld + n0 + g, ld);
}

// A fragment of columns 16kk..16kk+15 from f32 accumulators c[n][4] (C layout).
__device__ __forceinline__ void frag_a_acc(uint32_t* a, const float (*c)[4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Rows [0, 64) x columns [0, DP) of a row-major (rows_valid x D) bf16 matrix
// into a tile; zeros past rows_valid and past D.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int rows_valid,
                                          int D, bool vec) {
  constexpr int LD = Tile<DP>::LD;
  if (vec) {
    constexpr int CH = DP / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < BR * CH; i += THREADS) {
      const int r = i / CH, c = i - (i / CH) * CH;
      const bool ok = r < rows_valid && c * 8 < D;
      cp_async16(s + r * LD + c * 8, ok ? g + size_t(r) * D + c * 8 : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < BR * DP; i += THREADS) {
      const int r = i / DP, c = i - (i / DP) * DP;
      s[r * LD + c] = (r < rows_valid && c < D) ? g[size_t(r) * D + c]
                                                 : __float2bfloat16(0.0f);
    }
  }
}

// 64 f32 row statistics (LSE or delta); zeros past rows_valid.
__device__ __forceinline__ void load_stats(float* s, const float* g, int rows_valid) {
  for (int i = threadIdx.x; i < BR; i += THREADS)
    cp_async4(s + i, i < rows_valid ? g + i : g, i < rows_valid);
}

// Store a warp's 16 x DP f32 accumulator rows (times mul) as bf16, masked to
// rows < rows_valid and columns < D.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, const float (*acc)[4], float mul0,
                                           float mul1, int r0, int rows_valid, int D,
                                           int g, int t) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + (e >> 1) * 8;
      const int c = n * 8 + 2 * t + (e & 1);
      if (r < rows_valid && c < D)
        out[size_t(r) * D + c] = __float2bfloat16(acc[n][e] * ((e >> 1) ? mul1 : mul0));
    }
  }
}

// ---------------------------------------------------------------- K2 forward

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, int D, float scale_log2,
                 int vec) {
  constexpr int LD = Tile<DP>::LD, TE = Tile<DP>::ELEMS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + TE;       // 2 stages
  bf16* sV = sK + 2 * TE;   // 2 stages

  const int nqt = (Lq + BR - 1) / BR;
  const int bh = blockIdx.x / nqt;
  const int q0 = (blockIdx.x - bh * nqt) * BR;
  const bf16* kg = k + size_t(bh) * Lk * D;
  const bf16* vg = v + size_t(bh) * Lk * D;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;
  const int nkt = (Lk + BC - 1) / BC;

  load_tile<DP>(sQ, q + (size_t(bh) * Lq + q0) * D, Lq - q0, D, vec);
  load_tile<DP>(sK, kg, Lk, D, vec);
  load_tile<DP>(sV, vg, Lk, D, vec);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.0f, 0.0f};            // this lane's share of the running sum
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int j = 0; j < nkt; ++j) {
    const int st = j & 1;
    if (j + 1 < nkt) {  // the other stage was released by last step's barrier
      const size_t off = size_t(j + 1) * BC * D;
      load_tile<DP>(sK + (st ^ 1) * TE, kg + off, Lk - (j + 1) * BC, D, vec);
      load_tile<DP>(sV + (st ^ 1) * TE, vg + off, Lk - (j + 1) * BC, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = sK + st * TE;
    const bf16* vs = sV + st * TE;

    float s[BC / 8][4];
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, sQ, LD, r0, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
        uint32_t b[2];
        frag_bt(b, ks, LD, n * 8, kk * 16, g, t);
        mma16816(s[n], a, b);
      }
    }

    // scale to log2 units, mask keys past Lk, online softmax (rows g, g+8)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * BC + n * 8 + 2 * t + (e & 1);
        const float x = col < Lk ? s[n][e] * scale_log2 : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);  // every tile holds a valid key: mx finite
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t a[4];
      frag_a_acc(a, s, kk);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t b[2];
        frag_b(b, vs, LD, kk * 16, n * 8, g, t);
        mma16816(acc[n], a, b);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  store_rows<DP>(o + size_t(bh) * Lq * D + size_t(q0) * D, acc, 1.0f / l[0],
                 1.0f / l[1], r0, Lq - q0, D, g, t);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + r0 + g + i * 8;
      if (r < Lq) lse[size_t(bh) * Lq + r] = (m[i] + log2f(l[i])) * LN2;
    }
  }
}

// ---------------------------------------------------------------- K3 dq

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, int Lq, int Lk, int D, float scale_log2,
                float scale, int vec) {
  constexpr int LD = Tile<DP>::LD, TE = Tile<DP>::ELEMS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + TE;       // dO
  bf16* sK = sO + TE;       // 2 stages
  bf16* sV = sK + 2 * TE;   // 2 stages

  const int nqt = (Lq + BR - 1) / BR;
  const int bh = blockIdx.x / nqt;
  const int q0 = (blockIdx.x - bh * nqt) * BR;
  const bf16* kg = k + size_t(bh) * Lk * D;
  const bf16* vg = v + size_t(bh) * Lk * D;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;
  const int nkt = (Lk + BC - 1) / BC;

  const size_t row0 = size_t(bh) * Lq + q0;
  load_tile<DP>(sQ, q + row0 * D, Lq - q0, D, vec);
  load_tile<DP>(sO, dout + row0 * D, Lq - q0, D, vec);
  load_tile<DP>(sK, kg, Lk, D, vec);
  load_tile<DP>(sV, vg, Lk, D, vec);
  cp_async_commit();

  float lse2[2], dl[2];  // this lane's rows: LSE in log2 units, delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + g + i * 8;
    lse2[i] = r < Lq ? lse[size_t(bh) * Lq + r] * LOG2E : 0.0f;
    dl[i] = r < Lq ? delta[size_t(bh) * Lq + r] : 0.0f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int j = 0; j < nkt; ++j) {
    const int st = j & 1;
    if (j + 1 < nkt) {
      const size_t off = size_t(j + 1) * BC * D;
      load_tile<DP>(sK + (st ^ 1) * TE, kg + off, Lk - (j + 1) * BC, D, vec);
      load_tile<DP>(sV + (st ^ 1) * TE, vg + off, Lk - (j + 1) * BC, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = sK + st * TE;
    const bf16* vs = sV + st * TE;

    float s[BC / 8][4], dp[BC / 8][4];
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4], ao[4];
      frag_a(a, sQ, LD, r0, kk * 16, g, t);
      frag_a(ao, sO, LD, r0, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
        uint32_t b[2];
        frag_bt(b, ks, LD, n * 8, kk * 16, g, t);
        mma16816(s[n], a, b);       // S = Q K^T
        frag_bt(b, vs, LD, n * 8, kk * 16, g, t);
        mma16816(dp[n], ao, b);     // dP = dO V^T
      }
    }
    // dS = P (dP - delta), P = exp(S - LSE); keys past Lk give nothing
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * BC + n * 8 + 2 * t + (e & 1);
        const float p = col < Lk ? exp2f(s[n][e] * scale_log2 - lse2[e >> 1]) : 0.0f;
        s[n][e] = p * (dp[n][e] - dl[e >> 1]);
      }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t a[4];
      frag_a_acc(a, s, kk);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t b[2];
        frag_b(b, ks, LD, kk * 16, n * 8, g, t);
        mma16816(acc[n], a, b);
      }
    }
    __syncthreads();
  }
  store_rows<DP>(dq + row0 * D, acc, scale, scale, r0, Lq - q0, D, g, t);
}

// ---------------------------------------------------------------- K4 dk, dv

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq, int Lk, int D,
                 float scale_log2, float scale, int vec) {
  constexpr int LD = Tile<DP>::LD, TE = Tile<DP>::ELEMS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + TE;
  bf16* sQ = sV + TE;       // 2 stages
  bf16* sO = sQ + 2 * TE;   // dO, 2 stages
  float* sL = reinterpret_cast<float*>(sO + 2 * TE);  // LSE, 2 stages
  float* sD = sL + 2 * BC;                            // delta, 2 stages

  const int nkt = (Lk + BR - 1) / BR;
  const int bh = blockIdx.x / nkt;
  const int k0 = (blockIdx.x - bh * nkt) * BR;
  const bf16* qg = q + size_t(bh) * Lq * D;
  const bf16* og = dout + size_t(bh) * Lq * D;
  const float* lg = lse + size_t(bh) * Lq;
  const float* dg = delta + size_t(bh) * Lq;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;
  const int nqt = (Lq + BC - 1) / BC;

  const size_t row0 = size_t(bh) * Lk + k0;
  load_tile<DP>(sK, k + row0 * D, Lk - k0, D, vec);
  load_tile<DP>(sV, v + row0 * D, Lk - k0, D, vec);
  load_tile<DP>(sQ, qg, Lq, D, vec);
  load_tile<DP>(sO, og, Lq, D, vec);
  load_stats(sL, lg, Lq);
  load_stats(sD, dg, Lq);
  cp_async_commit();

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  for (int j = 0; j < nqt; ++j) {
    const int st = j & 1;
    if (j + 1 < nqt) {
      const int nx = (j + 1) * BC;
      load_tile<DP>(sQ + (st ^ 1) * TE, qg + size_t(nx) * D, Lq - nx, D, vec);
      load_tile<DP>(sO + (st ^ 1) * TE, og + size_t(nx) * D, Lq - nx, D, vec);
      load_stats(sL + (st ^ 1) * BC, lg + nx, Lq - nx);
      load_stats(sD + (st ^ 1) * BC, dg + nx, Lq - nx);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qs = sQ + st * TE;
    const bf16* os = sO + st * TE;
    const float* ls = sL + st * BC;
    const float* ds = sD + st * BC;

    float s[BC / 8][4], dp[BC / 8][4];  // S^T and dP^T: rows = keys, columns = queries
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4], av[4];
      frag_a(a, sK, LD, r0, kk * 16, g, t);
      frag_a(av, sV, LD, r0, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
        uint32_t b[2];
        frag_bt(b, qs, LD, n * 8, kk * 16, g, t);
        mma16816(s[n], a, b);       // S^T = K Q^T
        frag_bt(b, os, LD, n * 8, kk * 16, g, t);
        mma16816(dp[n], av, b);     // dP^T = V dO^T
      }
    }
    // P^T = exp(S^T - LSE[q]); dS^T = P^T (dP^T - delta[q]); queries past Lq give nothing
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const bool ok = j * BC + col < Lq;
        const float p = ok ? exp2f(s[n][e] * scale_log2 - ls[col] * LOG2E) : 0.0f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - ds[col]);
      }
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t ap[4], as[4];
      frag_a_acc(ap, s, kk);
      frag_a_acc(as, dp, kk);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t b[2];
        frag_b(b, os, LD, kk * 16, n * 8, g, t);
        mma16816(dva[n], ap, b);    // dV += P^T dO
        frag_b(b, qs, LD, kk * 16, n * 8, g, t);
        mma16816(dka[n], as, b);    // dK += dS^T Q
      }
    }
    __syncthreads();
  }
  store_rows<DP>(dk + row0 * D, dka, scale, scale, r0, Lk - k0, D, g, t);
  store_rows<DP>(dv + row0 * D, dva, 1.0f, 1.0f, r0, Lk - k0, D, g, t);
}

// ---------------------------------------------------------------- launch

template <int DP>
constexpr int fwd_smem() { return 5 * Tile<DP>::BYTES; }
template <int DP>
constexpr int dq_smem() { return 6 * Tile<DP>::BYTES; }
template <int DP>
constexpr int dkv_smem() { return 6 * Tile<DP>::BYTES + 4 * BC * int(sizeof(float)); }

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *lse_out, *dq, *dk, *dv;
  int BH, Lq, Lk, D;
  cudaStream_t stream;
};

template <int DP>
int launch(int which, const Args& a) {
  const float scale = 1.0f / sqrtf(float(a.D));
  const float scale_log2 = scale * LOG2E;
  const int vec = a.D % 8 == 0;
  const long long rows = which == 2 ? a.Lk : a.Lq;
  const long long blocks = (long long)a.BH * ((rows + BR - 1) / BR);
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  cudaError_t err;
  if (which == 0) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem<DP>());
    if (err != cudaSuccess) return int(err);
    flash_fwd_kernel<DP><<<unsigned(blocks), THREADS, fwd_smem<DP>(), a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o),
        static_cast<float*>(a.lse_out), a.Lq, a.Lk, a.D, scale_log2, vec);
  } else if (which == 1) {
    err = cudaFuncSetAttribute(flash_dq_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<DP>());
    if (err != cudaSuccess) return int(err);
    flash_dq_kernel<DP><<<unsigned(blocks), THREADS, dq_smem<DP>(), a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(a.dq), a.Lq, a.Lk, a.D, scale_log2, scale, vec);
  } else {
    err = cudaFuncSetAttribute(flash_dkv_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem<DP>());
    if (err != cudaSuccess) return int(err);
    flash_dkv_kernel<DP><<<unsigned(blocks), THREADS, dkv_smem<DP>(), a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Lq, a.Lk, a.D,
        scale_log2, scale, vec);
  }
  return int(cudaGetLastError());
}

int dispatch(int which, const Args& a) {
  if (a.BH < 1 || a.Lq < 1 || a.Lk < 1 || a.D < 1 || a.D > 256)
    return int(cudaErrorInvalidValue);
  if (a.D <= 32) return launch<32>(which, a);
  if (a.D <= 64) return launch<64>(which, a);
  if (a.D <= 128) return launch<128>(which, a);
  return launch<256>(which, a);
}

}  // namespace

extern "C" {

// K2: o = softmax(q k^T / sqrt(D)) v, lse = logsumexp rows; returns a cudaError_t.
int rovr_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                        void* lse, int BH, int Lq, int Lk, int D, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, lse, nullptr, nullptr, nullptr,
         BH, Lq, Lk, D, static_cast<cudaStream_t>(stream)};
  return dispatch(0, a);
}

// K3: dq from q, k, v, dO, lse and delta = rowsum(dO * O).
int rovr_flash_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq, int BH, int Lq,
                       int Lk, int D, void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, nullptr, dq, nullptr, nullptr,
         BH, Lq, Lk, D, static_cast<cudaStream_t>(stream)};
  return dispatch(1, a);
}

// K4: dk and dv from the same inputs.
int rovr_flash_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int BH,
                        int Lq, int Lk, int D, void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, nullptr, nullptr, dk, dv,
         BH, Lq, Lk, D, static_cast<cudaStream_t>(stream)};
  return dispatch(2, a);
}

const char* rovr_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
