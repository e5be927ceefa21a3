// K2-K4: flash attention, forward (K2), dq (K3) and dk/dv (K4), bf16
// q/k/v/dO in the (B*H, L, D) layout, f32 accumulation, f32 LSE.
//
// Replaces rovr_tpu/ops/pallas/attention.py: `_fwd_kernel` (K2), `_dq_kernel`
// (K3) and `_dkv_kernel` (K4). Same arithmetic, not the same layout: the TPU
// kernels ran on copies padded to D = 128 lanes and a block multiple of L,
// with LSE and delta broadcast over 128 lanes. Here nothing is padded on the
// host, keys past Lk are masked in the kernel, and LSE and delta are plain
// (B*H, Lq) f32 rows. P (and dS) are rounded to bf16 before their second
// product, as the plain twins in ops/attention.py do.
//
// What bounds them on an H100: at the PPO shape (2048 heads x 256 x 64) K2
// does 34.4 GFLOP on 270.5 MB (q, k, v read and O, LSE written once), 127
// operations per byte, K3 and K4 52-69 GFLOP on 340-407 MB: all under the
// ~295 operations per byte where the bf16 tensor cores become the limit, so
// device memory bounds them.
//
// K2, `flash_fwd_tma_kernel`, for every D % 8 == 0 up to 128 (TMA needs
// 16-byte global strides; see fwd_takes_tma):
//   - Operands arrive by TMA through 3-D tensor maps {D, L, B*H} with 128B
//     swizzle, one 64-column chunk (128 bytes) of a row per box column. A box
//     row past a head's L or a column past D reads zeros, so ragged L and D
//     need no padding and never reach the next head's rows.
//   - Persistent blocks, one per SM, walk the work items (head, query tile).
//     One producer thread keeps the items' Q tiles (two buffers) and K/V
//     tiles (a 4-stage mbarrier ring) in flight, so the next item's loads run
//     under the current item's products and epilogue; each item reads its
//     head's K and V once, for all its query rows.
//   - One or two consumer warpgroups, 64 query rows each (two when that still
//     gives every SM an item: the rollout's 32 heads get 128 items of 64
//     rows). S = Q K^T is a wgmma with Q and K (K-major) from shared memory;
//     the online softmax stays in f32 registers in the log2 domain; O += P V
//     is a wgmma with P as bf16 from registers (the S accumulator's layout is
//     the A fragment's) and V read MN-major (transpose-B).
//   - Epilogue: O normalized in registers, written to a swizzled staging tile
//     and stored by TMA (rows past Lq and columns past D are not written);
//     LSE = m + log(l) written by each row's owner.
// The mma.sync forward `flash_fwd_kernel` (below) stays for the shapes TMA cannot
// take: D % 8 != 0, and D > 128, where the two Q buffers, the staging tile
// and a K/V stage no longer fit in shared memory beside each other. The
// entry point picks the kernel from D alone; a build, encode or launch error
// of either is returned, never routed to the other.
//
// K3, K4 and the mma.sync forward share one design: one block of 4 warps per
// (b*h, 64-row tile), the streamed K/V (forward, K3) or Q/dO (K4) tiles in a
// 2-stage cp.async ring (a 16-byte cp.async with source size 0 zero-fills
// rows past L and columns past D), bf16 mma.sync.m16n8k16 with f32
// accumulators, S, P and dS kept in registers, each output written by one
// block (no atomics). The C fragments of S are reused as the A fragments of
// P (and dS) for the second product: the m16n8k16 accumulator of two
// neighbouring n8 tiles holds exactly the bf16 A fragment of their 16
// columns.
//   K3: one block per query tile; P = exp(S - LSE), dP = dO V^T,
//       dS = P (dP - delta), dQ += dS K.
//   K4: one block per key tile; P^T, dV += P^T dO, dP^T = V dO^T, dS^T,
//       dK += dS^T Q.
//
// Requirements (checked by the Python wrapper): bf16 q/k/v/dO, f32 lse and
// delta, contiguous, 16-byte aligned, 1 <= D <= 256. In the mma.sync kernels
// D % 8 == 0 takes the cp.async path; any other D is copied element by
// element.
//
// Built by rovr_torch/ops/cuda_build.py (nvcc, sm_90a, plain C interface).
// The tensor maps are encoded per launch on the host with the driver's
// cuTensorMapEncodeTiled, which the CUDA runtime hands out
// (cudaGetDriverEntryPoint; no -lcuda link).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

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

// ------------------------------------------------ K2 forward: TMA + wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Whether the phase of parity `parity` has completed.
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Spin until the phase of parity `parity` has completed. There is no
// timeout: a broken pipeline hangs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
        "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// every committed TMA store has finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// every committed TMA store has completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Make this thread's shared-memory writes visible to TMA (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier `id` (1 + warpgroup) over one warpgroup's 128 threads.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptor, 128B swizzle: start address, leading and
// stride byte offsets, all in 16-byte units. K-major operand (Q, K): rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO; LBO unused). MN-major B
// (V): 64-column chunks LBO apart along N, 8-row K groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving reads or writes of an accumulator register
// across the asynchronous products.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// D (64 x 64, f32) = A (64 x 16, K-major descriptor) * B (16 x 64, K-major
// descriptor) + (scale_d ? D : 0).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 128, f32) = A (64 x 16, K-major descriptor) * B (16 x 128, K-major
// descriptor) + (scale_d ? D : 0).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16 bf16, from registers) * B (16 x 64, MN-major
// descriptor: transpose-B = 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16 bf16, from registers) * B (16 x 128, MN-major
// descriptor: transpose-B = 1).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  else wgmma_ss_n128(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

constexpr int TMA_MAX_D = 128;      // the widest head the TMA kernel takes
constexpr int QROWS = 64;           // query rows of a consumer warpgroup (wgmma's M)
constexpr int ROW_BYTES = 128;      // a 64-column chunk of a row: the swizzle span
constexpr int SWIZZLE_ATOM = 1024;  // 8 rows of 128 bytes
constexpr int STAGES = 4;           // depth of the K/V ring

// TMA takes 16-byte global strides (D % 8 == 0); the buffers below fit in
// shared memory up to D = 128.
bool fwd_takes_tma(int D) { return D % 8 == 0 && D <= TMA_MAX_D; }

// Shared memory of the TMA kernel with heads padded to DP columns and NWG
// consumer warpgroups: two Q buffers, the K/V ring, the O staging tile and
// the mbarriers, every tile 1024-byte aligned for the 128B swizzle.
template <int DP, int NWG>
struct FwdTma {
  static constexpr int CHUNKS = DP / 64;              // 64-column chunks of a row
  static constexpr int BKEYS = DP == 64 ? 128 : 64;   // keys of a K/V stage
  static constexpr int THREADS = 128 * (NWG + 1);     // + the producer warpgroup
  static constexpr int Q_CHUNK = QROWS * ROW_BYTES;   // 8 KB
  static constexpr int Q_BYTES = NWG * CHUNKS * Q_CHUNK;
  static constexpr int KV_CHUNK = BKEYS * ROW_BYTES;
  static constexpr int K_BYTES = CHUNKS * KV_CHUNK;   // the K (or V) tile of a stage
  static constexpr int STAGE_BYTES = 2 * K_BYTES;
  static constexpr int O_BYTES = Q_BYTES;
  static constexpr int BARS = 4 + 3 * STAGES;
  static constexpr int SMEM =
      2 * Q_BYTES + STAGES * STAGE_BYTES + O_BYTES + 8 * BARS + SWIZZLE_ATOM;
  static_assert(SMEM <= 232448, "more shared memory than a block may use");
};

template <int DP, int NWG>
__global__ void __launch_bounds__(FwdTma<DP, NWG>::THREADS, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap o_map, float* __restrict__ lse,
                     int Lq, int Lk, int nqt, int items, float scale_log2) {
  using C = FwdTma<DP, NWG>;
  constexpr int BK = C::BKEYS;
  extern __shared__ __align__(128) unsigned char smem_raw[];  // aligned to 1024 below
  const uint32_t sq = (smem_u32(smem_raw) + SWIZZLE_ATOM - 1) & ~uint32_t(SWIZZLE_ATOM - 1);
  const uint32_t ring = sq + 2 * C::Q_BYTES;
  const uint32_t so = ring + STAGES * C::STAGE_BYTES;
  // mbarriers: q_full[2], q_empty[2], then k_full, v_full, kv_empty[STAGES]
  const uint32_t q_full = so + C::O_BYTES, q_empty = q_full + 16;
  const uint32_t k_full = q_empty + 16, v_full = k_full + 8 * STAGES;
  const uint32_t kv_empty = v_full + 8 * STAGES;
  const int nkt = (Lk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full + 8 * b, 1);        // the producer's expect_tx
      mbar_init(q_empty + 8 * b, NWG);     // one arrive per consumer warpgroup
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Work item `it` is query rows [qt * 64 * NWG, +64 * NWG) of head bh;
  // block b takes items b, b + gridDim.x, ... (neighbouring blocks work on
  // one head at a time, so its K and V come from L2 after the first read).
  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // Producer: one thread issues every load. The Q buffers and the ring
    // start empty, so the first pass over each waits on parity 1, which a
    // fresh barrier passes.
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x % 128 == 0) {
      int n = 0;  // K/V tiles issued so far
      for (int it = blockIdx.x, i = 0; it < items; it += gridDim.x, ++i) {
        const int bh = it / nqt;
        const int q0 = (it - bh * nqt) * (QROWS * NWG);
        const int qb = i & 1;
        mbar_wait(q_empty + 8 * qb, ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qb, C::Q_BYTES);
        for (int w = 0; w < NWG; ++w)
          for (int c = 0; c < C::CHUNKS; ++c)
            tma_load_3d(sq + qb * C::Q_BYTES + (w * C::CHUNKS + c) * C::Q_CHUNK, &q_map,
                        q_full + 8 * qb, 64 * c, q0 + QROWS * w, bh);
        for (int j = 0; j < nkt; ++j, ++n) {
          const int s = n % STAGES;
          const uint32_t st = ring + s * C::STAGE_BYTES;
          mbar_wait(kv_empty + 8 * s, ((n / STAGES) & 1) ^ 1);
          mbar_expect_tx(k_full + 8 * s, C::K_BYTES);
          for (int c = 0; c < C::CHUNKS; ++c)
            tma_load_3d(st + c * C::KV_CHUNK, &k_map, k_full + 8 * s, 64 * c, j * BK, bh);
          mbar_expect_tx(v_full + 8 * s, C::K_BYTES);
          for (int c = 0; c < C::CHUNKS; ++c)
            tma_load_3d(st + C::K_BYTES + c * C::KV_CHUNK, &v_map, v_full + 8 * s, 64 * c,
                        j * BK, bh);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows q0 .. q0 + 63 of each item. Its
  // accumulator layout (wgmma's): lane l of warp w holds rows w*16 + l/4
  // (+8) and columns 8i + 2(l%4) (+1), in registers 4i + {0, 1} (+{2, 3}).
  if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const uint32_t so_wg = so + wg * C::CHUNKS * C::Q_CHUNK;
  int n = 0;  // K/V tiles consumed so far
  for (int it = blockIdx.x, i = 0; it < items; it += gridDim.x, ++i) {
    const int bh = it / nqt;
    const int q0 = (it - bh * nqt) * (QROWS * NWG) + QROWS * wg;
    const int qb = i & 1;
    const uint32_t qa = sq + qb * C::Q_BYTES + wg * C::CHUNKS * C::Q_CHUNK;
    float acc[DP / 2];
#pragma unroll
    for (int x = 0; x < DP / 2; ++x) acc[x] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores (log2)
    float l[2] = {0.0f, 0.0f};            // this lane's share of the running sum
    mbar_wait(q_full + 8 * qb, (i >> 1) & 1);

    for (int j = 0; j < nkt; ++j, ++n) {
      const int s = n % STAGES;
      const uint32_t par = (n / STAGES) & 1;
      const uint32_t kt = ring + s * C::STAGE_BYTES, vt = kt + C::K_BYTES;

      // S = Q K^T: k16 step kk is 32 bytes along both operands' 128-byte rows
      float sc[BK / 2];
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) sc[x] = 0.0f;
      mbar_wait(k_full + 8 * s, par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<BK>(sc,
                     smem_desc(qa + (kk / 4) * C::Q_CHUNK + (kk % 4) * 32, 16, SWIZZLE_ATOM),
                     smem_desc(kt + (kk / 4) * C::KV_CHUNK + (kk % 4) * 32, 16, SWIZZLE_ATOM),
                     kk > 0);
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) fence_operand(sc[x]);
      if (j == nkt - 1 && tid == 0) mbar_arrive(q_empty + 8 * qb);  // done with Q

      // online softmax in log2 units; keys past Lk (the last tile) get nothing
      if ((j + 1) * BK > Lk) {
#pragma unroll
        for (int x = 0; x < BK / 2; ++x)
          if (j * BK + (x / 4) * 8 + 2 * t + (x & 1) >= Lk) sc[x] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], sc[x]);
      float alpha[2], neg_m[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        // every tile holds a valid key: the new max is finite
        const float m_new = fmaxf(m[h], mx[h] * scale_log2);
        alpha[h] = ex2(m[h] - m_new);
        m[h] = m_new;
        neg_m[h] = -m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) {
        sc[x] = ex2(fmaf(sc[x], scale_log2, neg_m[(x >> 1) & 1]));
        l[(x >> 1) & 1] += sc[x];
      }
      // P as bf16 A fragments: k16 step kk is the n8 tiles 2kk and 2kk + 1
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
#pragma unroll
      for (int x = 0; x < DP / 2; ++x) acc[x] *= alpha[(x >> 1) & 1];

      // O += P V: k16 step kk is 16 rows of V (2 KB) down each 64-column chunk
      mbar_wait(v_full + 8 * s, par);
#pragma unroll
      for (int x = 0; x < DP / 2; ++x) fence_operand(acc[x]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DP>(acc, p[kk], smem_desc(vt + kk * 16 * ROW_BYTES, C::KV_CHUNK, SWIZZLE_ATOM));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int x = 0; x < DP / 2; ++x) fence_operand(acc[x]);
      if (tid == 0) mbar_arrive(kv_empty + 8 * s);  // the stage may be refilled
    }

    // Epilogue: O / l into the staging tile in TMA's 128B-swizzled layout
    // (16-byte unit u of row r at u ^ (r % 8); bank-conflict free), then one
    // TMA store per 64-column chunk, which writes nothing past Lq or D.
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = 1.0f / l[h];
    }
    if (tid == 0) bulk_wait_read();  // the last item's store has left the tile
    warpgroup_sync(1 + wg);
#pragma unroll
    for (int x = 0; x < DP / 8; ++x)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;  // r % 8 == g
        st_shared_u32(so_wg + (x / 8) * C::Q_CHUNK + r * ROW_BYTES + (((x % 8) ^ g) << 4) + 4 * t,
                      pack_bf16(acc[4 * x + 2 * h] * inv[h], acc[4 * x + 2 * h + 1] * inv[h]));
      }
    fence_proxy_async();
    warpgroup_sync(1 + wg);
    if (tid == 0) {
      for (int c = 0; c < C::CHUNKS; ++c)
        tma_store_3d(&o_map, so_wg + c * C::Q_CHUNK, 64 * c, q0, bh);
      bulk_commit();
    }
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = q0 + warp * 16 + g + 8 * h;
        if (r < Lq) lse[size_t(bh) * Lq + r] = (m[h] + log2f(l[h])) * LN2;
      }
    }
  }
  if (tid == 0) bulk_wait();
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

// The driver's cuTensorMapEncodeTiled, as the CUDA runtime hands it out.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    const bool ok = err == cudaSuccess && found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// Errors of the encode are returned as ENCODE_ERROR + CUresult, past every
// cudaError_t, so the wrapper can tell them apart.
constexpr int ENCODE_ERROR = 100000;

// A 3-D bf16 tensor map {D, L, BH} over a contiguous (BH, L, D) tensor with
// boxes of {64, rows, 1} in the 128B swizzle; zeros outside the tensor.
int encode_heads(CUtensorMap* map, const void* base, int BH, int L, int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ENCODE_ERROR + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(L), cuuint64_t(BH)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 2, cuuint64_t(L) * D * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(rows), 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                        dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // NONE: zeros outside
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + int(r);
}

// The current device's SM count, read once per device.
int sm_count(int* out) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev < 64 && cached[dev] > 0) {
    *out = cached[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  if (dev < 64) cached[dev] = *out;
  return 0;
}

template <int DP, int NWG>
int launch_fwd_tma(const Args& a, int sms) {
  using C = FwdTma<DP, NWG>;
  const int nqt = (a.Lq + QROWS * NWG - 1) / (QROWS * NWG);
  const long long items = (long long)a.BH * nqt;
  if (items > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  CUtensorMap q_map, k_map, v_map, o_map;  // every map of the launch, then the launch
  int err = encode_heads(&q_map, a.q, a.BH, a.Lq, a.D, QROWS);
  if (!err) err = encode_heads(&k_map, a.k, a.BH, a.Lk, a.D, C::BKEYS);
  if (!err) err = encode_heads(&v_map, a.v, a.BH, a.Lk, a.D, C::BKEYS);
  if (!err) err = encode_heads(&o_map, a.o, a.BH, a.Lq, a.D, QROWS);
  if (err) return err;
  const cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_tma_kernel<DP, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (cerr != cudaSuccess) return int(cerr);
  const int grid = int(items < sms ? items : sms);  // one persistent block per SM
  flash_fwd_tma_kernel<DP, NWG><<<grid, C::THREADS, C::SMEM, a.stream>>>(
      q_map, k_map, v_map, o_map, static_cast<float*>(a.lse_out), a.Lq, a.Lk, nqt,
      int(items), LOG2E / sqrtf(float(a.D)));
  return int(cudaGetLastError());
}

// Two consumer warpgroups (128 query rows an item, K and V read once for
// both) when that still gives every SM an item; else one, so that few heads
// still spread over the SMs (the rollout's 32 heads of 256 rows: 128 items).
int fwd_tma(const Args& a) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  const bool two = (long long)a.BH * ((a.Lq + 2 * QROWS - 1) / (2 * QROWS)) >= sms;
  if (a.D <= 64) return two ? launch_fwd_tma<64, 2>(a, sms) : launch_fwd_tma<64, 1>(a, sms);
  return two ? launch_fwd_tma<128, 2>(a, sms) : launch_fwd_tma<128, 1>(a, sms);
}

}  // namespace

extern "C" {

// K2: o = softmax(q k^T / sqrt(D)) v, lse = logsumexp rows. D % 8 == 0 up to
// 128 launches the TMA kernel, any other D the mma.sync one. Returns 0 once
// launched, else a cudaError_t or ENCODE_ERROR + the encode's CUresult.
int rovr_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                        void* lse, int BH, int Lq, int Lk, int D, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, lse, nullptr, nullptr, nullptr,
         BH, Lq, Lk, D, static_cast<cudaStream_t>(stream)};
  if (BH < 1 || Lq < 1 || Lk < 1 || D < 1 || D > 256) return int(cudaErrorInvalidValue);
  return fwd_takes_tma(D) ? fwd_tma(a) : dispatch(0, a);
}

// Which kernel rovr_flash_fwd_bf16 launches for head dim D: 1 the TMA
// kernel, 0 the mma.sync one.
int rovr_flash_fwd_route(int D) { return fwd_takes_tma(D) ? 1 : 0; }

// Test hook: K2 by the mma.sync kernel whatever D, for comparisons.
int rovr_flash_fwd_mma_bf16(const void* q, const void* k, const void* v, void* o,
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
  if (err >= ENCODE_ERROR) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d",
             err - ENCODE_ERROR);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
