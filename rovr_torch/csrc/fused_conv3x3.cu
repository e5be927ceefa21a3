// K1: fused 3x3 convolution (stride 1, SAME zero padding) + bias + ReLU,
// NHWC bf16 activations, HWIO bf16 weights, f32 bias, f32 accumulation.
//
// Replaces rovr_tpu/ops/pallas/conv.py::_conv_kernel (the UNet's conv3,
// conv4 and conv5). That kernel summed nine shifted (TH*W, Cin) x (Cin, Cout)
// products read from nine materialized shift views of a padded input; here
// the convolution is an implicit GEMM read straight off the unpadded input:
//
//   M = B*H*W output pixels, N = Cout, K = 9*Cin ordered (tap, cin),
//   A[m][k] = x[b, h+dy, w+dx, cin] (zero outside the frame),
//   B[k][n] = w[dy+1, dx+1, cin, n].
//
// A block computes a BM x BN tile of the output. Its K loop walks the nine
// taps and, inside each tap, BK-wide slices of Cin. Tiles stream through a
// STAGES-deep ring in shared memory with 16-byte cp.async copies; a copy
// whose source lies outside the frame, past Cin or past Cout is issued with
// source size 0, which writes zeros, so the halo and the ragged edges cost
// no branch in the inner loop. Eight warps multiply with bf16 WMMA fragments
// (mma.sync on the tensor cores) into f32 accumulators; the epilogue adds
// the bias and applies the ReLU in f32, then stores 16 bytes of bf16 per
// lane.
//
// Requirements (checked by the Python wrapper): Cin % 8 == 0,
// Cout % 8 == 0, 16-byte aligned contiguous tensors, B*H*W < 2^31.
//
// Built by rovr_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BM = 128;          // output pixels per block
constexpr int BN = 128;          // output channels per block
constexpr int BK = 32;           // input channels per K slice
constexpr int STAGES = 3;        // depth of the cp.async ring
constexpr int THREADS = 256;     // 8 warps: 4 along M x 2 along N
constexpr int WM = 32;           // warp tile rows    (2 fragments)
constexpr int WN = 64;           // warp tile columns (4 fragments)
constexpr int A_LD = BK + 8;     // padded shared-memory row strides: rows land
constexpr int B_LD = BN + 8;     // on distinct banks, and stay WMMA-aligned
constexpr int A_STAGE = BM * A_LD;  // elements per stage
constexpr int B_STAGE = BK * B_LD;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * int(sizeof(bf16));

static_assert(BM * BK / 8 == 2 * THREADS, "A tile: two 16-byte copies per thread");
static_assert(BK * BN / 8 == 2 * THREADS, "B tile: two 16-byte copies per thread");
static_assert(8 * 16 * 16 * int(sizeof(float)) <= SMEM_BYTES, "epilogue scratch");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;  // 0: no read, the 16 bytes become zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ y,
               int B, int H, int W, int Cin, int Cout, int relu) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + STAGES * A_STAGE;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int M = B * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kslices = (Cin + BK - 1) / BK;
  const int KT = 9 * kslices;

  // A copies: rows tid/4 and tid/4 + 64 of the tile, channels (tid%4)*8..+8.
  // The pixel coordinates of both rows are decoded once.
  const int a_col = (tid % 4) * 8;
  int a_b[2], a_h[2], a_w[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + tid / 4 + i * 64;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    a_w[i] = mm % W;
    const int t = mm / W;
    a_h[i] = t % H;
    a_b[i] = t / H;
  }
  // B copies: rows tid/16 and tid/16 + 16 of the tile, columns (tid%16)*8..+8.
  const int b_row = tid / 16;
  const int b_col = (tid % 16) * 8;
  const bool b_col_ok = n0 + b_col < Cout;

  auto load_tile = [&](int kt, int stage) {
    const int tap = kt / kslices;
    const int c0 = (kt - tap * kslices) * BK;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    bf16* as = As + stage * A_STAGE;
    bf16* bs = Bs + stage * B_STAGE;
    const int ca = c0 + a_col;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ih = a_h[i] + dy;
      const int iw = a_w[i] + dx;
      const bool ok = a_ok[i] && ca < Cin && ih >= 0 && ih < H && iw >= 0 && iw < W;
      const bf16* src =
          ok ? x + ((size_t(a_b[i]) * H + ih) * W + iw) * Cin + ca : x;
      cp_async16(as + (tid / 4 + i * 64) * A_LD + a_col, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = b_row + i * 16;
      const int cin = c0 + r;
      const bool ok = b_col_ok && cin < Cin;
      const bf16* src =
          ok ? w + (size_t(tap) * Cin + cin) * Cout + n0 + b_col : w;
      cp_async16(bs + r * B_LD + b_col, src, ok);
    }
  };

  const int wm = warp / 2;  // warp tile origin: rows wm*WM, columns wn*WN
  const int wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    // Slice kt has landed once at most STAGES-2 younger groups are pending;
    // the barrier also retires every warp's reads of the stage refilled next.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < KT) load_tile(next, next % STAGES);
    cp_async_commit();

    const bf16* as = As + (kt % STAGES) * A_STAGE;
    const bf16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * WM + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * B_LD + wn * WN + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: each warp stages one 16x16 f32 fragment at a time in its own
  // 1 KB of the (now idle) ring; lane l takes row l/2, columns (l%2)*8..+8.
  float* scratch = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int r = lane / 2;
  const int cg = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * WM + i * 16 + r;
      const int n = n0 + wn * WN + j * 16 + cg;
      if (m < M && n < Cout) {  // Cout % 8 == 0: all eight columns exist
        __align__(16) bf16 out[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float v = scratch[r * 16 + cg + e] + bias[n + e];
          if (relu) v = fmaxf(v, 0.0f);
          out[e] = __float2bfloat16(v);
        }
        *reinterpret_cast<uint4*>(y + size_t(m) * Cout + n) =
            *reinterpret_cast<const uint4*>(out);
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" {

// y = act(conv3x3_same(x, w) + bias); returns a cudaError_t (0 = launched).
int rovr_fused_conv3x3_bf16(const void* x, const void* w, const void* bias,
                            void* y, int B, int H, int W, int Cin, int Cout,
                            int relu, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return int(err);
  const int M = B * H * W;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  conv3x3_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(y), B, H, W, Cin,
      Cout, relu);
  return int(cudaGetLastError());
}

const char* rovr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
