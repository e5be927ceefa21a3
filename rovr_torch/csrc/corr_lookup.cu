// RAFT-small's correlation lookup in one launch: for every position of a
// (B, H, W) grid of flow coordinates, the 4 levels x 49 bilinear taps of
// the all-pairs correlation pyramid around its coordinates, written in the
// motion encoder's compute dtype (bf16, or f32).
//
// Replaces no Pallas kernel: the JAX file (rovr_tpu/models/raft.py,
// lookup_corr) samples the volume as one-hot products that XLA lowers by
// itself. The port's plain version (rovr_torch/ops/corr.py::lookup_corr),
// stock tensor ops, makes some 85 launches a level, each over a
// (B, H*W, 49) tensor of indices, masks or corner values, about 15 GB of
// device-memory traffic a RAFT iteration at the main shape for a 51 MB
// result. Here indices, masks and corners never leave registers.
//
// What it computes, exactly as the plain version. Level l is
// (B, H*W, h_l, w_l) f32 as correlation_pyramid returns it (h_l = H >> l,
// w_l = W >> l). At position p with coordinates (x, y): cx = x / 2^l,
// cy = y / 2^l; for tap (dy, dx), each in -3..3, channel
// l*49 + (dy+3)*7 + (dx+3): xs = cx + dx, ys = cy + dy, x0 = floor(xs),
// y0 = floor(ys), wx = xs - x0, wy = ys - y0 and
//   out = v00 (1-wy)(1-wx) + v01 (1-wy) wx + v10 wy (1-wx) + v11 wy wx,
// summed left to right, a corner outside the level reading zero; a level
// pooled to nothing (h_l or w_l 0) gives zeros. Every product and sum is
// rounded in the plain version's order (__fmul_rn, __fadd_rn: nothing is
// contracted into an FMA), so the f32 sum is the plain version's; it is
// rounded once to the output dtype.
//
// What bounds it on an H100: device memory. At the main shape (128 frame
// pairs, 32 x 32 positions, levels 32/16/8/4) the least it must move is
// the coordinates (1.05 MB), each position's 8 x 8 window of each level in
// f32 (134.2 MB) and the bf16 output (51.4 MB): 186.6 MB, 0.0557 ms at
// 3.35 TB/s. Its arithmetic, some 30 operations an output, is far below the
// card's rates.
//
// Design: one thread for each (position, level, tap row dy). The row's 7
// taps read two rows of the level, y0 and y0 + 1, over the 9 columns
// floor(cx) - 3 .. floor(cx) + 5: the thread loads those 18 values once
// (zero outside the level, through the read-only cache), and each tap takes
// its corners from them: x0 is floor(cx) + dx, or one more where cx + dx
// rounds up to the next integer. The threads of one position's level take
// its 7 rows side by side, so a window's sectors come from device memory
// once and from L1 after. A block takes 8 positions (224 threads); their
// 8 x 196 outputs are staged in shared memory and leave in 16-byte stores,
// the 196 channels of a position contiguous: the output is (B, H, W, 196),
// which the wrapper hands on as (B, 196, H, W) strides.
//
// Requirements (checked by the Python wrapper): contiguous f32 levels of
// the shapes above and contiguous f32 coordinates (B, H, W, 2), all on one
// card, 0 < B*H*W.
//
// Built by rovr_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LEVELS = 4;
constexpr int RADIUS = 3;
constexpr int TAPS = 2 * RADIUS + 1;               // 7 a row and a column
constexpr int CHANNELS = LEVELS * TAPS * TAPS;     // 196 a position
constexpr int ROWS = LEVELS * TAPS;                // 28 threads a position
constexpr int SPAN = TAPS + 2;                     // 9 columns a tap row reads
constexpr int POSITIONS = 8;                       // a block's positions
constexpr int THREADS = POSITIONS * ROWS;          // 224

struct Pyramid {
  const float* vol[LEVELS];
  int h[LEVELS];
  int w[LEVELS];
};

template <typename X>
__device__ __forceinline__ X pick(const X (&a)[LEVELS], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
corr_lookup_kernel(const float* __restrict__ coords, const Pyramid pyr, T* __restrict__ out,
                   long long npos) {
  __shared__ __align__(16) T stage[POSITIONS * CHANNELS];
  const int t = threadIdx.x;
  const int slot = t / ROWS;
  const int l = (t - slot * ROWS) / TAPS;
  const int dy = t - slot * ROWS - l * TAPS - RADIUS;
  const long long p0 = static_cast<long long>(blockIdx.x) * POSITIONS;
  const long long p = p0 + slot;
  T* dst = stage + slot * CHANNELS + l * TAPS * TAPS + (dy + RADIUS) * TAPS;

  const int h = pick(pyr.h, l), w = pick(pyr.w, l);
  if (p < npos && (h == 0 || w == 0)) {
#pragma unroll
    for (int j = 0; j < TAPS; ++j) put(dst + j, 0.f);
  } else if (p < npos) {
    const float scale = static_cast<float>(1 << l);
    const float cx = __fdiv_rn(__ldg(coords + 2 * p), scale);
    const float cy = __fdiv_rn(__ldg(coords + 2 * p + 1), scale);
    const float ys = __fadd_rn(cy, static_cast<float>(dy));
    const float y0 = floorf(ys);
    const float y1 = __fadd_rn(y0, 1.f);
    const float wy = __fsub_rn(ys, y0);
    const float omy = __fsub_rn(1.f, wy);
    const bool in0 = y0 >= 0.f && y0 < static_cast<float>(h);
    const bool in1 = y1 >= 0.f && y1 < static_cast<float>(h);
    const float bx = floorf(cx);
    const float* vol = pick(pyr.vol, l) + p * h * w;
    const float* row0 = vol + (in0 ? static_cast<int>(y0) : 0) * w;
    const float* row1 = vol + (in1 ? static_cast<int>(y1) : 0) * w;

    // r0[k], r1[k]: rows y0 and y0 + 1 at column floor(cx) + k - 3.
    float r0[SPAN], r1[SPAN];
#pragma unroll
    for (int k = 0; k < SPAN; ++k) {
      const float xk = __fadd_rn(bx, static_cast<float>(k - RADIUS));
      const bool in = xk >= 0.f && xk < static_cast<float>(w);
      const int ix = in ? static_cast<int>(xk) : 0;
      r0[k] = in && in0 ? __ldg(row0 + ix) : 0.f;
      r1[k] = in && in1 ? __ldg(row1 + ix) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      const float xs = __fadd_rn(cx, static_cast<float>(j - RADIUS));
      const float x0 = floorf(xs);
      const float wx = __fsub_rn(xs, x0);
      const float omx = __fsub_rn(1.f, wx);
      // cx + dx rounded up to the next integer: the corners lie one further.
      const bool up = x0 != __fadd_rn(bx, static_cast<float>(j - RADIUS));
      const float v00 = up ? r0[j + 1] : r0[j], v01 = up ? r0[j + 2] : r0[j + 1];
      const float v10 = up ? r1[j + 1] : r1[j], v11 = up ? r1[j + 2] : r1[j + 1];
      float s = __fmul_rn(__fmul_rn(v00, omy), omx);
      s = __fadd_rn(s, __fmul_rn(__fmul_rn(v01, omy), wx));
      s = __fadd_rn(s, __fmul_rn(__fmul_rn(v10, wy), omx));
      s = __fadd_rn(s, __fmul_rn(__fmul_rn(v11, wy), wx));
      put(dst + j, s);
    }
  }
  __syncthreads();

  // A block's outputs are contiguous: 8 x 196 values from position p0 on,
  // 16-byte aligned (8 x 196 x 2 bytes is a multiple of 16).
  T* gout = out + p0 * CHANNELS;
  if (npos - p0 >= POSITIONS) {
    constexpr int VECS = POSITIONS * CHANNELS * static_cast<int>(sizeof(T)) / 16;
    const uint4* src = reinterpret_cast<const uint4*>(stage);
    uint4* to = reinterpret_cast<uint4*>(gout);
    for (int i = t; i < VECS; i += THREADS) to[i] = src[i];
  } else {
    const int n = static_cast<int>(npos - p0) * CHANNELS;
    for (int i = t; i < n; i += THREADS) gout[i] = stage[i];
  }
}

}  // namespace

extern "C" {

// out (B, H, W, 196), bf16 when out_bf16 else f32, from coords (B, H, W, 2)
// f32 and the levels v0..v3 (B, H*W, h_l, w_l) f32; npos = B*H*W > 0.
// Returns 0 once launched, else the cudaError_t.
int rovr_corr_lookup(const void* coords, const void* v0, const void* v1, const void* v2,
                     const void* v3, int h0, int w0, int h1, int w1, int h2, int w2, int h3,
                     int w3, long long npos, void* out, int out_bf16, void* stream) {
  const Pyramid pyr = {{static_cast<const float*>(v0), static_cast<const float*>(v1),
                        static_cast<const float*>(v2), static_cast<const float*>(v3)},
                       {h0, h1, h2, h3},
                       {w0, w1, w2, w3}};
  const long long blocks = (npos + POSITIONS - 1) / POSITIONS;
  if (npos <= 0 || blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(coords);
  if (out_bf16) {
    corr_lookup_kernel<__nv_bfloat16><<<unsigned(blocks), THREADS, 0, s>>>(
        c, pyr, static_cast<__nv_bfloat16*>(out), npos);
  } else {
    corr_lookup_kernel<float><<<unsigned(blocks), THREADS, 0, s>>>(
        c, pyr, static_cast<float*>(out), npos);
  }
  return int(cudaGetLastError());
}

const char* rovr_corr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
