// K1: fused 3x3 convolution (stride 1, SAME zero padding) + bias + ReLU,
// NHWC bf16 activations, HWIO bf16 weights, f32 bias, f32 accumulation,
// one bf16 store.
//
// Replaces rovr_tpu/ops/pallas/conv.py::_conv_kernel (pallas_call at
// conv.py:147; the UNet's conv3, conv4 and conv5). That kernel summed nine
// shifted (TH*W, Cin) x (Cin, Cout) products read from nine materialized
// shift views of a padded input. Here the convolution is an implicit GEMM
// read straight off the unpadded input:
//
//   M = output pixels, N = Cout, K = 9 taps x Cin ordered (tap, cin),
//   A[m][k] = x[b, h+dy-1, w+dx-1, cin] (zero outside the frame),
//   B[k][n] = w[dy, dx, cin, n].
//
// What bounds it on an H100: at the serving shapes it does 1,400-2,900
// operations per byte of operands against the card's ~295 bf16 operations
// per byte, so the tensor cores bound it, not memory. The design therefore
// feeds Hopper's tensor cores the way they run fastest:
//
// - wgmma: two consumer warpgroups each run wgmma.mma_async m64n256k16
//   (bf16 in, f32 accumulators in registers) on a 128 x 256 output tile;
//   the producer warpgroup hands its registers to the consumers
//   (setmaxnreg 40 / 232) for their 128 accumulators. A Cout below 256
//   leaves the tile's upper columns zero-filled and unstored.
// - Spatial M tile: a block's 128 output pixels are a TH x TW rectangle of
//   one image (2 x 64 at W = 64, 4 x 32 at W = 32). The A operand of one
//   (tap, 64-channel slice) is then ONE 4-D TMA box {64, TW, TH, 1} of the
//   unpadded NHWC x at (c0, x0 + dx - 1, y0 + dy - 1, b). TMA fills every
//   element outside the tensor with zeros, negative coordinates included,
//   so the halo, a ragged H or W and channels past Cin cost nothing: no
//   padded copy, no shift views, no address arithmetic in the loop. 64 bf16
//   channels are 128 bytes, so with 128B swizzle the box lands in the
//   K-major layout that wgmma reads for A.
// - B stays HWIO (N contiguous, MN-major; wgmma's transpose-B flag reads
//   it), through a 3-D tensor map {Cout, Cin, 9}: a slice past Cin reads
//   zeros, not the next tap's rows. Boxes are 64 Cout wide (128B swizzle).
// - TMA: one producer thread keeps a 4-stage ring of (A, B) tiles in
//   flight with "full" and "empty" mbarriers (expect_tx bytes on full); a
//   consumer releases a stage only after the products that read it retire.
// - Epilogue on the accumulator registers: + f32 bias, ReLU (when relu),
//   bf16, stored masked by (h < H, w < W, n < Cout).
//
// Requirements (checked by the Python wrapper): Cin % 8 == 0 and
// Cout % 8 == 0 (TMA's 16-byte global strides), 16-byte aligned contiguous
// tensors, B*H*W < 2^31.
//
// Built by rovr_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// and called through ctypes (plain C interface below). The tensor maps are
// encoded per launch on the host with the driver's cuTensorMapEncodeTiled,
// which the CUDA runtime hands out (cudaGetDriverEntryPoint; no -lcuda link).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;              // output pixels per block (TH x TW)
constexpr int BN = 256;              // output channels per block
constexpr int BK = 64;               // channels per K step: one 128-byte row
constexpr int STAGES = 4;            // depth of the TMA ring
constexpr int CONSUMERS = 2;         // wgmma warpgroups, 64 tile rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int A_BYTES = BM * BK * 2;            // 16 KB
constexpr int B_BOX_BYTES = 64 * BK * 2;        // one 64-Cout box: 8 KB
constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;  // 48 KB
constexpr int SWIZZLE_ATOM = 1024;              // 8 rows of 128 bytes
// the ring, the 2 x STAGES mbarriers, and room to align the ring to 1024
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + SWIZZLE_ATOM;

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

// Spin until the phase of parity `parity` has completed.
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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
        "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
        "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// wgmma shared-memory descriptor, 128B swizzle: start address, leading and
// stride byte offsets, all in 16-byte units. K-major A: rows of 128 bytes,
// 8-row groups 1024 bytes apart (SBO; LBO unused). MN-major B: 64-column
// boxes LBO apart along N, 8-row K groups 1024 bytes apart (SBO).
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of an accumulator register
// across the asynchronous products.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// D (64 x 256, f32, 128 registers a thread) += A (64 x 16, K-major, from a
// descriptor) * B (16 x 256, MN-major: transpose-B = 1, from a descriptor).
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

__global__ void __launch_bounds__(THREADS, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap w_map,
               const float* __restrict__ bias, bf16* __restrict__ y,
               int H, int W, int Cout, int TH, int TW, int kslices, int relu) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + SWIZZLE_ATOM - 1) & ~uint32_t(SWIZZLE_ATOM - 1);
  const uint32_t bars = ring + STAGES * STAGE_BYTES;  // full[s], then empty[s]

  // the block's tile: pixels (y0.., x0..) of image img, channels n0..
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  int t = blockIdx.x;
  const int x0 = (t % tiles_w) * TW;
  t /= tiles_w;
  const int y0 = (t % tiles_h) * TH;
  const int img = t / tiles_h;
  const int n0 = blockIdx.y * BN;
  const int KT = 9 * kslices;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                       // the producer's expect_tx
      mbar_init(bars + 8 * (STAGES + s), CONSUMERS);    // one arrive per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // Producer: one thread issues every load; the ring starts empty, so the
    // first pass over it waits on parity 1, which a fresh barrier passes.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x % 128 == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(bars + 8 * (STAGES + s), ((kt / STAGES) & 1) ^ 1);
        const int tap = kt / kslices;
        const int c0 = (kt - tap * kslices) * BK;
        const uint32_t a = ring + s * STAGE_BYTES;
        mbar_expect_tx(bars + 8 * s, STAGE_BYTES);
        tma_load_4d(a, &x_map, bars + 8 * s, c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, img);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(a + A_BYTES + j * B_BOX_BYTES, &w_map, bars + 8 * s, n0 + 64 * j, c0, tap);
      }
    }
    return;
  }

  // Consumers: warpgroup wg multiplies tile rows wg*64 .. wg*64+63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(bars + 8 * s, (kt / STAGES) & 1);
    const uint32_t a = ring + s * STAGE_BYTES + wg * (64 * BK * 2);
    const uint32_t b = ring + s * STAGE_BYTES + A_BYTES;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // k16 step kk: 32 bytes along A's 128-byte rows, 16 rows down B
      const uint64_t da = smem_desc(a + kk * 32, 16, SWIZZLE_ATOM);
      const uint64_t db = smem_desc(b + kk * 16 * 128, B_BOX_BYTES, SWIZZLE_ATOM);
      wgmma_n256(acc, da, db);
    }
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    // the previous step's products have retired: its stage may be refilled
    wgmma_wait<1>();
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(bars + 8 * (STAGES + (kt - 1) % STAGES));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);

  // Epilogue. wgmma's accumulator layout: lane l of warp q holds rows
  // q*16 + l/4 (+8) and columns 8i + 2(l%4) (+1) of its warpgroup's tile.
  const int lane = threadIdx.x % 32;
  const int row0 = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 8 * half;
    const int h = y0 + r / TW;
    const int w = x0 + r % TW;
    if (h >= H || w >= W) continue;
    bf16* out = y + ((static_cast<size_t>(img) * H + h) * W + w) * Cout;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = n0 + 8 * i + 2 * (lane % 4);
      if (n >= Cout) continue;  // Cout % 8 == 0: n + 1 < Cout too
      const float2 bv = *reinterpret_cast<const float2*>(bias + n);
      float v0 = acc[4 * i + 2 * half] + bv.x;
      float v1 = acc[4 * i + 2 * half + 1] + bv.y;
      if (relu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + n) = __floats2bfloat162_rn(v0, v1);
    }
  }
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

int encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ENCODE_ERROR + CUDA_ERROR_NOT_FOUND;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                        dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // NONE: zeros outside
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + int(r);
}

}  // namespace

extern "C" {

// y = act(conv3x3_same(x, w) + bias); returns 0 once launched, else a
// cudaError_t or ENCODE_ERROR + the encode's CUresult.
int rovr_fused_conv3x3_bf16(const void* x, const void* w, const void* bias,
                            void* y, int B, int H, int W, int Cin, int Cout,
                            int relu, void* stream) {
  // The spatial tile: TW the power of two that covers W (at most 128),
  // TH = 128 / TW rows, so every box dimension stays within TMA's 256.
  int TW = 1;
  while (TW < W && TW < BM) TW *= 2;
  const int TH = BM / TW;

  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[4] = {cuuint64_t(Cin), cuuint64_t(W), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t x_strides[3] = {cuuint64_t(Cin) * 2, cuuint64_t(W) * Cin * 2,
                                   cuuint64_t(H) * W * Cin * 2};
  const cuuint32_t x_box[4] = {BK, cuuint32_t(TW), cuuint32_t(TH), 1};
  int err = encode(&x_map, x, 4, x_dims, x_strides, x_box);
  if (err) return err;
  const cuuint64_t w_dims[3] = {cuuint64_t(Cout), cuuint64_t(Cin), 9};
  const cuuint64_t w_strides[2] = {cuuint64_t(Cout) * 2, cuuint64_t(Cin) * Cout * 2};
  const cuuint32_t w_box[3] = {64, BK, 1};
  err = encode(&w_map, w, 3, w_dims, w_strides, w_box);
  if (err) return err;

  const cudaError_t cerr = cudaFuncSetAttribute(
      conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (cerr != cudaSuccess) return int(cerr);
  const dim3 grid(B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW), (Cout + BN - 1) / BN);
  conv3x3_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      x_map, w_map, static_cast<const float*>(bias), static_cast<bf16*>(y), H, W, Cout,
      TH, TW, (Cin + BK - 1) / BK, relu);
  return int(cudaGetLastError());
}

const char* rovr_cuda_error_string(int err) {
  if (err >= ENCODE_ERROR) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d",
             err - ENCODE_ERROR);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
