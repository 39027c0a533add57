// The 64 -> 64 channel 3x3 conv prototype for Hopper (sm_90a): the port of
// tools/pallas_conv_proto.py:109 conv64_pallas (body _kernel :63).
//
//   out[h, w, co, b] = relu(sum_{r, s, ci} x[h + r, w + s, ci, b] * W[r, s, ci, co])
//
// on a pre-padded bf16 input x (H+2, W+2, 64, B) (a valid conv, no bias), in
// float32, rounded to bf16 once at the end. The weights come in the tool's
// packed layout wrow (3, 128, 256) bf16, whose phase-0 rows hold every tap:
// wrow[r, co, 64*s + ci] = W[r, s, ci, co] (the phase-1 rows repeat them one
// window column on, for the TPU's 2-pixel MXU packing).
//
// What bounds it on the H100: at the tool's 512 px x 128 shape the function
// needs 2.47e12 operations (2.50 ms at the 989 TF/s bf16 tensor-core rate)
// and 8.6 GB of bytes (2.57 ms at 3.35 TB/s): bytes, with operations level.
// This kernel is the simple one that comes first: it runs the products on
// the FP32 cores (67 TF/s), so it is bound by operations at some 37 ms, far
// from the function's bound; tensor cores (mma.sync / wgmma) and TMA are a
// later change. What the design does: the batch is the innermost axis, so
// consecutive threads take consecutive batch elements and every load and
// store is coalesced; a block keeps its 32 output channels' weights in
// shared memory as float32 (73,728 bytes of dynamic shared memory); every
// weight read from shared memory is a broadcast float4 serving two output
// pixels, and each input value read feeds 32 accumulators. The TPU
// kernel's th x tw tiles and manual double-buffered DMA do not carry over.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for bad sizes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kC = 64;          // channels in and out
constexpr int kCoTile = 32;     // output channels per block (grid z picks a half)
constexpr int kThreads = 128;   // batch elements per block, one per thread
constexpr int kPixels = 64;     // output pixels per block, two at a time
constexpr int kSmemBytes = 9 * kC * kCoTile * 4;  // [tap][ci][co] float32

// grid (ceil(H*W / kPixels), ceil(B / kThreads), 64 / kCoTile)
__global__ void __launch_bounds__(kThreads)
conv64_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ wrow,
              __nv_bfloat16* __restrict__ out, int h, int w, int b) {
  extern __shared__ float4 smem[];
  float* sw = reinterpret_cast<float*>(smem);
  const int co0 = blockIdx.z * kCoTile;
  for (int e = threadIdx.x; e < 9 * kC * kCoTile; e += kThreads) {
    const int k = e % kCoTile;
    const int ci = (e / kCoTile) % kC;
    const int tap = e / (kCoTile * kC);
    const int r = tap / 3, s = tap % 3;
    sw[e] = __bfloat162float(
        wrow[(static_cast<int64_t>(r) * 2 * kC + co0 + k) * 4 * kC + s * kC + ci]);
  }
  __syncthreads();
  const int bi = blockIdx.y * kThreads + threadIdx.x;
  if (bi >= b) return;  // no barrier follows

  const int64_t pix = static_cast<int64_t>(kC) * b;  // elements per (h, w)
  const int n_pix = h * w;
  const int p_end = min(static_cast<int>(blockIdx.x) * kPixels + kPixels, n_pix);
  for (int p = blockIdx.x * kPixels; p < p_end; p += 2) {
    // two output pixels share every weight read; a ragged last pixel
    // repeats the first and is not stored
    const int q = p + 1 < p_end ? p + 1 : p;
    const int ph = p / w, pw = p % w, qh = q / w, qw = q % w;
    float acc0[kCoTile], acc1[kCoTile];
#pragma unroll
    for (int k = 0; k < kCoTile; ++k) acc0[k] = acc1[k] = 0.0f;
    for (int tap = 0; tap < 9; ++tap) {
      const int r = tap / 3, s = tap % 3;
      const __nv_bfloat16* x0 =
          x + ((static_cast<int64_t>(ph + r) * (w + 2) + pw + s) * pix + bi);
      const __nv_bfloat16* x1 =
          x + ((static_cast<int64_t>(qh + r) * (w + 2) + qw + s) * pix + bi);
      const float4* ws = reinterpret_cast<const float4*>(sw + tap * kC * kCoTile);
#pragma unroll 2
      for (int ci = 0; ci < kC; ++ci) {
        const float v0 = __bfloat162float(x0[static_cast<int64_t>(ci) * b]);
        const float v1 = __bfloat162float(x1[static_cast<int64_t>(ci) * b]);
#pragma unroll
        for (int g = 0; g < kCoTile / 4; ++g) {
          const float4 wv = ws[ci * (kCoTile / 4) + g];
          acc0[4 * g + 0] = fmaf(v0, wv.x, acc0[4 * g + 0]);
          acc0[4 * g + 1] = fmaf(v0, wv.y, acc0[4 * g + 1]);
          acc0[4 * g + 2] = fmaf(v0, wv.z, acc0[4 * g + 2]);
          acc0[4 * g + 3] = fmaf(v0, wv.w, acc0[4 * g + 3]);
          acc1[4 * g + 0] = fmaf(v1, wv.x, acc1[4 * g + 0]);
          acc1[4 * g + 1] = fmaf(v1, wv.y, acc1[4 * g + 1]);
          acc1[4 * g + 2] = fmaf(v1, wv.z, acc1[4 * g + 2]);
          acc1[4 * g + 3] = fmaf(v1, wv.w, acc1[4 * g + 3]);
        }
      }
    }
    __nv_bfloat16* o0 = out + (static_cast<int64_t>(p) * kC + co0) * b + bi;
#pragma unroll
    for (int k = 0; k < kCoTile; ++k)
      o0[static_cast<int64_t>(k) * b] = __float2bfloat16_rn(fmaxf(acc0[k], 0.0f));
    if (q != p) {
      __nv_bfloat16* o1 = out + (static_cast<int64_t>(q) * kC + co0) * b + bi;
#pragma unroll
      for (int k = 0; k < kCoTile; ++k)
        o1[static_cast<int64_t>(k) * b] = __float2bfloat16_rn(fmaxf(acc1[k], 0.0f));
    }
  }
}

}  // namespace

extern "C" {

// xpad (H+2, W+2, 64, B) bf16, wrow (3, 128, 256) bf16 -> out (H, W, 64, B) bf16
int optex_conv64(const void* xpad, const void* wrow, void* out, int h, int w,
                 int b, void* stream) {
  if (h <= 0 || w <= 0 || b <= 0 || static_cast<int64_t>(h) * w > INT_MAX - kPixels ||
      (b + kThreads - 1) / kThreads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((h * w + kPixels - 1) / kPixels, (b + kThreads - 1) / kThreads,
                  kC / kCoTile);
  conv64_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xpad), static_cast<const __nv_bfloat16*>(wrow),
      static_cast<__nv_bfloat16*>(out), h, w, b);
  return static_cast<int>(cudaGetLastError());
}

const char* optex_conv64_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
