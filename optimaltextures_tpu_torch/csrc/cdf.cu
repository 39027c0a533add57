// cdf-matching kernels for Hopper (sm_90a): the port of the three Pallas
// kernels of the cdf apply in optimaltextures_tpu:
//
//   batched_histogram  <- ops/pallas/histogram.py:98 batched_histogram
//   pwl_remap          <- ops/pallas/pwl_remap.py:74  pwl_remap
//   cdf_remap          <- ops/pallas/cdf_remap.py:97  cdf_remap (the legacy
//                         fused apply: cdfs, remap table and per-sample map)
//
// All take row-major (C, N) float32 sample rows, one channel per row, and
// per-channel shared ranges lo/hi (C,). All are bytes-bound on the card:
// a few dozen integer and float operations per 4-byte sample against
// 3.35 TB/s of HBM. So the design reads every sample once, coalesced, and
// keeps the per-channel tables (256 counts, 2 x 256 remap values, the cdfs
// and edges) in shared memory; nothing is padded or copied in device
// memory.
//
// Bin indices must equal the plain PyTorch versions' (ops/cdf.py) and
// torch.histc's bit for bit, so every step of the index and segment
// arithmetic is an explicitly rounded intrinsic (__fsub_rn, __fmul_rn,
// __fdiv_rn, __fadd_rn) in the plain versions' order: nvcc would otherwise
// contract a multiply and an add into one FMA, and no reciprocal stands in
// for a division. Build without -use_fast_math.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for bad sizes).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// samples per histogram block: 32 per thread, so a 512^2 cloud gives 32
// blocks per channel and each block flushes 256 global atomics
constexpr int kHistChunk = 8192;
static_assert(kThreads == kBins, "one thread per bin in the table loads");

// torch.histc's bin: trunc((x - lo) * 256 / safe), clipped to [0, 255];
// safe = width, or 1 for a degenerate (width <= 0) range
__device__ __forceinline__ int hist_bin(float x, float lo, float safe) {
  const float u = __fdiv_rn(__fmul_rn(__fsub_rn(x, lo), 256.0f), safe);
  const int idx = __float2int_rz(u);  // rounds toward zero, as .to(int32)
  return min(max(idx, 0), kBins - 1);
}

// grid (ceil(N / kHistChunk), C). Each warp counts into its own 256-bin
// sub-histogram in shared memory, so a pile of equal samples (a constant
// channel, a top-edge cluster) contends within one warp, not the block;
// the block then adds the bin sums of its warps into out (C, 256), which the
// caller zeroed. Counts stay below 2^24, so the float atomics are exact.
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const float* __restrict__ x, const float* __restrict__ lo,
                 const float* __restrict__ hi, float* __restrict__ out, int n) {
  __shared__ unsigned int sub[kWarps][kBins];
  const int c = blockIdx.y;
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads)
    (&sub[0][0])[i] = 0u;
  __syncthreads();

  const float l = lo[c];
  const float width = __fsub_rn(hi[c], l);
  const float safe = width > 0.0f ? width : 1.0f;
  const float* row = x + static_cast<size_t>(c) * n;
  unsigned int* mine = sub[threadIdx.x / 32];
  const int start = blockIdx.x * kHistChunk;
  const int stop = min(start + kHistChunk, n);
  for (int i = start + threadIdx.x; i < stop; i += kThreads)
    atomicAdd(&mine[hist_bin(row[i], l, safe)], 1u);
  __syncthreads();

  // one thread per bin (kThreads == kBins)
  unsigned int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += sub[w][threadIdx.x];
  if (total) atomicAdd(&out[c * kBins + threadIdx.x], static_cast<float>(total));
}

// grid (ceil(N / kThreads), C), one thread per sample: out = interp_ref(x;
// uniform right edges lo + (j+1)*step, remapped) with
// j = clip(ceil((x - lo) / step_safe) - 1, 0, 255). The last segment maps to
// remapped[255] (the reference's non-finite fallback); a degenerate range
// maps every sample to remapped[0].
__global__ void __launch_bounds__(kThreads)
pwl_kernel(const float* __restrict__ t, const float* __restrict__ remapped,
           const float* __restrict__ lo, const float* __restrict__ hi,
           const float* __restrict__ step, float* __restrict__ out, int n) {
  __shared__ float fp[kBins + 1];  // fp[l + 1] is the clipped idx_next value
  const int c = blockIdx.y;
  const float* table = remapped + c * kBins;
  fp[threadIdx.x] = table[threadIdx.x];
  if (threadIdx.x == 0) fp[kBins] = table[kBins - 1];
  __syncthreads();

  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float l = lo[c];
  const float s = step[c];
  const float width = __fsub_rn(hi[c], l);
  const float x = t[static_cast<size_t>(c) * n + i];
  float f;
  if (width > 0.0f) {
    const float s_safe = s > 0.0f ? s : 1.0f;
    const float u = __fdiv_rn(__fsub_rn(x, l), s_safe);
    const int j = min(max(__float2int_rz(ceilf(u)) - 1, 0), kBins - 1);
    const float fp_i = fp[j];
    if (j >= kBins - 1) {
      f = fp_i;
    } else {
      const float fp_n = fp[j + 1];
      const float xp_i = __fadd_rn(l, __fmul_rn(static_cast<float>(j + 1), s));
      const float xp_n = __fadd_rn(l, __fmul_rn(static_cast<float>(j + 2), s));
      const float slope = __fdiv_rn(__fsub_rn(fp_n, fp_i), __fsub_rn(xp_n, xp_i));
      f = __fadd_rn(__fmul_rn(slope, __fsub_rn(x, xp_i)), fp_i);
    }
  } else {
    f = fp[0];
  }
  out[static_cast<size_t>(c) * n + i] = f;
}

// the reference's interp on a non-decreasing 256-entry table xp (shared
// memory) with values fp: i = min(#(xp < x), 255), found by a branchless
// binary search (on sorted nodes it equals the TPU kernel's compare-count;
// its 8 steps reach at most 255, which is the clip), idx_next =
// min(i + 1, 255), then the linear map with the two-stage non-finite
// fallback f0 -> f1 -> fp[i] (duplicate nodes divide by zero).
__device__ __forceinline__ float interp256(float x, const float* xp,
                                           const float* fp) {
  int i = 0;
#pragma unroll
  for (int step = kBins / 2; step > 0; step >>= 1)
    if (xp[i + step - 1] < x) i += step;
  const int nx = min(i + 1, kBins - 1);
  const float xp_i = xp[i], xp_n = xp[nx], fp_i = fp[i], fp_n = fp[nx];
  const float slope = __fdiv_rn(__fsub_rn(fp_n, fp_i), __fsub_rn(xp_n, xp_i));
  const float f0 = __fadd_rn(__fmul_rn(slope, __fsub_rn(x, xp_i)), fp_i);
  if (isfinite(f0)) return f0;
  const float f1 = __fadd_rn(__fmul_rn(slope, __fsub_rn(x, xp_n)), fp_n);
  return isfinite(f1) ? f1 : fp_i;
}

// samples per cdf_remap block: 16 per thread, so each block's table build
// (two scans and 256 table queries) is shared by 4096 samples
constexpr int kRemapChunk = 4096;

// grid (ceil(N / kRemapChunk), C). Each block builds its channel's tables in
// shared memory: both cdfs (inclusive scans of the counts, divided by the
// total; integer counts below 2^24 sum exactly in any order), the right
// edges lo + j * (width / 256), j = 1..256 (lo where width <= 0), and the
// cdf -> cdf remap table remapped[i] = interp(t_cdf[i]; s_cdf -> edges).
// Then every sample x of its chunk maps to interp(x; edges -> remapped).
__global__ void __launch_bounds__(kThreads)
cdf_remap_kernel(const float* __restrict__ t, const float* __restrict__ t_hist,
                 const float* __restrict__ s_hist, const float* __restrict__ lo,
                 const float* __restrict__ hi, float* __restrict__ out, int n) {
  __shared__ float t_cdf[kBins], s_cdf[kBins], edges[kBins], remapped[kBins];
  const int c = blockIdx.y;
  const int j = threadIdx.x;  // one thread per table entry (kThreads == kBins)
  t_cdf[j] = t_hist[c * kBins + j];
  s_cdf[j] = s_hist[c * kBins + j];
  __syncthreads();
  for (int off = 1; off < kBins; off <<= 1) {  // Hillis-Steele scans
    const float a = j >= off ? t_cdf[j - off] : 0.0f;
    const float b = j >= off ? s_cdf[j - off] : 0.0f;
    __syncthreads();
    t_cdf[j] = __fadd_rn(t_cdf[j], a);
    s_cdf[j] = __fadd_rn(s_cdf[j], b);
    __syncthreads();
  }
  const float t_total = t_cdf[kBins - 1], s_total = s_cdf[kBins - 1];
  __syncthreads();
  t_cdf[j] = __fdiv_rn(t_cdf[j], t_total);
  s_cdf[j] = __fdiv_rn(s_cdf[j], s_total);
  const float l = lo[c];
  const float width = __fsub_rn(hi[c], l);
  edges[j] = width > 0.0f
      ? __fadd_rn(l, __fmul_rn(static_cast<float>(j + 1), __fdiv_rn(width, 256.0f)))
      : l;
  __syncthreads();
  remapped[j] = interp256(t_cdf[j], s_cdf, edges);
  __syncthreads();

  const float* row = t + static_cast<size_t>(c) * n;
  float* orow = out + static_cast<size_t>(c) * n;
  const int start = blockIdx.x * kRemapChunk;
  const int stop = min(start + kRemapChunk, n);
  for (int i = start + j; i < stop; i += kThreads)
    orow[i] = interp256(row[i], edges, remapped);
}

}  // namespace

extern "C" {

// x (C, N), lo/hi (C,) -> out (C, 256) += counts; out must be zeroed
int optex_batched_histogram(const float* x, const float* lo, const float* hi,
                            float* out, int c, int n, void* stream) {
  if (c <= 0 || n <= 0 || c > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kHistChunk - 1) / kHistChunk, c);
  histogram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, lo, hi, out, n);
  return static_cast<int>(cudaGetLastError());
}

// t (C, N), remapped (C, 256), lo/hi/step (C,) -> out (C, N)
int optex_pwl_remap(const float* t, const float* remapped, const float* lo,
                    const float* hi, const float* step, float* out, int c, int n,
                    void* stream) {
  if (c <= 0 || n <= 0 || c > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads, c);
  pwl_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, remapped, lo, hi, step, out, n);
  return static_cast<int>(cudaGetLastError());
}

// t (C, N), t_hist/s_hist (C, 256), lo/hi (C,) -> out (C, N)
int optex_cdf_remap(const float* t, const float* t_hist, const float* s_hist,
                    const float* lo, const float* hi, float* out, int c, int n,
                    void* stream) {
  if (c <= 0 || n <= 0 || c > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kRemapChunk - 1) / kRemapChunk, c);
  cdf_remap_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, t_hist, s_hist, lo, hi, out, n);
  return static_cast<int>(cudaGetLastError());
}

const char* optex_cdf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
