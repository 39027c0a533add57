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
// 3.35 TB/s of HBM. So every sample is read once, coalesced, and the
// per-channel tables (256 counts, the remap segments, the cdfs and edges)
// live in shared memory; nothing is padded or copied in device memory.
//
// The cdf step's shapes run from a few long rows (the color tail's 3
// channels of 512^2 pixels) to many short ones (relu3: 2k rows of 64^2 at
// the 256-px pass), so the histogram and the remap split each row over
// as many blocks as fill the card (split_rows) and read it with 16-byte
// loads, several in flight per thread; a row whose start is not 16-byte
// aligned (row c starts at float c * N) takes a scalar head and tail.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads == kBins, "one thread per bin in the table loads");
// 16-byte loads each thread issues before it uses the first
constexpr int kVecUnroll = 4;
// split_rows: a grid of ~4 blocks an SM on 132 SMs, each block at least
// this many samples, so that its table work stays small beside them: the
// histogram's (zeroing 8 tables, reducing them, the cluster's barriers)
// costs more than the remap's (one table build). Chosen on the card from
// path A's cdf-kernel time (4096 / 8192 / 16384 for the histogram, 4096 /
// 8192 for the remap).
constexpr int kTargetBlocks = 4 * 132;
constexpr int kMinHistSamples = 16384;
constexpr int kMinRemapSamples = 4096;
// the histogram's largest cluster (16 needs the non-portable attribute)
constexpr int kMaxCluster = 16;

// blocks per row: doubled while the grid is short of kTargetBlocks and
// each block keeps at least min_samples of its row
int split_rows(int rows, int n, int cap, int min_samples) {
  int g = 1;
  while (g < cap && static_cast<long long>(rows) * g < kTargetBlocks &&
         n / (2 * g) >= min_samples)
    g *= 2;
  return g;
}

// A row's layout: a scalar head of 0-3 samples up to the first 16-byte
// boundary, nvec float4s, a scalar tail of 0-3 samples. Part p of `parts`
// takes float4s [v0, v1); part 0 also takes the head and the tail.
struct RowSplit {
  int head, nvec, tail_start, v0, v1;
};

__device__ __forceinline__ RowSplit split_row(const float* row, int n, int part,
                                              int parts) {
  RowSplit r;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
  r.head = min((4 - mis) & 3, n);
  r.nvec = (n - r.head) >> 2;
  r.tail_start = r.head + 4 * r.nvec;
  const int per = (r.nvec + parts - 1) / parts;
  r.v0 = min(part * per, r.nvec);
  r.v1 = min(r.v0 + per, r.nvec);
  return r;
}

// the sample index thread `tid` of part 0 takes from the head and tail
// (-1: none)
__device__ __forceinline__ int edge_sample(const RowSplit& r, int n, int tid) {
  if (tid < r.head) return tid;
  const int i = r.tail_start + tid - r.head;
  return i < n ? i : -1;
}

// the float4s i, i + kThreads, ... (kVecUnroll of them) below `end`
__device__ __forceinline__ void load_batch(float4 (&q)[kVecUnroll],
                                           const float4* v, int i, int end) {
#pragma unroll
  for (int u = 0; u < kVecUnroll; ++u)
    if (i + u * kThreads < end) q[u] = __ldg(v + i + u * kThreads);
}

// torch.histc's bin: trunc((x - lo) * 256 / safe), clipped to [0, 255];
// safe = width, or 1 for a degenerate (width <= 0) range
__device__ __forceinline__ int hist_bin(float x, float lo, float safe) {
  const float u = __fdiv_rn(__fmul_rn(__fsub_rn(x, lo), 256.0f), safe);
  const int idx = __float2int_rz(u);  // rounds toward zero, as .to(int32)
  return min(max(idx, 0), kBins - 1);
}

// one cloud of a histogram launch: (C, n) rows and their (C, 256) counts
struct HistCloud {
  const float* x;
  float* out;
  int n;
};

// grid: one cluster of G blocks per (cloud, channel) row, the first C rows
// cloud a, the next C cloud b (a launch takes one or both clouds of a cdf
// step; the two share lo/hi). Each block counts its part of the row into
// per-warp sub-histograms in shared memory, so a pile of equal samples (a
// constant channel, a top-edge cluster) contends within one warp, not the
// block. The cluster then sums its G tables through distributed shared
// memory, block r summing the bins j with j % G == r across every block
// in integers and writing them as floats with plain stores (a cluster of
// one block stores its own sums, with no cluster barrier): the output
// needs no zeroing, there are no global atomics, and every launch gives
// the same counts (exact below 2^24 samples a bin).
__global__ void __launch_bounds__(kThreads)
histogram_cluster(HistCloud a, HistCloud b, const float* __restrict__ lo,
                  const float* __restrict__ hi, int c) {
  __shared__ unsigned int sub[kWarps][kBins];
  __shared__ unsigned int total[kBins];
  cg::cluster_group cluster = cg::this_cluster();
  const int g = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / g;
  const bool second = row >= c;
  const HistCloud cl = second ? b : a;
  const int ch = second ? row - c : row;
  const int tid = threadIdx.x;
  const float l = lo[ch];
  const float h = hi[ch];
  const float* x = cl.x + static_cast<size_t>(ch) * cl.n;
  const RowSplit r = split_row(x, cl.n, rank, g);
  const float4* v = reinterpret_cast<const float4*>(x + r.head);
  // the range, the first samples and the head/tail sample are in flight
  // while the sub-histograms are zeroed
  float4 q[kVecUnroll];
  load_batch(q, v, r.v0 + tid, r.v1);
  const int e = rank == 0 ? edge_sample(r, cl.n, tid) : -1;
  const float xe = e >= 0 ? x[e] : 0.0f;
  for (int i = tid; i < kWarps * kBins; i += kThreads) (&sub[0][0])[i] = 0u;
  __syncthreads();

  const float width = __fsub_rn(h, l);
  const float safe = width > 0.0f ? width : 1.0f;
  unsigned int* mine = sub[tid >> 5];
  if (e >= 0) atomicAdd(&mine[hist_bin(xe, l, safe)], 1u);
  constexpr int kStride = kThreads * kVecUnroll;
  for (int i = r.v0 + tid; i < r.v1; i += kStride) {
#pragma unroll
    for (int u = 0; u < kVecUnroll; ++u) {
      if (i + u * kThreads < r.v1) {
        atomicAdd(&mine[hist_bin(q[u].x, l, safe)], 1u);
        atomicAdd(&mine[hist_bin(q[u].y, l, safe)], 1u);
        atomicAdd(&mine[hist_bin(q[u].z, l, safe)], 1u);
        atomicAdd(&mine[hist_bin(q[u].w, l, safe)], 1u);
      }
    }
    load_batch(q, v, i + kStride, r.v1);
  }
  __syncthreads();

  // one thread per bin (kThreads == kBins)
  unsigned int t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += sub[w][tid];
  if (g == 1) {  // a row of one block: its counts are final
    cl.out[ch * kBins + tid] = __uint2float_rn(t);
    return;
  }
  total[tid] = t;
  cluster.sync();  // every block's table is complete and visible
  if (tid % g == rank) {
    unsigned int sum = 0;
    for (int k = 0; k < g; ++k) sum += *cluster.map_shared_rank(&total[tid], k);
    cl.out[ch * kBins + tid] = __uint2float_rn(sum);
  }
  cluster.sync();  // no block leaves while another still reads its table
}

// a channel's remap: its segment table in shared memory (slope, right
// edge xp, value fp per segment), lo, the safe step, and whether the range
// is wider than 0
struct Segments {
  const float4* seg;
  float lo, step_safe;
  bool live;
};

// segment j = clip(ceil((x - lo) / step_safe) - 1, 0, 255), then
// slope[j] * (x - xp[j]) + fp[j]; the last segment maps to fp[255], a
// degenerate range to fp[0]
__device__ __forceinline__ float pwl_map(const Segments& sg, float x) {
  if (!sg.live) return sg.seg[0].z;
  const float u = __fdiv_rn(__fsub_rn(x, sg.lo), sg.step_safe);
  const int j = min(max(__float2int_rz(ceilf(u)) - 1, 0), kBins - 1);
  const float4 e = sg.seg[j];
  return j >= kBins - 1 ? e.z : __fadd_rn(__fmul_rn(e.x, __fsub_rn(x, e.y)), e.z);
}

// grid: `parts` blocks per channel row, each a long run of the row. The
// block first builds its channel's segment table in shared memory, one
// thread per segment j: xp[j] = lo + (j+1)*step (the right edge), fp[j] =
// remapped[j] and slope[j] = (fp[j+1] - fp[j]) / (xp[j+1] - xp[j]), with
// step = (hi - lo) / 256 computed here. These are the per-sample
// operations of the plain version hoisted out of the sample loop, in the
// same order and rounding, so the output is bit-equal to it. Each sample
// x then costs one division (its segment j = clip(ceil((x - lo) /
// step_safe) - 1, 0, 255)), one 16-byte table read and
// slope[j] * (x - xp[j]) + fp[j]. The last segment maps to remapped[255]
// (the reference's non-finite fallback); a degenerate range maps every
// sample to remapped[0]. Loads and stores are 16 bytes wide: the wrapper
// gives `out` the same alignment as `t`.
__global__ void __launch_bounds__(kThreads)
pwl_tables(const float* __restrict__ t, const float* __restrict__ remapped,
           const float* __restrict__ lo, const float* __restrict__ hi,
           float* __restrict__ out, int n, int parts) {
  __shared__ float4 seg[kBins];  // (slope, xp, fp, unused)
  const int row = blockIdx.x / parts;
  const int part = blockIdx.x - row * parts;
  const int tid = threadIdx.x;
  const float l = lo[row];
  const float h = hi[row];
  const float* x = t + static_cast<size_t>(row) * n;
  float* y = out + static_cast<size_t>(row) * n;
  const RowSplit r = split_row(x, n, part, parts);
  const float4* v = reinterpret_cast<const float4*>(x + r.head);
  float4* w = reinterpret_cast<float4*>(y + r.head);
  // the first samples and the head/tail sample are in flight while the
  // table is built
  float4 q[kVecUnroll];
  load_batch(q, v, r.v0 + tid, r.v1);
  const int e = part == 0 ? edge_sample(r, n, tid) : -1;
  const float xe = e >= 0 ? x[e] : 0.0f;
  const float width = __fsub_rn(h, l);
  const float s = __fdiv_rn(width, 256.0f);
  const float s_safe = s > 0.0f ? s : 1.0f;
  {
    const float* table = remapped + row * kBins;
    const float fp_j = table[tid];
    const float xp_j = __fadd_rn(l, __fmul_rn(static_cast<float>(tid + 1), s));
    float slope = 0.0f;  // the last segment has none
    if (tid < kBins - 1) {
      const float xp_n = __fadd_rn(l, __fmul_rn(static_cast<float>(tid + 2), s));
      slope = __fdiv_rn(__fsub_rn(table[tid + 1], fp_j), __fsub_rn(xp_n, xp_j));
    }
    seg[tid] = make_float4(slope, xp_j, fp_j, 0.0f);
  }
  __syncthreads();

  const Segments sg{seg, l, s_safe, width > 0.0f};
  if (e >= 0) y[e] = pwl_map(sg, xe);
  constexpr int kStride = kThreads * kVecUnroll;
  for (int i = r.v0 + tid; i < r.v1; i += kStride) {
    float4 next[kVecUnroll];  // the next batch is loading while this one maps
    load_batch(next, v, i + kStride, r.v1);
#pragma unroll
    for (int u = 0; u < kVecUnroll; ++u) {
      if (i + u * kThreads < r.v1)
        w[i + u * kThreads] = make_float4(pwl_map(sg, q[u].x), pwl_map(sg, q[u].y),
                                          pwl_map(sg, q[u].z), pwl_map(sg, q[u].w));
      q[u] = next[u];
    }
  }
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

// x0 (C, n0) [and x1 (C, n1) when clouds == 2], lo/hi (C,) -> out0 (C, 256)
// [and out1]: the counts of each cloud on the shared ranges. One launch.
int optex_batched_histogram(const float* x0, const float* x1, const float* lo,
                            const float* hi, float* out0, float* out1, int c,
                            int n0, int n1, int clouds, void* stream) {
  if (c <= 0 || c > 65535 || n0 <= 0 || clouds < 1 || clouds > 2 ||
      (clouds == 2 && n1 <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      histogram_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const HistCloud a{x0, out0, n0};
  const HistCloud b = clouds == 2 ? HistCloud{x1, out1, n1} : a;
  const int rows = c * clouds;
  const int g = split_rows(rows, a.n > b.n ? a.n : b.n, kMaxCluster, kMinHistSamples);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * g));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(g);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, histogram_cluster, a, b, lo, hi, c);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// t (C, N), remapped (C, 256), lo/hi (C,) -> out (C, N); out must share
// t's alignment modulo 16 bytes (the 16-byte stores follow t's rows)
int optex_pwl_remap(const float* t, const float* remapped, const float* lo,
                    const float* hi, float* out, int c, int n, void* stream) {
  if (c <= 0 || n <= 0 || c > 65535 ||
      ((reinterpret_cast<uintptr_t>(t) ^ reinterpret_cast<uintptr_t>(out)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int parts = split_rows(c, n, 1 << 16, kMinRemapSamples);
  pwl_tables<<<c * parts, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, remapped, lo, hi, out, n, parts);
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
