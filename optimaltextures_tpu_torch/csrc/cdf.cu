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
// the 256-px pass), so every kernel splits each row over as many blocks
// as fill the card (split_rows) and reads it with 16-byte loads, several
// in flight per thread; a row whose start is not 16-byte aligned (row c
// starts at float c * N) takes a scalar head and tail. The two remaps
// share their sample loop (map_run) and differ in the per-sample map.
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
// costs more than the remaps' (one table build). Chosen on the card from
// path A's cdf-kernel time (4096 / 8192 / 16384 for the histogram, 4096 /
// 8192 for pwl_remap); cdf_remap takes pwl_remap's.
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

// the block's run of its row through `map`: the head/tail sample e (read
// into xe) and the float4s [r.v0, r.v1), whose first batch is already in
// q; the next batch loads while this one maps, and every store is 16 bytes
// wide (y = the output row, w its float4s past the head)
template <class Map>
__device__ __forceinline__ void map_run(const Map& map, const RowSplit& r,
                                        const float4* v, float4* w, float* y,
                                        int e, float xe, float4 (&q)[kVecUnroll]) {
  if (e >= 0) y[e] = map(xe);
  constexpr int kStride = kThreads * kVecUnroll;
  for (int i = r.v0 + threadIdx.x; i < r.v1; i += kStride) {
    float4 next[kVecUnroll];
    load_batch(next, v, i + kStride, r.v1);
#pragma unroll
    for (int u = 0; u < kVecUnroll; ++u) {
      if (i + u * kThreads < r.v1)
        w[i + u * kThreads] = make_float4(map(q[u].x), map(q[u].y), map(q[u].z),
                                          map(q[u].w));
      q[u] = next[u];
    }
  }
}

// pwl_remap's map: its segment table in shared memory (slope, right edge
// xp, value fp per segment), lo, the safe step, and whether the range is
// wider than 0. Segment j = clip(ceil((x - lo) / step_safe) - 1, 0, 255),
// then slope[j] * (x - xp[j]) + fp[j]; the last segment maps to fp[255], a
// degenerate range to fp[0].
struct Segments {
  const float4* seg;
  float lo, step_safe;
  bool live;

  __device__ __forceinline__ float operator()(float x) const {
    if (!live) return seg[0].z;
    const float u = __fdiv_rn(__fsub_rn(x, lo), step_safe);
    const int j = min(max(__float2int_rz(ceilf(u)) - 1, 0), kBins - 1);
    const float4 e = seg[j];
    return j >= kBins - 1 ? e.z : __fadd_rn(__fmul_rn(e.x, __fsub_rn(x, e.y)), e.z);
  }
};

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

  map_run(Segments{seg, l, s_safe, width > 0.0f}, r, v, w, y, e, xe, q);
}

// the reference's index on a non-decreasing 256-entry table xp (shared
// memory): min(#(xp < x), 255), by a branchless binary search (on sorted
// nodes it equals the TPU kernel's compare-count; its 8 steps reach at
// most 255, which is the clip)
__device__ __forceinline__ int search256(float x, const float* xp) {
  int i = 0;
#pragma unroll
  for (int step = kBins / 2; step > 0; step >>= 1)
    if (xp[i + step - 1] < x) i += step;
  return i;
}

// the reference's linear map on segment i of nodes xp with values fp,
// i' = min(i + 1, 255), with the two-stage non-finite fallback f0 -> f1 ->
// fp[i] (duplicate nodes divide by zero)
__device__ __forceinline__ float lerp_fallback(float x, float slope, float xp_i,
                                               float fp_i, float xp_n, float fp_n) {
  const float f0 = __fadd_rn(__fmul_rn(slope, __fsub_rn(x, xp_i)), fp_i);
  if (isfinite(f0)) return f0;
  const float f1 = __fadd_rn(__fmul_rn(slope, __fsub_rn(x, xp_n)), fp_n);
  return isfinite(f1) ? f1 : fp_i;
}

// cdf_remap's map: interp(x; edges -> remapped) with the reference's index
// i = min(#(edges < x), 255). seg[j] = (slope_j, edges[j], remapped[j],
// edges[j-1] or -inf for j = 0), slope_j the per-sample form's slope on
// segment j, j' = min(j + 1, 255) (NaN for j = 255, as there). The guess
// j = clip(ceil((x - lo) / step_safe) - 1, 0, 255) is i exactly when
// edges[j-1] < x (true for j = 0) and x <= edges[j] (or j = 255), since the
// edges never decrease; a sample that fails the check (within a rounding
// of an edge, or on a row whose f32 edges collapse) takes the binary
// search. seg[j'] is read only when f0 is not finite.
struct GuessedSegments {
  const float4* seg;
  const float* edges;
  float lo, step_safe;

  __device__ __forceinline__ float operator()(float x) const {
    const float u = __fdiv_rn(__fsub_rn(x, lo), step_safe);
    int i = min(max(__float2int_rz(ceilf(u)), 1), kBins) - 1;
    float4 s = seg[i];
    if (!(s.w < x && (x <= s.y || i == kBins - 1))) {
      i = search256(x, edges);
      s = seg[i];
    }
    const float f0 = __fadd_rn(__fmul_rn(s.x, __fsub_rn(x, s.y)), s.z);
    if (isfinite(f0)) return f0;
    const float4 nx = seg[min(i + 1, kBins - 1)];
    const float f1 = __fadd_rn(__fmul_rn(s.x, __fsub_rn(x, nx.y)), nx.z);
    return isfinite(f1) ? f1 : s.z;
  }
};

// grid: `parts` blocks per channel row (split_rows), each a long run of
// the row, read and written 16 bytes at a time (the wrapper gives `out`
// t's alignment). Each block builds its channel's tables once, one thread
// per bin, while its first samples load: both cdfs by warp-shuffle
// inclusive scans and one pass over the 8 warp totals (integer counts
// below 2^24 sum exactly in any order), divided by the total; the right
// edges lo + (j+1) * (width / 256) (lo where width <= 0); remapped[j] =
// interp(t_cdf[j]; s_cdf -> edges) by binary search; then the segment
// table of GuessedSegments. Every operation is the plain version's, in its
// rounding, so the output is bit-equal to it.
__global__ void __launch_bounds__(kThreads)
cdf_segments(const float* __restrict__ t, const float* __restrict__ t_hist,
             const float* __restrict__ s_hist, const float* __restrict__ lo,
             const float* __restrict__ hi, float* __restrict__ out, int n,
             int parts) {
  __shared__ float4 seg[kBins];
  __shared__ float s_cdf[kBins], edges[kBins], remapped[kBins];
  __shared__ float totals[2][kWarps];
  const int row = blockIdx.x / parts;
  const int part = blockIdx.x - row * parts;
  const int tid = threadIdx.x;  // one thread per bin (kThreads == kBins)
  const int lane = tid & 31, warp = tid >> 5;
  const float* x = t + static_cast<size_t>(row) * n;
  float* y = out + static_cast<size_t>(row) * n;
  const RowSplit r = split_row(x, n, part, parts);
  const float4* v = reinterpret_cast<const float4*>(x + r.head);
  float4* w = reinterpret_cast<float4*>(y + r.head);
  // the first samples and the head/tail sample are in flight while the
  // tables are built
  float4 q[kVecUnroll];
  load_batch(q, v, r.v0 + tid, r.v1);
  const int e = part == 0 ? edge_sample(r, n, tid) : -1;
  const float xe = e >= 0 ? x[e] : 0.0f;

  float tc = t_hist[static_cast<size_t>(row) * kBins + tid];
  float sc = s_hist[static_cast<size_t>(row) * kBins + tid];
  const float l = lo[row];
  const float width = __fsub_rn(hi[row], l);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float a = __shfl_up_sync(0xffffffffu, tc, off);
    const float b = __shfl_up_sync(0xffffffffu, sc, off);
    if (lane >= off) {
      tc = __fadd_rn(tc, a);
      sc = __fadd_rn(sc, b);
    }
  }
  if (lane == 31) {
    totals[0][warp] = tc;
    totals[1][warp] = sc;
  }
  __syncthreads();
  float t_total = 0.0f, s_total = 0.0f;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const float a = totals[0][k], b = totals[1][k];
    if (k < warp) {
      tc = __fadd_rn(tc, a);
      sc = __fadd_rn(sc, b);
    }
    t_total = __fadd_rn(t_total, a);
    s_total = __fadd_rn(s_total, b);
  }
  const float t_cdf = __fdiv_rn(tc, t_total);
  s_cdf[tid] = __fdiv_rn(sc, s_total);
  const float step = __fdiv_rn(width, 256.0f);
  const float edge =
      width > 0.0f ? __fadd_rn(l, __fmul_rn(static_cast<float>(tid + 1), step)) : l;
  edges[tid] = edge;
  __syncthreads();

  {  // remapped[tid] = interp(t_cdf[tid]; s_cdf -> edges)
    const int i = search256(t_cdf, s_cdf);
    const int nx = min(i + 1, kBins - 1);
    const float slope = __fdiv_rn(__fsub_rn(edges[nx], edges[i]),
                                  __fsub_rn(s_cdf[nx], s_cdf[i]));
    remapped[tid] = lerp_fallback(t_cdf, slope, s_cdf[i], edges[i], s_cdf[nx],
                                  edges[nx]);
  }
  __syncthreads();
  {
    const int nx = min(tid + 1, kBins - 1);
    const float fp = remapped[tid];
    const float slope =
        __fdiv_rn(__fsub_rn(remapped[nx], fp), __fsub_rn(edges[nx], edge));
    const float prev = tid > 0 ? edges[tid - 1] : -__int_as_float(0x7f800000);
    seg[tid] = make_float4(slope, edge, fp, prev);  // -inf: below every x
  }
  __syncthreads();

  map_run(GuessedSegments{seg, edges, l, step > 0.0f ? step : 1.0f}, r, v, w, y, e,
          xe, q);
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
  // per device, so set at every launch: a server's workers launch on
  // several GPUs from one process
  const cudaError_t attr = cudaFuncSetAttribute(
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

// t (C, N), t_hist/s_hist (C, 256), lo/hi (C,) -> out (C, N); out must
// share t's alignment modulo 16 bytes (the 16-byte stores follow t's rows)
int optex_cdf_remap(const float* t, const float* t_hist, const float* s_hist,
                    const float* lo, const float* hi, float* out, int c, int n,
                    void* stream) {
  if (c <= 0 || n <= 0 ||
      ((reinterpret_cast<uintptr_t>(t) ^ reinterpret_cast<uintptr_t>(out)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int parts = split_rows(c, n, 1 << 16, kMinRemapSamples);
  cdf_segments<<<c * parts, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, t_hist, s_hist, lo, hi, out, n, parts);
  return static_cast<int>(cudaGetLastError());
}

const char* optex_cdf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
