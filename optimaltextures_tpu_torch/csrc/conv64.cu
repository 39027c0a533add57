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
// moves 8.6 GB (2.57 ms at 3.35 TB/s) and does 2.47e12 operations (2.50 ms
// at the 989 TF/s bf16 tensor-core rate): bytes, with operations level. So
// the products run on the tensor cores (wgmma) and every input byte should
// come from HBM about once.
//
// Design: each output pixel's (64 co x 64 b) tile is one GEMM, M = 64 output
// channels, N = a 64-wide batch tile (innermost and contiguous), K = 9 taps x
// 64 input channels = 576, issued as 36 wgmma.m64n64k16 steps.
// * A, the weights, K-major [tap][co][ci], is assembled once per block from
//   wrow's phase-0 rows (ops/conv64.py pack_tc describes it) into 72 KB of
//   shared memory in the 128-byte-swizzled layout, and stays resident.
// * B is the input slab x[h+r, w+s, :, b-tile]: 64 ci rows of 64 b (128 B),
//   MN-major, which wgmma reads through the transpose bit. A TMA box
//   {64 b, 64 ci, 1, 1} with SWIZZLE_128B lays it out as wgmma's canonical
//   128-byte-swizzled atoms (8 ci rows x 128 B).
// * Persistent blocks walk work items (a b-tile, an output row, a strip of
//   up to 64 pixels). Each input slab feeds 9 output pixels: a ring of 5
//   columns (3 slabs each) holds the current pixel's 3 columns and the next
//   ones, and a producer warp loads each new column once by TMA, completing
//   on the slot's "full" mbarrier, after the consumers freed the slot
//   ("empty" mbarrier). Each consumer warpgroup watches every column land,
//   in order, and frees only columns it has seen land (wait_landed). The
//   50 MB L2 serves the reuse between rows.
// * Two consumer warpgroups take alternate pixels of a strip (ping-pong):
//   each waits for its pixel's columns, issues the 36 wgmma, waits, and runs
//   the epilogue (ReLU, one bf16 rounding, staged through shared memory so
//   each 128-byte row of 64 b is written by 8 threads with 16-byte stores)
//   while the other's wgmma keep the tensor cores busy. A ring slot is free
//   once both warpgroups have released it (the "empty" barrier counts 2).
// * TMA needs 16-byte global strides and the ci stride is 2B bytes: a batch
//   that is not a multiple of 8 takes the masked path, where the producer
//   warp fills the same swizzled slabs with plain loads (zeros past B).
// Every offset into x and out is 64-bit; the TMA map is 4-D (B, 64, W+2,
// H+2), so each coordinate fits in int32 at 512 px x 128 (2.2e9 elements).
// 216,144 bytes of dynamic shared memory: one block (9 warps) per SM.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for bad sizes).

#include <cuda.h>  // CUtensorMap and the driver's enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kC = 64;                               // channels in and out
constexpr int kBTile = 64;                           // batch elements per tile (wgmma N)
constexpr int kStrip = 64;                           // output pixels per work item
constexpr int kRing = 5;                             // input columns in the ring
constexpr int kSlabBytes = kC * kBTile * 2;          // 64 ci x 64 b bf16
constexpr int kColBytes = 3 * kSlabBytes;            // rows h, h+1, h+2 of a column
constexpr int kTapBytes = kC * kC * 2;               // A for one tap
constexpr int kStageStride = kBTile + 8;             // bf16 per staged row
constexpr int kConsumers = 256;                      // two warpgroups
constexpr int kThreads = kConsumers + 32;            // + the producer warp
constexpr int kOffRing = 9 * kTapBytes;              // 73,728
constexpr int kOffStage = kOffRing + kRing * kColBytes;
constexpr int kStageBytes = kC * kStageStride * 2;   // one per warpgroup
constexpr int kOffBar = kOffStage + 2 * kStageBytes;
constexpr int kSmemBytes = kOffBar + 2 * kRing * 8 + 1024;   // + alignment slack

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// spin until the phase of parity `parity` has completed (the loop stays in
// PTX, so the compiler sees no data-dependent branch around the wgmma)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 f32) = [d +] A (64 x 16, K-major) * B (16 x 64, MN-major)
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t a, uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

struct Item {
  int bt, hh, w0, npix;
};

__device__ __forceinline__ Item decode(long long it, int h, int w, int strips) {
  Item m;
  const int strip = static_cast<int>(it % strips);
  const long long rest = it / strips;
  m.hh = static_cast<int>(rest % h);
  m.bt = static_cast<int>(rest / h);
  m.w0 = strip * kStrip;
  m.npix = min(kStrip, w - m.w0);
  return m;
}

// a consumer warpgroup waits, in order, until every ring column below `end`
// has landed; `seen` counts the columns it has watched land. In order,
// because a parity wait cannot tell a slot's phase k from phase k - 2: a
// wait for column c must come after column c - 5 (the slot's previous
// column) was seen to land. And a warpgroup releases only columns it has
// seen land, or its arrival could count toward the slot's previous phase
// and free a slab the other warpgroup still reads.
__device__ __forceinline__ void wait_landed(uint32_t s_bar, uint32_t& seen,
                                            uint32_t end) {
  for (; seen < end; ++seen) mbar_wait(s_bar + 8 * (seen % kRing), (seen / kRing) & 1);
}

// consumer: wait for pixel i's 3 columns (ring counters c0 + i .. + 2), then
// issue its 36 k-steps as one wgmma group
__device__ __forceinline__ void issue_pixel(float (&acc)[32], uint32_t c0, int i,
                                            uint32_t s_a, uint32_t s_ring,
                                            uint32_t s_bar, uint32_t& seen) {
  wait_landed(s_bar, seen, c0 + i + 3);
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int r = tap / 3, s = tap % 3;
    const uint32_t slab = s_ring + ((c0 + i + s) % kRing) * kColBytes + r * kSlabBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // A: +32 bytes per 16 ci inside the swizzled row; SBO = 8 rows of co.
      // B: +16 ci rows (2048 bytes); 8-row groups of ci are 1024 bytes
      // apart (one 64-wide MN block, so the leading offset is not used).
      wgmma_64x64x16(acc, desc_sw128(s_a + tap * kTapBytes + kk * 32, 16, 1024),
                     desc_sw128(slab + kk * 2048, 1024, 1024), tap | kk);
    }
  }
  wgmma_commit();
}

// a warpgroup frees its hold on the item's columns [lo, hi) (ring counters
// c0 + lo ..); a slot is free once both warpgroups have arrived
__device__ __forceinline__ void release(uint32_t s_bar, uint32_t c0, int lo, int hi) {
  for (int j = lo; j < hi; ++j) mbar_arrive(s_bar + 8 * (kRing + (c0 + j) % kRing));
}

// consumer warpgroup wg, once pixel i's group has completed: ReLU, one bf16
// rounding, stage, free the columns this warpgroup's next pixel (i + 2) does
// not read, store
__device__ __forceinline__ void finish_pixel(float (&acc)[32], const Item& m, int i,
                                             int& rel, int wg, uint32_t c0,
                                             uint32_t s_bar, uint32_t& seen,
                                             __nv_bfloat16* stage,
                                             __nv_bfloat16* __restrict__ out, int w,
                                             int b) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  fence_acc(acc);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int co = 16 * warp + (lane >> 2) + 8 * hf, col = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(stage + co * kStageStride + col) =
          __floats2bfloat162_rn(fmaxf(acc[4 * j + 2 * hf], 0.f),
                                fmaxf(acc[4 * j + 2 * hf + 1], 0.f));
    }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  // every thread of the warpgroup is past its wgmma wait for pixel i
  const int hi = i + 2 < m.npix ? i + 2 : m.npix + 2;
  wait_landed(s_bar, seen, c0 + hi);
  if (tid == 0) release(s_bar, c0, rel, hi);
  rel = hi;
  __nv_bfloat16* op = out + (static_cast<int64_t>(m.hh) * w + m.w0 + i) * kC * b;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = q * 16 + (tid >> 3), b0 = m.bt * kBTile + (tid & 7) * 8;
    const __nv_bfloat16* sp = stage + row * kStageStride + (tid & 7) * 8;
    __nv_bfloat16* gp = op + static_cast<int64_t>(row) * b + b0;
    if (b % 8 == 0 && b0 + 8 <= b) {
      *reinterpret_cast<uint4*>(gp) = *reinterpret_cast<const uint4*>(sp);
    } else {
      for (int e = 0; e < 8; ++e)
        if (b0 + e < b) gp[e] = sp[e];
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
conv64_wgmma(const __grid_constant__ CUtensorMap xmap,
             const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ wrow,
             __nv_bfloat16* __restrict__ out, int h, int w, int b, int use_tma) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (saddr(smem_raw) & 1023u)) & 1023u);
  const uint32_t s_a = saddr(sm), s_ring = s_a + kOffRing, s_bar = s_a + kOffBar;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(s_bar + 8 * i, 1);              // full: the producer's arrival
      mbar_init(s_bar + 8 * (kRing + i), 2);    // empty: both warpgroups' release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // A[tap][co][ci] from wrow[r, co, 64 s + ci]: row co of a tap is 128 bytes,
  // its 16-byte chunk c stored at chunk c ^ (co % 8) (SWIZZLE_128B)
  for (int i = tid; i < 9 * kC * 8; i += kThreads) {
    const int chunk = i & 7, co = (i >> 3) & (kC - 1), tap = i >> 9;
    const int r = tap / 3, s = tap % 3;
    const uint4 v = *reinterpret_cast<const uint4*>(
        wrow + (static_cast<int64_t>(r) * 2 * kC + co) * 4 * kC + s * kC + chunk * 8);
    *reinterpret_cast<uint4*>(sm + tap * kTapBytes + co * 128 +
                              ((chunk ^ (co & 7)) << 4)) = v;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int strips = (w + kStrip - 1) / kStrip;
  const long long items =
      static_cast<long long>((b + kBTile - 1) / kBTile) * h * strips;

  // the role, warp-uniform to the compiler: a branch on threadIdx alone
  // would put the consumer's wgmma on a divergent path, which ptxas
  // serializes
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {
    // ---- producer warp: one column (3 slabs) per ring slot ----
    const int lane = tid - kConsumers;
    if (use_tma && lane != 0) return;
    uint32_t g = 0;   // columns loaded so far
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const Item m = decode(it, h, w, strips);
      for (int j = 0; j < m.npix + 2; ++j, ++g) {
        const int slot = g % kRing;
        const uint32_t full = s_bar + 8 * slot;
        mbar_wait(s_bar + 8 * (kRing + slot), ((g / kRing) & 1) ^ 1);
        if (use_tma) {
          mbar_expect_tx(full, kColBytes);
#pragma unroll
          for (int r = 0; r < 3; ++r)
            tma_load_4d(s_ring + slot * kColBytes + r * kSlabBytes, &xmap, full,
                        m.bt * kBTile, 0, m.w0 + j, m.hh + r);
          continue;
        }
        // masked path: the same swizzled slabs from plain loads
        for (int r = 0; r < 3; ++r) {
          const __nv_bfloat16* src =
              x + (static_cast<int64_t>(m.hh + r) * (w + 2) + m.w0 + j) * kC * b;
          uint8_t* d = sm + kOffRing + slot * kColBytes + r * kSlabBytes;
          for (int e = lane; e < kC * kBTile; e += 32) {
            const int ci = e >> 6, nn = e & 63, bi = m.bt * kBTile + nn;
            const __nv_bfloat16 v =
                bi < b ? src[static_cast<int64_t>(ci) * b + bi] : __float2bfloat16(0.f);
            *reinterpret_cast<__nv_bfloat16*>(d + ci * 128 + (((nn >> 3) ^ (ci & 7)) << 4) +
                                              (nn & 7) * 2) = v;
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(full);
      }
    }
    return;
  }

  // ---- consumer warpgroups: wg takes the item's pixels i = wg, wg + 2, ...
  // so one's epilogue overlaps the other's wgmma ----
  const int wg = role;
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(sm + kOffStage + wg * kStageBytes);
  uint32_t g = 0;      // ring counter of the current item's first column
  uint32_t seen = 0;   // ring columns this warpgroup has seen land
  float acc[32];
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const Item m = decode(it, h, w, strips);
    int rel = 0;   // the item's columns below rel are released by this wg
    for (int i = wg; i < m.npix; i += 2) {
      issue_pixel(acc, g, i, s_a, s_ring, s_bar, seen);
      wgmma_wait<0>();
      finish_pixel(acc, m, i, rel, wg, g, s_bar, seen, stage, out, w, b);
    }
    if (rel == 0) {   // no pixel of this item: release its columns all the same
      wait_landed(s_bar, seen, g + m.npix + 2);
      if ((threadIdx.x & 127) == 0) release(s_bar, g, 0, m.npix + 2);
    }
    g += m.npix + 2;
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// the driver's cuTensorMapEncodeTiled, fetched through the runtime (the
// library links no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

extern "C" {

// xpad (H+2, W+2, 64, B) bf16, wrow (3, 128, 256) bf16 -> out (H, W, 64, B) bf16
int optex_conv64(const void* xpad, const void* wrow, void* out, int h, int w,
                 int b, void* stream) {
  if (h <= 0 || w <= 0 || b <= 0 || h > INT_MAX - 2 || w > INT_MAX - 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv64_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  std::memset(&map, 0, sizeof map);
  const int use_tma = b % 8 == 0;
  if (use_tma) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return static_cast<int>(cudaErrorSymbolNotFound);
    const cuuint64_t ub = static_cast<cuuint64_t>(b);
    const cuuint64_t dims[4] = {ub, kC, static_cast<cuuint64_t>(w) + 2,
                                static_cast<cuuint64_t>(h) + 2};
    const cuuint64_t strides[3] = {2 * ub, 2 * kC * ub,
                                   2 * kC * ub * (static_cast<cuuint64_t>(w) + 2)};
    const cuuint32_t box[4] = {kBTile, kC, 1, 1};
    const cuuint32_t estride[4] = {1, 1, 1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(xpad),
               dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const long long items = static_cast<long long>((b + kBTile - 1) / kBTile) * h *
                          ((w + kStrip - 1) / kStrip);
  const int grid = static_cast<int>(items < sms ? items : sms);
  conv64_wgmma<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const __nv_bfloat16*>(xpad),
      static_cast<const __nv_bfloat16*>(wrow), static_cast<__nv_bfloat16*>(out), h,
      w, b, use_tma);
  return static_cast<int>(cudaGetLastError());
}

const char* optex_conv64_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
