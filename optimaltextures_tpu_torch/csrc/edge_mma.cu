// The codec's two narrow convs in bf16 for Hopper (sm_90a), on the tensor
// cores: the bf16 function of two Pallas kernels,
//
//   rgb_to_relu1_mma  optimaltextures_tpu/ops/pallas/codec.py:578
//                     rgb_to_relu1 (body _entry_kernel :551)
//   final_to_rgb_mma  :515 final_to_rgb (body _final_kernel :491; the next
//                     stage's 1x1 RGB renorm folded into its weights at
//                     pack time, ops/codec.py pack_final)
//
//   rgb_to_relu1: y[n, h, w, co] = relu(b[co] + sum_{r, s, ci}
//                     bf16(xpad[n, h + r, w + s, ci]) * W[r, s, ci, co])   3 -> 64
//   final_to_rgb: y[n, h, w, co] = b[co] + sum_{r, s, ci}
//                     xpad[n, h + r, w + s, ci] * W[r, s, ci, co]          64 -> 3
//
// on NHWC tensors with 1-px reflect padding (or, in the wrap instantiation
// of each, WRAP, 1-px circular padding: the tileable runs' halo; the
// reflect instantiations are the code they were), bf16 weights, products
// summed in f32, an f32 bias; rgb_to_relu1 reads f32 RGB, rounds it to bf16 (the
// Pallas kernel's p0.astype(dt)) and rounds each output to bf16 once;
// final_to_rgb reads bf16 features and writes f32 RGB. As the Pallas
// kernels do on the MXU, the products run on the tensor cores: bf16
// mma.sync.m16n8k16 with f32 accumulate.
//
// What bounds them on the H100: bytes. At 512^2 and batch 128 each moves
// 128 bytes a pixel on its 64-channel side and 12 on the RGB side, 4.70 GB
// a call, 1.40 ms at 3.35 TB/s. Their 1,728 multiply-adds a pixel would
// take 1.73 ms on the FP32 cores, a floor above the bytes; on the tensor
// cores, padded, they take under 0.2 ms. Both kernels are persistent (one
// block per SM walks 16 x 16-pixel tiles, edge_grid), move their 64-channel
// side by TMA in the 128-byte-swizzled layout (a pixel's 64 channels are
// one 128-byte line, its 16-byte chunk j stored at chunk j ^ (pixel & 7),
// sw128), and keep their B operand, the weights in fragment order
// (ops/codec.py pack_edge: a lane's 32 registers are eight 16-byte loads),
// in registers for the block's life. In m16n8k16 lane (g, t) = (lane >> 2,
// lane & 3) holds A rows g and g + 8 at k in {2t, 2t + 1, 2t + 8, 2t + 9},
// B column g at the same k, and C rows g and g + 8 at columns 2t, 2t + 1.
//
// rgb_to_relu1_mma (3 -> 64): an implicit GEMM per tile, M = the tile's 256
// pixels (one m16 tile a tile row, two a warp over 8 warps), N = 64 (8 n8
// tiles), K = 27 taps x channels, k = 3 (3 kh + kw) + ci (pack's HWIO
// order), padded to 32 (two k16 steps).
// * Input: the 18 x 18 x 3 halo with the reflect resolved while loading,
//   plain loads one tile ahead (its 12-byte pixel stride is no TMA stride
//   for every width), rounded to bf16 as it is staged in shared memory as
//   [ci][row][col], double-buffered.
// * A: each lane gathers its fragments from the staged halo. It resolves
//   the halo offsets of its 8 k values once a block (ci * 324 + kh * 18 +
//   kw); a tile row adds its pixel offset. Values at k >= 27 are the
//   constant 0, never read: shared memory past the halo could hold a NaN,
//   and NaN x 0 is NaN.
// * Epilogue on the C fragment: the f32 bias, ReLU, one rounding to bf16,
//   a 4-byte channel pair into the output tile staged in the swizzled
//   layout (conflict-free: the 8 rows of a store are 8 chunk positions).
// * Output: thread 0 stores each staged tile with one TMA box (TMA clips
//   the ragged edge); the staging holds kEntStages tiles, and a buffer is
//   rewritten only after cp.async.bulk.wait_group.read says its store has
//   read it.
//
// final_to_rgb_mma (64 -> 3): input-stationary. An implicit GEMM over the
// output pixels would read each halo pixel's 128-byte line from shared
// memory once a tap, 9 x 128 bytes an output pixel. Instead each halo
// pixel is multiplied once by all 27 (tap, co) columns, and the taps are
// summed after:
// * Input: a 3-slot ring of 18 x 18-pixel halo boxes (41,472 bytes) filled
//   by TMA. A producer warp (warp 8) starts each load on the slot's "full"
//   mbarrier once the 8 consumer warps have released the slot on its
//   "empty" one; consumers sync among themselves only (named barrier 1).
//   TMA fills coordinates outside the image with zeros; the 1-px reflect
//   halo is repaired in shared memory after the box lands (columns, then
//   whole rows, so corners follow), as the TPU kernel's DMA-then-repair.
//   Under wrap the missing halo lies in no edge tile's box: an edge tile's
//   repair reads it from the far edge of the image with plain 16-byte
//   loads (wrap_fetch, issued before the box lands, and wrap_store), interior
//   tiles keep the TMA box as it landed.
// * Product: Z[p][j] = sum_ci x[p][ci] W[ci][j] for the tile's 324 halo
//   pixels p, j = 3 (3 kh + kw) + co: M = 324 (21 m16 tiles of 16
//   consecutive halo pixels, warp w taking tiles w, w + 8, w + 16), K = 64
//   (4 k16 steps), N = 27 padded to 32 (4 n8 tiles). A comes by ldmatrix.x4
//   straight from the ring slot: the 8 row addresses of one matrix are 8
//   consecutive pixels' chunks, 8 distinct chunk positions, so a halo line
//   is read from shared memory once a tile. The last tile's 12 padding rows
//   read pixel 323 (never the next slot, which TMA may be filling) and are
//   never stored.
// * Z goes to shared memory in f32 as [j][p] (27 x 324 words, double-
//   buffered, so a tile needs one barrier): a C-fragment store writes
//   rows g and columns 2t, words 4 (2t) + g apart mod 32, conflict-free.
// * Shift-sum, after the consumer barrier: one thread per output pixel,
//   y[co] = b[co] + Z[co][q0] + Z[3 + co][q1] + ... + Z[24 + co][q8], the
//   taps in order (so repeated launches agree bit for bit), q_tap the halo
//   pixel (y + kh) * 18 + x + kw. Warp w takes tile rows w and w + 8,
//   whose halo rows lie 144 = 16 mod 32 words apart: the 32 reads of an
//   instruction hit 32 banks. A tile row's 3 outputs a pixel are 192
//   contiguous bytes.
//
// At batch 128 and 512^2 a relu1 tensor holds 2^31 elements: every offset
// is 64-bit (size_t), TMA takes per-dimension coordinates.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for sizes it does
// not take, cudaErrorMisalignedAddress for a TMA operand whose base is not
// 16-byte aligned).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kConsumers = 256;                       // 8 computing warps
constexpr int kTile = 16;                             // output pixels a tile side
constexpr int kHalo = kTile + 2;                      // 18
constexpr int kTilePx = kTile * kTile;                // 256
constexpr int kHaloPx = kHalo * kHalo;                // 324
constexpr int kLine = 128;                            // bytes of a pixel's 64 bf16 channels

constexpr int kFinStages = 3;
constexpr int kFinThreads = kConsumers + 32;          // + the producer warp
constexpr int kFinBox = kHaloPx * kLine;              // 41,472 bytes landed a slot
constexpr int kFinSlot = 41 * 1024;                   // 1024-aligned slot
constexpr int kFinMTiles = (kHaloPx + 15) / 16;       // 21
constexpr int kZCols = 27;                            // (tap, co) columns of Z
constexpr int kZBuf = kZCols * kHaloPx * 4;           // [j][p] f32
constexpr int kFinOffZ = kFinStages * kFinSlot;
constexpr int kFinOffBar = kFinOffZ + 2 * kZBuf;      // full, then empty barriers
constexpr int kFinSmem = kFinOffBar + 16 * kFinStages + 1024;   // + alignment slack

constexpr int kEntStages = 2;                         // staged output tiles
constexpr int kEntBlocks = 1;                         // blocks an SM
constexpr int kEntOut = kTilePx * kLine;              // a staged output tile
constexpr int kEntIn = 3 * kHaloPx;                   // 972 bf16 [ci][row][col]
constexpr int kEntLoads = (kEntIn + kConsumers - 1) / kConsumers;
constexpr int kEntOffIn = kEntStages * kEntOut;       // after the staged tiles
constexpr int kEntSmem = kEntOffIn + 2 * kEntIn * 2 + 1024;

static_assert(kFinBox <= kFinSlot && kFinSlot % 1024 == 0, "ring slots");
static_assert(kFinSmem <= 232448 && kEntSmem <= 232448, "shared memory");

// 1-px reflection into [0, n) for i in [-1, n]; n >= 2
__device__ __forceinline__ int reflect1(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * n - 2 - i : i;
}

// 1-px circular wrap into [0, n) for i in [-1, n]; n >= 1 (no % or /)
__device__ __forceinline__ int wrap1(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// the halo index of pad mode WRAP
template <bool WRAP>
__device__ __forceinline__ int pad1(int i, int n) {
  if constexpr (WRAP)
    return wrap1(i, n);
  else
    return reflect1(i, n);
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-aligned byte of dynamic shared memory (the swizzle's period)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (saddr(p) & 1023u)) & 1023u);
}

// byte offset of 16-byte chunk j of line (pixel) p in a 128-byte-swizzled
// region that starts 1024-aligned
__device__ __forceinline__ int sw128(int p, int j) { return p * kLine + ((j ^ (p & 7)) << 4); }

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// one arrival on the barrier (an "empty" barrier counts 8: one per consumer warp)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// order this thread's generic-proxy shared-memory accesses before later
// async-proxy (TMA) ones
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 256 consumer threads only (the producer warp never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
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

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk store groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col): bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the four 8 x 8 bf16 matrices whose rows this warp's lanes address (lanes
// 8q .. 8q + 7 matrix q), as A fragments: a[q] holds row lane / 4, columns
// 2 (lane % 4) and + 1 of matrix q
__device__ __forceinline__ void ldsm_x4(uint32_t* a, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// a lane's B fragments, KS k16 steps x NT n8 tiles x 2 registers (ops/codec.py
// pack_edge: (KS, NT / 2, 32 lanes, 16 bytes), two n8 tiles a load)
template <int KS, int NT>
__device__ __forceinline__ void load_b(const uint4* __restrict__ wedge, int lane,
                                       uint32_t (&b)[KS][NT][2]) {
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      const uint4 v = __ldg(wedge + (s * (NT / 2) + jp) * 32 + lane);
      b[s][2 * jp][0] = v.x;
      b[s][2 * jp][1] = v.y;
      b[s][2 * jp + 1][0] = v.z;
      b[s][2 * jp + 1][1] = v.w;
    }
}

// tile t of an (n, H, W) image stack in 16 x 16 tiles: image, first row, first column
struct EdgeTile {
  int n, y0, x0;
};

__device__ __forceinline__ EdgeTile edge_tile(int t, int tiles_x, int tiles_y) {
  EdgeTile e;
  e.x0 = (t % tiles_x) * kTile;
  const int rest = t / tiles_x;
  e.y0 = (rest % tiles_y) * kTile;
  e.n = rest / tiles_y;
  return e;
}

// copy 16-byte chunk j of halo pixel src to halo pixel dst
__device__ __forceinline__ void copy_line_chunk(uint8_t* slot, int dst, int src, int j) {
  *reinterpret_cast<uint4*>(slot + sw128(dst, j)) =
      *reinterpret_cast<const uint4*>(slot + sw128(src, j));
}

// The wrap repair of an edge tile's box (18 x 18 halo pixels, a 128-byte
// line each at sw128): the halo pixels TMA fills with zeros, because they
// lie past the image, read with plain 16-byte loads at the wrapped
// coordinates. Halo columns 0 (image column -1) and cmax (image column W;
// the box's last on a ragged tile is past it and feeds no stored output)
// come for every row up to rmax with the rows wrapped, so the corners come
// out right; then halo rows 0 and rmax for the columns those left: 576
// (line, 16-byte chunk) items over the 256 consumers, each pixel written
// once. A thread loads its (at most 3) items into registers before the box
// lands, so that the loads overlap the TMA (wrap_fetch), and writes them
// into the landed box (wrap_store); the caller's conditions are
// block-uniform, and it syncs the consumers after the stores.
constexpr int kRepairItems = 4 * kHalo * 8;
constexpr int kRepairPer = (kRepairItems + kConsumers - 1) / kConsumers;

// item i of thread tid's share: whether the tile has it, and its halo
// pixel (r, c) and 16-byte chunk j
__device__ __forceinline__ bool repair_item(int i, int tid, const EdgeTile& e, int H, int W,
                                            int& r, int& c, int& j) {
  const bool left = e.x0 == 0, right = e.x0 + kTile >= W;
  const bool top = e.y0 == 0, bottom = e.y0 + kTile >= H;
  const int cmax = min(kHalo - 1, W - e.x0 + 1);
  const int rmax = min(kHalo - 1, H - e.y0 + 1);
  const int k = tid + i * kConsumers, l = k >> 3;
  j = k & 7;
  if (l < 2 * kHalo) {                                  // a halo column
    const bool far = l >= kHalo;
    r = far ? l - kHalo : l;
    c = far ? cmax : 0;
    return k < kRepairItems && (far ? right : left) && r <= rmax;
  }
  const bool far = l >= 3 * kHalo;                       // a halo row
  c = far ? l - 3 * kHalo : l - 2 * kHalo;
  r = far ? rmax : 0;
  return k < kRepairItems && (far ? bottom : top) && c <= cmax && !(left && c == 0) &&
         !(right && c == cmax);
}

// base: image pixel 0's line (the box's channels); stride: uint4 a pixel
__device__ __forceinline__ void wrap_fetch(uint4 (&v)[kRepairPer],
                                           const uint4* __restrict__ base, int stride,
                                           int tid, const EdgeTile& e, int H, int W) {
#pragma unroll
  for (int i = 0; i < kRepairPer; ++i) {
    int r, c, j;
    if (repair_item(i, tid, e, H, W, r, c, j)) {
      const size_t px = (static_cast<size_t>(e.n) * H + wrap1(e.y0 - 1 + r, H)) * W +
                        wrap1(e.x0 - 1 + c, W);
      v[i] = __ldg(base + px * stride + j);
    }
  }
}

__device__ __forceinline__ void wrap_store(const uint4 (&v)[kRepairPer], uint8_t* slot,
                                           int tid, const EdgeTile& e, int H, int W) {
#pragma unroll
  for (int i = 0; i < kRepairPer; ++i) {
    int r, c, j;
    if (repair_item(i, tid, e, H, W, r, c, j))
      *reinterpret_cast<uint4*>(slot + sw128(r * kHalo + c, j)) = v[i];
  }
}

template <bool WRAP>
__global__ void __launch_bounds__(kFinThreads, 1)
final_to_rgb_mma(const __grid_constant__ CUtensorMap xmap,
                 const __nv_bfloat16* __restrict__ x, const uint4* __restrict__ wedge,
                 const float* __restrict__ bias, float* __restrict__ y, int n, int H,
                 int W) {
  // xmap: x (N, H, W, 64) bf16, boxes of {64 channels, 18 columns, 18 rows,
  // 1}, one a tile, tile i of this block in ring slot i % 3 (x itself: the
  // wrap repair's plain loads); wedge: B[ci][3 tap + co] (64 x 32) in
  // fragment order; y: (N, H, W, 3) float32
  extern __shared__ uint8_t fin_smem[];
  uint8_t* sm = align1024(fin_smem);
  const uint32_t s_ring = saddr(sm), s_full = saddr(sm + kFinOffBar);
  const uint32_t s_empty = s_full + 8 * kFinStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles_y = (H + kTile - 1) / kTile;
  const int tiles = n * tiles_x * tiles_y;
  const int mine = (tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;

  if (tid == 0) {
    for (int s = 0; s < kFinStages; ++s) {
      mbar_init(s_full + 8 * s, 1);
      mbar_init(s_empty + 8 * s, 8);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (__shfl_sync(0xffffffffu, warp, 0) == 8) {
    // producer warp: tile i into its slot once the consumers freed it (the
    // role test is warp-uniform)
    if (lane == 0) {
      for (int i = 0; i < mine; ++i) {
        const int slot = i % kFinStages;
        if (i >= kFinStages) mbar_wait(s_empty + 8 * slot, ((i / kFinStages) - 1) & 1);
        const EdgeTile e = edge_tile(blockIdx.x + i * gridDim.x, tiles_x, tiles_y);
        mbar_expect_tx(s_full + 8 * slot, kFinBox);
        tma_load_4d(s_ring + slot * kFinSlot, &xmap, s_full + 8 * slot, 0, e.x0 - 1,
                    e.y0 - 1, e.n);
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  uint32_t b[4][4][2];
  load_b<4, 4>(wedge, lane, b);
  const float bias0 = __ldg(bias), bias1 = __ldg(bias + 1), bias2 = __ldg(bias + 2);
  // ldmatrix: lane L addresses row (L & 7) + 8 ((L >> 3) & 1) of an m16
  // tile, 16-byte chunk 2 s + (L >> 4) of k step s
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lchunk = lane >> 4;
  // the shift-sum's output pixel: warp w takes tile rows w and w + 8
  const int oy = warp + 8 * (lane >> 4), ox = lane & 15;

  for (int i = 0; i < mine; ++i) {
    const int slot = i % kFinStages;
    const EdgeTile e = edge_tile(blockIdx.x + i * gridDim.x, tiles_x, tiles_y);
    uint8_t* st = sm + slot * kFinSlot;
    // WRAP: an edge tile's far-edge pixels (a pixel's 64 channels, 8 uint4),
    // loaded while the box is in flight
    uint4 rep[kRepairPer];
    bool edge = false;
    if constexpr (WRAP) {
      edge = e.x0 == 0 || e.x0 + kTile >= W || e.y0 == 0 || e.y0 + kTile >= H;
      if (edge) wrap_fetch(rep, reinterpret_cast<const uint4*>(x), 8, tid, e, H, W);
    }
    mbar_wait(s_full + 8 * slot, (i / kFinStages) & 1);
    // reflect repair: halo column 0 (image column -1) takes halo column 2,
    // the halo column of image column W takes that of W - 2; then whole
    // rows the same way (WRAP: the far edge's pixels, wrap_store).
    // Block-uniform conditions, so every consumer warp meets the same
    // sequence of named barriers.
    const bool left = e.x0 == 0, right = e.x0 + kTile >= W;
    const bool top = e.y0 == 0, bottom = e.y0 + kTile >= H;
    if constexpr (WRAP) {
      if (edge) {
        wrap_store(rep, st, tid, e, H, W);
        consumer_sync();
      }
    } else {
      if (left || right) {
        for (int k = tid; k < 2 * kHalo * 8; k += kConsumers) {
          const int side = k >= kHalo * 8, r = (k >> 3) - side * kHalo;
          if (side ? right : left) {
            const int dst = side ? W - e.x0 + 1 : 0, src = side ? W - e.x0 - 1 : 2;
            copy_line_chunk(st, r * kHalo + dst, r * kHalo + src, k & 7);
          }
        }
        consumer_sync();
      }
      if (top || bottom) {
        for (int k = tid; k < 2 * kHalo * 8; k += kConsumers) {
          const int side = k >= kHalo * 8, c = (k >> 3) - side * kHalo;
          if (side ? bottom : top) {
            const int dst = side ? H - e.y0 + 1 : 0, src = side ? H - e.y0 - 1 : 2;
            copy_line_chunk(st, dst * kHalo + c, src * kHalo + c, k & 7);
          }
        }
        consumer_sync();
      }
    }

    // the product: Z[j][p] for this warp's m16 tiles of halo pixels. Z
    // alternates by tile: a warp rewrites it two tiles on, past the next
    // tile's barrier, which every reader of this one has reached
    float* z = reinterpret_cast<float*>(sm + kFinOffZ + (i & 1) * kZBuf);
    const uint32_t s_slot = saddr(st);
    for (int mt = warp; mt < kFinMTiles; mt += 8) {
      const int px = min(16 * mt + lrow, kHaloPx - 1);   // padding rows: pixel 323
      float c[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) c[j][q] = 0.f;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t a[4];
        ldsm_x4(a, s_slot + sw128(px, 2 * s + lchunk));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(c[j], a, b[s][j][0], b[s][j][1]);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int p = 16 * mt + g + 8 * rr;
        if (p >= kHaloPx) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = 8 * j + 2 * t + q;
            if (col < kZCols) z[col * kHaloPx + p] = c[j][2 * rr + q];
          }
      }
    }
    // this warp is done with the slot (its repair writes included)
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(s_empty + 8 * slot);
    consumer_sync();

    // the shift-sum: bias, then the 9 taps in order
    const int Y = e.y0 + oy, X = e.x0 + ox;
    if (Y < H && X < W) {
      float s0 = bias0, s1 = bias1, s2 = bias2;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float* zt = z + 3 * tap * kHaloPx + (oy + tap / 3) * kHalo + ox + tap % 3;
        s0 += zt[0];
        s1 += zt[kHaloPx];
        s2 += zt[2 * kHaloPx];
      }
      float* yp = y + ((static_cast<size_t>(e.n) * H + Y) * W + X) * 3;
      yp[0] = s0;
      yp[1] = s1;
      yp[2] = s2;
    }
  }
}

template <bool WRAP>
__global__ void __launch_bounds__(kConsumers, kEntBlocks)
rgb_to_relu1_mma(const __grid_constant__ CUtensorMap ymap, const float* __restrict__ x,
                 const uint4* __restrict__ wedge, const float* __restrict__ bias, int n,
                 int H, int W) {
  // x: (N, H, W, 3) float32 (rounded to bf16 before it multiplies); wedge:
  // B[3 tap + ci][co] (32 x 64, rows 27-31 zero) in fragment order; ymap: y
  // (N, H, W, 64) bf16, boxes of {64 channels, 16 columns, 16 rows, 1}, one
  // a tile
  extern __shared__ uint8_t ent_smem[];
  uint8_t* sm = align1024(ent_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles_y = (H + kTile - 1) / kTile;
  const int tiles = n * tiles_x * tiles_y;
  const int mine = (tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;

  uint32_t b[2][8][2];
  load_b<2, 8>(wedge, lane, b);
  float bs[8][2];   // the bias of this lane's output channels 8 j + 2 t, + 1
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bs[j][0] = __ldg(bias + 8 * j + 2 * t);
    bs[j][1] = __ldg(bias + 8 * j + 2 * t + 1);
  }
  // the halo offsets of this lane's k values, k = 16 s + 8 h + 2 t + e (tap
  // k / 3, channel k % 3): ci * 324 + kh * 18 + kw; -1 past k = 26
  int koff[2][2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 16 * s + 8 * h + 2 * t + e, tap = k / 3;
        koff[s][h][e] = k < 27 ? (k % 3) * kHaloPx + (tap / 3) * kHalo + tap % 3 : -1;
      }

  // the halo of tile k into registers: element el = ci * 324 + row * 18 + col
  float pre[kEntLoads];
  auto fetch = [&](int k) {
    const EdgeTile e = edge_tile(blockIdx.x + k * gridDim.x, tiles_x, tiles_y);
    const float* xn = x + static_cast<size_t>(e.n) * H * W * 3;
#pragma unroll
    for (int l = 0; l < kEntLoads; ++l) {
      const int el = tid + l * kConsumers;
      if (el < kEntIn) {
        const int ci = el / kHaloPx, p = el % kHaloPx;
        // rows/cols past the image (a ragged last tile) feed no stored
        // output: clamp them to stay in bounds
        const int gy = pad1<WRAP>(min(e.y0 + p / kHalo - 1, H), H);
        const int gx = pad1<WRAP>(min(e.x0 + p % kHalo - 1, W), W);
        pre[l] = __ldg(xn + (static_cast<size_t>(gy) * W + gx) * 3 + ci);
      }
    }
  };
  fetch(0);

  for (int k = 0; k < mine; ++k) {
    const int buf = k & 1;
    const EdgeTile e = edge_tile(blockIdx.x + k * gridDim.x, tiles_x, tiles_y);
    uint16_t* in = reinterpret_cast<uint16_t*>(sm + kEntOffIn) + buf * kEntIn;
#pragma unroll
    for (int l = 0; l < kEntLoads; ++l)
      if (tid + l * kConsumers < kEntIn)
        in[tid + l * kConsumers] = __bfloat16_as_ushort(__float2bfloat16_rn(pre[l]));
    // the staging of tile k last held tile k - kEntStages: its store must
    // have read it
    if (tid == 0) bulk_wait_read<kEntStages - 1>();
    __syncthreads();
    if (k + 1 < mine) fetch(k + 1);

    uint8_t* st = sm + (k % kEntStages) * kEntOut;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = 2 * warp + mt;   // the tile row of this m16 tile
      // A: a[s][2 h + rr] holds rows g + 8 rr at k = 16 s + 8 h + 2 t, + 1
      uint32_t a[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int base = r * kHalo + g + 8 * rr;
            const uint32_t lo = koff[s][h][0] >= 0 ? in[koff[s][h][0] + base] : 0u;
            const uint32_t hi = koff[s][h][1] >= 0 ? in[koff[s][h][1] + base] : 0u;
            a[s][2 * h + rr] = lo | (hi << 16);
          }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(c, a[0], b[0][j][0], b[0][j][1]);
        mma_bf16(c, a[1], b[1][j][0], b[1][j][1]);
        // rows g, g + 8 are pixels 16 r + g, + 8; channels 8 j + 2 t, + 1
        // are 4 bytes at 4 t of the pixel's chunk j
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(fmaxf(c[2 * rr] + bs[j][0], 0.f),
                                    fmaxf(c[2 * rr + 1] + bs[j][1], 0.f));
          *reinterpret_cast<__nv_bfloat162*>(st + sw128(16 * r + g + 8 * rr, j) + 4 * t) = v;
        }
      }
    }
    // the staged tile is complete: thread 0 stores it by TMA
    fence_async_smem();
    __syncthreads();
    if (tid == 0) {
      tma_store_4d(&ymap, saddr(st), 0, e.x0, e.y0, e.n);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all();   // the staging outlives every store's read
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (the
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

// the TMA map of an (n, h, w, 64) bf16 tensor, boxes {64 channels, box_w,
// box_h, 1}, 128-byte swizzled; 0 or a cudaError_t code
int map_nhwc64(CUtensorMap* map, const __nv_bfloat16* base, int n, int h, int w,
               int box_w, int box_h) {
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorSymbolNotFound);
  std::memset(map, 0, sizeof *map);
  const cuuint64_t px = kLine;
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {px, px * w, px * w * h};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<__nv_bfloat16*>(base),
             dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// a persistent grid: per_sm blocks per SM, or one per tile when there are fewer
int edge_grid(int n, int h, int w, int per_sm, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(n) * ((h + kTile - 1) / kTile) *
                          ((w + kTile - 1) / kTile);
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  *grid = static_cast<int>(tiles < per_sm * sms ? tiles : per_sm * sms);
  return 0;
}

template <bool WRAP>
int launch_entry(const float* x, const void* wedge, const float* b, __nv_bfloat16* y,
                 int n, int h, int wd, void* stream) {
  CUtensorMap ymap;
  int grid = 0;
  if (int rc = map_nhwc64(&ymap, y, n, h, wd, kTile, kTile)) return rc;
  if (int rc = edge_grid(n, h, wd, kEntBlocks, &grid)) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      rgb_to_relu1_mma<WRAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kEntSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rgb_to_relu1_mma<WRAP><<<grid, kConsumers, kEntSmem, static_cast<cudaStream_t>(stream)>>>(
      ymap, x, static_cast<const uint4*>(wedge), b, n, h, wd);
  return static_cast<int>(cudaGetLastError());
}

template <bool WRAP>
int launch_final(const __nv_bfloat16* x, const void* wedge, const float* b, float* y,
                 int n, int h, int wd, void* stream) {
  CUtensorMap xmap;
  int grid = 0;
  if (int rc = map_nhwc64(&xmap, x, n, h, wd, kHalo, kHalo)) return rc;
  if (int rc = edge_grid(n, h, wd, 1, &grid)) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      final_to_rgb_mma<WRAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kFinSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  final_to_rgb_mma<WRAP><<<grid, kFinThreads, kFinSmem, static_cast<cudaStream_t>(stream)>>>(
      xmap, x, static_cast<const uint4*>(wedge), b, y, n, h, wd);
  return static_cast<int>(cudaGetLastError());
}

// the sizes a launch takes: the reflection needs 2 pixels a side, the wrap 1
bool bad_size(int n, int h, int wd, int wrap) {
  const int least = wrap ? 1 : 2;
  return n <= 0 || n > 65535 || h < least || wd < least;
}

}  // namespace

extern "C" {

// Every entry point: wrap 0 pads by reflection, 1 circularly.

// (N, H, W, 3) f32 -> relu(conv) (N, H, W, 64) bf16; wedge: ops/codec.py
// pack_edge of the (27 -> 32) x 64 weights; b: (64,) f32; y 16-byte aligned
// (TMA stores)
int optex_rgb_to_relu1_bf16(const float* x, const void* wedge, const float* b,
                            __nv_bfloat16* y, int n, int h, int wd, int wrap,
                            void* stream) {
  if (bad_size(n, h, wd, wrap)) return static_cast<int>(cudaErrorInvalidValue);
  return wrap ? launch_entry<true>(x, wedge, b, y, n, h, wd, stream)
              : launch_entry<false>(x, wedge, b, y, n, h, wd, stream);
}

// (N, H, W, 64) bf16 -> conv (N, H, W, 3) f32, no ReLU (the renorm is folded
// into the weights); wedge: pack_edge of the 64 x (27 -> 32) weights; b:
// (3,) f32; x 16-byte aligned (TMA loads)
int optex_final_to_rgb_bf16(const __nv_bfloat16* x, const void* wedge, const float* b,
                            float* y, int n, int h, int wd, int wrap, void* stream) {
  if (bad_size(n, h, wd, wrap)) return static_cast<int>(cudaErrorInvalidValue);
  return wrap ? launch_final<true>(x, wedge, b, y, n, h, wd, stream)
              : launch_final<false>(x, wedge, b, y, n, h, wd, stream);
}

const char* optex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
