// Codec convolution kernels for Hopper (sm_90a): the port of the five Pallas
// kernels in optimaltextures_tpu/ops/pallas/codec.py, in float32.
//
// All five compute one operation: a 3x3 convolution with 1-px reflect
// padding and a bias, on NHWC tensors, with an optional nearest-x2
// upsample in front, and an optional ReLU and 2x2 max-pool (taken after the
// ReLU, ceil mode) behind. Each kernel also has a wrap mode, a bool WRAP
// template parameter (the reflect instantiations are the code they were):
// 1-px circular padding, the tileable runs' halo, which no Pallas kernel
// computes (the JAX package leaves tileable runs to XLA's convs). Where a
// kernel resolves its halo by index, the wrap is another index function;
// final_to_rgb_tma, whose box TMA fills with zeros past the image, reads
// the far edge of the image for its edge tiles with plain loads. Each also has the bf16 function the Pallas
// kernels compute on the TPU (bf16 activations and weights, f32
// accumulate, f32 bias, one rounding to bf16 at the store; rgb_to_relu1
// rounds its f32 RGB input to bf16 first, final_to_rgb writes f32 RGB),
// which runs on the tensor cores in csrc/conv_wg.cu (the three wide convs,
// wgmma) and csrc/edge_mma.cu (the two narrow ones, mma.sync). What bounds
// each f32 kernel on the H100 sets its design:
//
//   rgb_to_relu1  rgb_to_relu1_tma<WRAP>                              bytes
//   final_to_rgb  final_to_rgb_tma<WRAP>                              bytes
//   conv3x3_p2    conv3x3_tf32x3<64|128, 64, RELU, POOL, WRAP>        operations
//   conv3x3_full  conv3x3_tf32x3<64|128, 128, RELU, POOL, WRAP>       operations
//   upconv_p2     upconv_tf32x3<64|128, WRAP>                         operations
//
// The narrow entry and final convs do 54 / 1152 FLOPs per 4+256 / 256+12
// bytes of pixel traffic, below the card's ridge: FFMA direct convolutions
// that read their input once and write their output once, with the 64-channel
// side moved by TMA so the bytes stay in flight while the FMAs run. The
// wide convs do 2 x 9 x Cin multiply-adds per output value (upconv, folded:
// 2 x 4 x Cin) against 8 bytes of traffic, far above it: implicit GEMMs on
// the tensor cores, three TF32 products per f32 product.
//
// Every entry point takes the pad mode last before the stream (wrap: 0
// reflect, 1 circular), launches on the caller's stream, allocates nothing
// and returns cudaGetLastError() (or cudaErrorInvalidValue for a configuration
// it was not built for, cudaErrorMisalignedAddress for a TMA operand whose
// base is not 16-byte aligned).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;

// 1-px reflection into [0, n) for i in [-1, n]; n >= 2.
__device__ __forceinline__ int reflect1(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * n - 2 - i : i;
}

// 1-px circular wrap into [0, n) for i in [-1, n]; n >= 1. No % or /: a
// signed % on an index made ptxas spill in the register-bound kernels.
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

// ---------------------------------------------------------------------------
// rgb_to_relu1 and final_to_rgb: FFMA direct convolutions around TMA.
//
// Replace ops/pallas/codec.py:578 rgb_to_relu1 (body _entry_kernel :551)
// and :515 final_to_rgb (_final_kernel :491; the next stage's 1x1 RGB
// renorm is folded into its weights at pack time). Both move 256 bytes a
// pixel on their 64-channel side and 12 on the other, and do 1728 FMAs a
// pixel: at 512^2 the bytes take 0.021 ms at 3.35 TB/s and the FMAs 0.0135
// ms at 67 TF/s. So what bounds them is bytes, with the FMAs close behind:
// the 64-channel traffic must stay in flight while the FMAs run, and the
// FMAs must not wait on shared-memory reads.
//
// Both are persistent (one block per SM walks 16 x 16-pixel tiles with 8
// computing warps, so even the 256^2 pass fills every SM) and keep the 64-channel
// side in shared memory in the 128-byte-swizzled TMA layout: a pixel's 32
// channels are one 128-byte line, its 16-byte chunk j stored at chunk
// j ^ (pixel & 7) (sw128). A quarter-warp that reads or writes one chunk of
// 8 consecutive pixels then hits 32 distinct banks.
//
// final_to_rgb_tma (64 -> 3):
// * Input: a 3-slot ring of half tiles (32 channels of the 18 x 18 halo,
//   41,472 bytes) filled by TMA. A producer warp (warp 8) starts each load
//   on the slot's "full" mbarrier once the 8 consumer warps have released
//   the slot on its "empty" one, so loads stay in flight while the
//   consumers compute and no consumer waits to start one. Consumers sync
//   among themselves only (named barrier 1). TMA fills coordinates outside
//   the image with zeros; the 1-px reflect
//   halo is repaired in shared memory after the box lands (columns, then
//   whole rows, so corners follow), as the TPU kernel's DMA-then-repair.
//   Under wrap the missing halo lies in no edge tile's box: an edge tile's
//   repair reads it from the far edge of the image (wrap_fetch, wrap_store).
// * Compute: warp w takes channels 4w..4w+3 of each half (its 108 weights
//   of the half in registers, read once from shared memory), and every
//   warp the whole tile: lane (cx, rg) owns column cx, rows 8rg..8rg+7,
//   all 3 output channels (24 accumulators). Per halo row it reads three
//   16-byte chunks and does up to 108 FMAs: 30 reads for 864 FMAs a half.
// * Epilogue, once per tile: the 8 warps' partial sums meet in shared
//   memory (24 KB, double-buffered so the next tile needs no barrier), one
//   thread per pixel adds them and the bias and stores its 3 values (a tile
//   row is 192 contiguous bytes).
//
// rgb_to_relu1_tma (3 -> 64):
// * Input: the 18 x 18 x 3 halo with the reflect resolved while loading,
//   plain loads (its 12-byte pixel stride is no TMA stride for every
//   width), fetched into registers one tile ahead and stored to shared
//   memory at the tile's start, double-buffered.
// * Compute: thread (q, s) owns 4 pixels of one column (rows 4(s >> 4)..+3,
//   column s & 15) and channels 16q..16q+15, 4 at a time: its 6 x 3 x 3
//   input window in registers, 16 accumulators, one broadcast float4 of
//   weights per 16 FMAs. Bias and ReLU, then each float4 goes to a staged
//   output tile (64 KB: two 32-channel halves, 128-byte swizzled).
// * Output: thread 0 stores each staged half with one TMA bulk tensor store
//   (TMA clips the ragged edge), and the staging is double-buffered: tile
//   k's stores run while tile k + 1 computes, and a buffer is rewritten
//   only after cp.async.bulk.wait_group.read says its stores have read it.
//
// Every offset into an image stack is 64-bit (size_t); TMA takes
// per-dimension coordinates.

constexpr int kEdgeTile = 16;                              // output pixels a tile side
constexpr int kEdgeHalo = kEdgeTile + 2;                   // 18
constexpr int kEdgePx = kEdgeTile * kEdgeTile;             // 256 = threads
constexpr int kEdgeHaloPx = kEdgeHalo * kEdgeHalo;         // 324

constexpr int kFinStages = 3;
constexpr int kFinThreads = kThreads + 32;                 // + the producer warp
constexpr int kFinBox = kEdgeHaloPx * 128;                 // 41,472 bytes landed a slot
constexpr int kFinSlot = 41 * 1024;                        // 1024-aligned slot
constexpr int kFinOffW = kFinStages * kFinSlot;            // weights [tap][ci][co]
constexpr int kFinOffRed = kFinOffW + 9 * 64 * 3 * 4;      // partial sums, 2 buffers
constexpr int kFinRedBuf = 8 * 3 * kEdgePx * 4;            // [warp][co][px]
constexpr int kFinOffBar = kFinOffRed + 2 * kFinRedBuf;    // full, then empty barriers
constexpr int kFinSmem = kFinOffBar + 16 * kFinStages + 1024;   // + alignment slack

constexpr int kEntHalf = kEdgePx * 128;                    // 32 channels of a tile
constexpr int kEntIn = 3 * kEdgeHaloPx;                    // 972 floats [ci][row][col]
constexpr int kEntLoads = (kEntIn + kThreads - 1) / kThreads;
constexpr int kEntOffIn = 4 * kEntHalf;                    // after two staged tiles
constexpr int kEntOffW = kEntOffIn + 2 * kEntIn * 4;       // weights [tap][ci][co], bias
constexpr int kEntSmem = kEntOffW + (27 + 1) * 64 * 4 + 1024;

static_assert(kEdgePx == kThreads, "one thread per tile pixel in the epilogues");
static_assert(kFinBox <= kFinSlot && kFinSlot % 1024 == 0, "ring slots");

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk j of line (pixel) p in a 128-byte-swizzled
// region that starts 1024-aligned
__device__ __forceinline__ int sw128(int p, int j) {
  return p * 128 + ((j ^ (p & 7)) << 4);
}

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

// order this thread's generic-proxy shared-memory accesses before later
// async-proxy (TMA) ones
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// tile t of an (n, H, W) image stack in 16 x 16 tiles: image, first row, first column
struct EdgeTile {
  int n, y0, x0;
};

__device__ __forceinline__ EdgeTile edge_tile(int t, int tiles_x, int tiles_y) {
  EdgeTile e;
  e.x0 = (t % tiles_x) * kEdgeTile;
  const int rest = t / tiles_x;
  e.y0 = (rest % tiles_y) * kEdgeTile;
  e.n = rest / tiles_y;
  return e;
}

// copy 16-byte chunk j of halo pixel src to halo pixel dst
__device__ __forceinline__ void copy_line_chunk(uint8_t* slot, int dst, int src, int j) {
  *reinterpret_cast<float4*>(slot + sw128(dst, j)) =
      *reinterpret_cast<const float4*>(slot + sw128(src, j));
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
constexpr int kRepairItems = 4 * kEdgeHalo * 8;
constexpr int kRepairPer = (kRepairItems + kThreads - 1) / kThreads;

// item i of thread tid's share: whether the tile has it, and its halo
// pixel (r, c) and 16-byte chunk j
__device__ __forceinline__ bool repair_item(int i, int tid, const EdgeTile& e, int H, int W,
                                            int& r, int& c, int& j) {
  const bool left = e.x0 == 0, right = e.x0 + kEdgeTile >= W;
  const bool top = e.y0 == 0, bottom = e.y0 + kEdgeTile >= H;
  const int cmax = min(kEdgeHalo - 1, W - e.x0 + 1);
  const int rmax = min(kEdgeHalo - 1, H - e.y0 + 1);
  const int k = tid + i * kThreads, l = k >> 3;
  j = k & 7;
  if (l < 2 * kEdgeHalo) {                                  // a halo column
    const bool far = l >= kEdgeHalo;
    r = far ? l - kEdgeHalo : l;
    c = far ? cmax : 0;
    return k < kRepairItems && (far ? right : left) && r <= rmax;
  }
  const bool far = l >= 3 * kEdgeHalo;                       // a halo row
  c = far ? l - 3 * kEdgeHalo : l - 2 * kEdgeHalo;
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
      *reinterpret_cast<uint4*>(slot + sw128(r * kEdgeHalo + c, j)) = v[i];
  }
}

// one arrival on the barrier (an "empty" barrier counts 8: one per consumer warp)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// the 256 consumer threads only (the producer warp never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <bool WRAP>
__global__ void __launch_bounds__(kFinThreads, 1)
final_to_rgb_tma(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ x,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ y, int n, int H, int W) {
  // xmap: x (N, H, W, 64) float32, boxes of {32 channels, 18 columns, 18
  // rows, 1}, half a tile (x itself: the wrap repair's plain loads); w: (3,
  // 3, 64, 3) HWIO float32; y: (N, H, W, 3) float32. Item i: half i & 1 of
  // this block's tile i / 2, in ring slot i % 3.
  constexpr int kItems = 2;                              // items a tile
  extern __shared__ uint8_t fin_smem[];
  uint8_t* sm = fin_smem + ((1024u - (saddr(fin_smem) & 1023u)) & 1023u);
  float* ws = reinterpret_cast<float*>(sm + kFinOffW);
  const uint32_t s_ring = saddr(sm), s_full = saddr(sm + kFinOffBar);
  const uint32_t s_empty = s_full + 8 * kFinStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (W + kEdgeTile - 1) / kEdgeTile;
  const int tiles_y = (H + kEdgeTile - 1) / kEdgeTile;
  const int tiles = n * tiles_x * tiles_y;
  const int mine = (tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;
  const int items = kItems * mine;

  if (tid == 0) {
    for (int s = 0; s < kFinStages; ++s) {
      mbar_init(s_full + 8 * s, 1);
      mbar_init(s_empty + 8 * s, 8);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 9 * 64 * 3; i += kFinThreads) ws[i] = __ldg(w + i);
  __syncthreads();

  if (__shfl_sync(0xffffffffu, warp, 0) == 8) {
    // producer warp: item i into its slot once the consumers freed it (the
    // role test is warp-uniform)
    if (lane == 0) {
      for (int i = 0; i < items; ++i) {
        const int slot = i % kFinStages;
        if (i >= kFinStages) mbar_wait(s_empty + 8 * slot, ((i / kFinStages) - 1) & 1);
        const EdgeTile e = edge_tile(blockIdx.x + (i / kItems) * gridDim.x, tiles_x, tiles_y);
        mbar_expect_tx(s_full + 8 * slot, kFinBox);
        tma_load_4d(s_ring + slot * kFinSlot, &xmap, s_full + 8 * slot, 32 * (i & 1),
                    e.x0 - 1, e.y0 - 1, e.n);
      }
    }
    return;
  }

  const int cx = lane & 15, rg = lane >> 4;
  float acc[8][3];
  for (int i = 0; i < items; ++i) {
    const int slot = i % kFinStages;
    const EdgeTile e = edge_tile(blockIdx.x + (i / kItems) * gridDim.x, tiles_x, tiles_y);
    uint8_t* st = sm + slot * kFinSlot;
    // WRAP: an edge tile's far-edge pixels (this half's 32 channels, 8 of a
    // pixel's 16 uint4), loaded while the box is in flight
    uint4 rep[kRepairPer];
    bool edge = false;
    if constexpr (WRAP) {
      edge = e.x0 == 0 || e.x0 + kEdgeTile >= W || e.y0 == 0 || e.y0 + kEdgeTile >= H;
      if (edge)
        wrap_fetch(rep, reinterpret_cast<const uint4*>(x) + 8 * (i & 1), 16, tid, e, H, W);
    }
    mbar_wait(s_full + 8 * slot, (i / kFinStages) & 1);
    // reflect repair: halo column 0 (image column -1) takes halo column 2,
    // the halo column of image column W takes that of W - 2; then whole
    // rows the same way (WRAP: the far edge's pixels, wrap_store).
    // Block-uniform conditions, so every consumer warp meets the same
    // sequence of named barriers.
    const bool left = e.x0 == 0, right = e.x0 + kEdgeTile >= W;
    const bool top = e.y0 == 0, bottom = e.y0 + kEdgeTile >= H;
    if constexpr (WRAP) {
      if (edge) {
        wrap_store(rep, st, tid, e, H, W);
        consumer_sync();
      }
    } else {
      if (left || right) {
        for (int k = tid; k < 2 * kEdgeHalo * 8; k += kThreads) {
          const int side = k >= kEdgeHalo * 8, r = (k >> 3) - side * kEdgeHalo;
          if (side ? right : left) {
            const int dst = side ? W - e.x0 + 1 : 0, src = side ? W - e.x0 - 1 : 2;
            copy_line_chunk(st, r * kEdgeHalo + dst, r * kEdgeHalo + src, k & 7);
          }
        }
        consumer_sync();
      }
      if (top || bottom) {
        for (int k = tid; k < 2 * kEdgeHalo * 8; k += kThreads) {
          const int side = k >= kEdgeHalo * 8, c = (k >> 3) - side * kEdgeHalo;
          if (side ? bottom : top) {
            const int dst = side ? H - e.y0 + 1 : 0, src = side ? H - e.y0 - 1 : 2;
            copy_line_chunk(st, dst * kEdgeHalo + c, src * kEdgeHalo + c, k & 7);
          }
        }
        consumer_sync();
      }
    }
    const int half = i & 1;
    // this warp's 4 input channels of the half: weights [tap][ci][co]
    const int c0 = 32 * half + 4 * warp;
    float wr[9][12];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float4* wp = reinterpret_cast<const float4*>(ws + (tap * 64 + c0) * 3);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 v = wp[k];
        wr[tap][4 * k] = v.x; wr[tap][4 * k + 1] = v.y;
        wr[tap][4 * k + 2] = v.z; wr[tap][4 * k + 3] = v.w;
      }
    }
    if (half == 0) {
#pragma unroll
      for (int oy = 0; oy < 8; ++oy)
#pragma unroll
        for (int co = 0; co < 3; ++co) acc[oy][co] = 0.f;
    }
#pragma unroll
    for (int iy = 0; iy < 10; ++iy) {
      float v[3][4];
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        // 16-byte chunk `warp` of the half's line: channels c0 .. c0 + 3
        const int px = (8 * rg + iy) * kEdgeHalo + cx + kw;
        const float4 q = *reinterpret_cast<const float4*>(st + sw128(px, warp));
        v[kw][0] = q.x; v[kw][1] = q.y; v[kw][2] = q.z; v[kw][3] = q.w;
      }
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const int oy = iy - kh;
        if (oy < 0 || oy >= 8) continue;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int ci = 0; ci < 4; ++ci)
#pragma unroll
            for (int co = 0; co < 3; ++co)
              acc[oy][co] = fmaf(v[kw][ci], wr[3 * kh + kw][3 * ci + co], acc[oy][co]);
      }
    }
    // this warp is done with the slot (its repair writes included)
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(s_empty + 8 * slot);
    if (half == 1) {
      // the 8 warps' partial sums -> one thread per pixel: bias, store. The
      // buffer alternates by tile: a warp rewrites it two tiles on, past the
      // next tile's barrier, which every reader of this one has reached
      float* red = reinterpret_cast<float*>(sm + kFinOffRed + ((i / kItems) & 1) * kFinRedBuf);
#pragma unroll
      for (int oy = 0; oy < 8; ++oy)
#pragma unroll
        for (int co = 0; co < 3; ++co)
          red[(warp * 3 + co) * kEdgePx + (8 * rg + oy) * kEdgeTile + cx] = acc[oy][co];
      consumer_sync();
      const int Y = e.y0 + (tid >> 4), X = e.x0 + (tid & 15);
      if (Y < H && X < W) {
        float s[3];
#pragma unroll
        for (int co = 0; co < 3; ++co) s[co] = __ldg(bias + co);
#pragma unroll
        for (int wp = 0; wp < 8; ++wp)
#pragma unroll
          for (int co = 0; co < 3; ++co) s[co] += red[(wp * 3 + co) * kEdgePx + tid];
        float* yp = y + ((static_cast<size_t>(e.n) * H + Y) * W + X) * 3;
#pragma unroll
        for (int co = 0; co < 3; ++co) yp[co] = s[co];
      }
    }
  }
}

template <bool WRAP>
__global__ void __launch_bounds__(kThreads, 1)
rgb_to_relu1_tma(const __grid_constant__ CUtensorMap ymap, const float* __restrict__ x,
                 const float* __restrict__ w, const float* __restrict__ bias, int n,
                 int H, int W) {
  // x: (N, H, W, 3) float32; w: (3, 3, 3, 64) HWIO float32; ymap: y (N, H,
  // W, 64) float32, boxes of {32 channels, 16 columns, 16 rows, 1}: two a
  // tile
  extern __shared__ uint8_t ent_smem[];
  uint8_t* sm = ent_smem + ((1024u - (saddr(ent_smem) & 1023u)) & 1023u);
  float* ws = reinterpret_cast<float*>(sm + kEntOffW);   // [27][64], then the bias
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = warp >> 1;                               // channels 16q..16q+15
  const int s = ((warp & 1) << 5) | lane;                // pixel set
  const int cx = s & 15, ry = 4 * (s >> 4);              // column, first row
  const int tiles_x = (W + kEdgeTile - 1) / kEdgeTile;
  const int tiles_y = (H + kEdgeTile - 1) / kEdgeTile;
  const int tiles = n * tiles_x * tiles_y;
  const int mine = (tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;

  for (int i = tid; i < 28 * 64; i += kThreads)
    ws[i] = __ldg(i < 27 * 64 ? w + i : bias + i - 27 * 64);

  // the halo of tile k into registers: element e = ci * 324 + row * 18 + col
  float pre[kEntLoads];
  auto fetch = [&](int k) {
    const EdgeTile e = edge_tile(blockIdx.x + k * gridDim.x, tiles_x, tiles_y);
    const float* xn = x + static_cast<size_t>(e.n) * H * W * 3;
#pragma unroll
    for (int l = 0; l < kEntLoads; ++l) {
      const int el = tid + l * kThreads;
      if (el < kEntIn) {
        const int ci = el / kEdgeHaloPx, p = el % kEdgeHaloPx;
        // rows/cols past the image (a ragged last tile) feed no stored
        // output: clamp them to stay in bounds
        const int gy = pad1<WRAP>(min(e.y0 + p / kEdgeHalo - 1, H), H);
        const int gx = pad1<WRAP>(min(e.x0 + p % kEdgeHalo - 1, W), W);
        pre[l] = __ldg(xn + (static_cast<size_t>(gy) * W + gx) * 3 + ci);
      }
    }
  };
  fetch(0);

  for (int k = 0; k < mine; ++k) {
    const int buf = k & 1;
    const EdgeTile e = edge_tile(blockIdx.x + k * gridDim.x, tiles_x, tiles_y);
    float* in = reinterpret_cast<float*>(sm + kEntOffIn) + buf * kEntIn;
#pragma unroll
    for (int l = 0; l < kEntLoads; ++l)
      if (tid + l * kThreads < kEntIn) in[tid + l * kThreads] = pre[l];
    // staging buffer buf last held tile k - 2: its stores must have read it
    if (tid == 0) bulk_wait_read<1>();
    __syncthreads();
    if (k + 1 < mine) fetch(k + 1);

    float v[3][6][3];   // [ci][row][col] of this thread's input window
#pragma unroll
    for (int ci = 0; ci < 3; ++ci)
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          v[ci][r][c] = in[ci * kEdgeHaloPx + (ry + r) * kEdgeHalo + cx + c];
    uint8_t* st = sm + buf * 2 * kEntHalf;
    const float4* w4 = reinterpret_cast<const float4*>(ws);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int j = 4 * q + g;            // 4-channel group of the pixel's 64 channels
      float acc[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[p][c] = 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) {
          const float4 wv = w4[(tap * 3 + ci) * 16 + j];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float xv = v[ci][p + tap / 3][tap % 3];
            acc[p][0] = fmaf(xv, wv.x, acc[p][0]);
            acc[p][1] = fmaf(xv, wv.y, acc[p][1]);
            acc[p][2] = fmaf(xv, wv.z, acc[p][2]);
            acc[p][3] = fmaf(xv, wv.w, acc[p][3]);
          }
        }
      const float4 b = w4[27 * 16 + j];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float4 o = make_float4(
            fmaxf(acc[p][0] + b.x, 0.f), fmaxf(acc[p][1] + b.y, 0.f),
            fmaxf(acc[p][2] + b.z, 0.f), fmaxf(acc[p][3] + b.w, 0.f));
        // group j is 16-byte chunk j & 7 of half j >> 3
        const int px = (ry + p) * kEdgeTile + cx;
        *reinterpret_cast<float4*>(st + (j >> 3) * kEntHalf + sw128(px, j & 7)) = o;
      }
    }
    // the staged tile is complete: thread 0 stores it by TMA
    fence_async_smem();
    __syncthreads();
    if (tid == 0) {
      const uint32_t src = saddr(st);
      tma_store_4d(&ymap, src, 0, e.x0, e.y0, e.n);
      tma_store_4d(&ymap, src + kEntHalf, 32, e.x0, e.y0, e.n);
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

// the TMA map of an (n, h, w, 64) float32 tensor, boxes {32 channels (128
// bytes), box_w, box_h, 1}, 128-byte swizzled; 0 or a cudaError_t code
int map_nhwc64(CUtensorMap* map, const float* base, int n, int h, int w, int box_w,
               int box_h) {
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorSymbolNotFound);
  std::memset(map, 0, sizeof *map);
  const cuuint64_t px = 64 * sizeof(float);
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {px, px * w, px * w * h};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base), dims,
             strides, box, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// a persistent grid: one block per SM, or one per tile when there are fewer
int edge_grid(int n, int h, int w, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(n) * ((h + kEdgeTile - 1) / kEdgeTile) *
                          ((w + kEdgeTile - 1) / kEdgeTile);
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  *grid = static_cast<int>(tiles < sms ? tiles : sms);
  return 0;
}

// the least image side a pad mode takes: the reflection needs 2 pixels
int min_side(int wrap) { return wrap ? 1 : 2; }

// (N, H, W, 3) -> relu(conv) (N, H, W, 64); y 16-byte aligned (TMA stores)
template <bool WRAP>
int launch_entry(const float* x, const float* w, const float* b, float* y, int n, int h,
                 int wd, void* stream) {
  if (n <= 0 || n > 65535 || h < min_side(WRAP) || wd < min_side(WRAP))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ymap;
  int grid = 0;
  if (int rc = map_nhwc64(&ymap, y, n, h, wd, kEdgeTile, kEdgeTile)) return rc;
  if (int rc = edge_grid(n, h, wd, &grid)) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      rgb_to_relu1_tma<WRAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kEntSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rgb_to_relu1_tma<WRAP><<<grid, kThreads, kEntSmem, static_cast<cudaStream_t>(stream)>>>(
      ymap, x, w, b, n, h, wd);
  return static_cast<int>(cudaGetLastError());
}

// (N, H, W, 64) -> conv (N, H, W, 3), no ReLU (the renorm is folded into w,
// b); x 16-byte aligned (TMA loads)
template <bool WRAP>
int launch_final(const float* x, const float* w, const float* b, float* y, int n, int h,
                 int wd, void* stream) {
  if (n <= 0 || n > 65535 || h < min_side(WRAP) || wd < min_side(WRAP))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap;
  int grid = 0;
  if (int rc = map_nhwc64(&xmap, x, n, h, wd, kEdgeHalo, kEdgeHalo)) return rc;
  if (int rc = edge_grid(n, h, wd, &grid)) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      final_to_rgb_tma<WRAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kFinSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  final_to_rgb_tma<WRAP><<<grid, kFinThreads, kFinSmem, static_cast<cudaStream_t>(stream)>>>(
      xmap, x, w, b, y, n, h, wd);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// conv3x3_p2, conv3x3_full and upconv_p2 in float32 on the tensor cores:
// conv3x3_tf32x3 and upconv_tf32x3, one skeleton each.
//
// Replace ops/pallas/codec.py:282 conv3x3_p2 (body _conv_p2_kernel :244),
// :376 conv3x3_full (_conv_full_kernel :340) and :449 upconv_p2
// (_upconv_kernel :424). What bounds them on the H100: operations. An FFMA
// direct convolution reached ~41% of the 67 TF/s FP32 rate on them, below
// cuDNN's f32 conv. The tensor cores take TF32 (10 explicit mantissa bits),
// which cannot hold the 2e-5 relative bound in one product. So each operand
// is split into a TF32 "hi" part and a TF32 "lo" remainder (cvt.rna.tf32.f32
// on x and on x - hi) and three products are summed in f32, hi*hi + hi*lo +
// lo*hi; the dropped lo*lo term is ~2^-22 relative. Their least time is the
// 3xTF32 work at the 495 TF/s TF32 rate.
//
// Both are implicit GEMMs on mma.sync (M = output pixels, N = output
// channels, K = taps x Cin) with one skeleton:
// * Input channels stream through shared memory one k8 step at a time (8
//   channels, 32 bytes a pixel), double-buffered with 16-byte cp.async so
//   the next chunk loads while this one multiplies: the chunk's halo
//   (indices resolved once per pixel, not per element; ci is contiguous in
//   NHWC) and its weights for every tap. A halo pixel's two 16-byte halves
//   swap places when bit 2 of its index is set, so the A-fragment loads of a
//   warp (8 consecutive pixels x 4 words) hit 32 distinct banks.
// * A fragments are read from the halo at each tap's offset (the implicit
//   im2col) and split in registers. The weights are split once at pack time
//   (ops/codec.py pack_tc, pack_up) and stored in fragment order, so a
//   lane's {hi(k), hi(k+4), lo(k), lo(k+4)} for an n8 tile is one 16-byte
//   load.
// * A warp holds two m16 tiles x eight n8 tiles (64 channels): 64 f32
//   accumulators a thread. The tensor cores' f32 accumulate rounds toward
//   zero: chained through every product of a conv it biased outputs by
//   ~1e-5 relative. So each chunk's products sum in a fresh partial (64
//   more registers) that one rounded FADD adds to the total (bias ~5e-7).
// * One block of 8 warps per SM, bounded by registers.
//
// conv3x3_tf32x3<CIN, COUT, RELU, POOL, WRAP>, COUT in {64, 128}:
// * A block computes kRows x 16 output pixels for all COUT channels. Warp w
//   owns rows 2(w % RP) and 2(w % RP) + 1 (one m16 tile each: the tile's
//   row m is column m of the image row) and channels 64(w / RP)..+63: 8
//   rows (RP = 4 row pairs, two channel halves) at COUT = 128, 16 rows (RP
//   = 8) at COUT = 64. The halo is (kRows + 2) x 18, reflect-padded (WRAP:
//   circularly padded).
// * Epilogue: bias, ReLU, then the ceil-mode 2x2 pool in registers: a
//   thread holds both rows of a window (its two m16 tiles), and the
//   horizontal neighbour is lane ^ 4, one shuffle away. Pixels past the
//   image enter the max as -inf.
// 158,976 (COUT 128) or 94,464 (COUT 64) bytes of dynamic shared memory.
//
// upconv_tf32x3<C, WRAP>, C in {64, 128}: relu(conv3x3_reflect(
// nearest_up_x2(x))) from the coarse x. A fine-scale reflection of a
// nearest-upsampled image is a coarse-scale edge pad (and a fine-scale wrap
// a coarse-scale wrap: WRAP), and the upsample folds into the conv: fine
// pixel (2i + a, 2j + b) is a 2x2 conv of the edge-padded coarse image at
// rows i + a - 1 + u and columns j + b - 1 + v (u, v in {0, 1}) with the
// folded taps of phase (a, b) (ops/codec.py pack_up). 4 taps a fine pixel
// where the fine-scale conv takes 9, and the upsampled tensor never exists.
// * An m16 tile is 16 coarse columns of one coarse row for one output phase
//   (a, b): its outputs land at fine columns 2j + b of fine row 2i + a. A
//   warp takes one coarse row and one row phase a, and the two column
//   phases b = 0, 1 as its two m16 tiles. They read coarse column offsets
//   {-1, 0} and {0, +1}: the three column-shifted A fragments of a coarse
//   row are loaded (and split) once and feed 4 products.
// * A block computes 4 coarse rows x 16 coarse columns. At C = 64 its warps
//   are 4 rows x both row phases, and a stage holds all 16 tap-phases'
//   weights. At C = 128 those would be 128 KB a stage, so a block takes one
//   row phase (the grid doubles) and its warps are 4 rows x 2 channel
//   halves. Either way a stage is 64 KB of weights plus a 6 x 18 coarse
//   halo: 137,984 bytes of dynamic shared memory.

constexpr int kTcCols = 16;                 // output columns (m16 rows) per block
constexpr int kTcHaloW = kTcCols + 2;
constexpr int kTcChunk = 8;                 // 4-byte words a halo pixel holds a stage
constexpr int kTcK = 8;                     // input channels a stage (one k8 step)

template <int COUT>
struct TcConv {
  static_assert(COUT == 64 || COUT == 128, "output channels");
  static constexpr int kRowPairsLog2 = COUT == 128 ? 2 : 3;
  static constexpr int kRowPairs = 1 << kRowPairsLog2;  // per block
  static constexpr int kRows = 2 * kRowPairs;           // output rows per block
  static constexpr int kHalo = (kRows + 2) * kTcHaloW;  // halo pixels
  // 16-byte units of weights a stage: one per (tap, n8 tile, lane)
  static constexpr int kW4 = 9 * (COUT / 8) * 32;
  static constexpr int kStage = 4 * kW4 + kHalo * kTcChunk;   // words a stage
  static constexpr int kSmem = 2 * kStage * 4;          // bytes
  static constexpr int kLoads = (2 * kHalo + kThreads - 1) / kThreads;  // halo halves a thread
};

constexpr int kUpRows = 4;                           // coarse rows per block
constexpr int kUpHalo = (kUpRows + 2) * kTcHaloW;    // 108 coarse halo pixels

struct UpConv {
  static constexpr int kW4 = 8 * 16 * 32;            // 16-byte units of weights a stage
  static constexpr int kStage = 4 * kW4 + kUpHalo * kTcChunk;
  static constexpr int kSmem = 2 * kStage * 4;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for chunk c's copies: all but the next chunk's group, if one was issued
__device__ __forceinline__ void cp_async_wait(bool next_in_flight) {
  if (next_in_flight)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32, the small terms first; b is a lane's packed
// {hi(k), hi(k+4), lo(k), lo(k+4)}
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ahi,
                                           const uint32_t* alo, float4 b) {
  const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
  mma_tf32(d, alo, bh0, bh1);
  mma_tf32(d, ahi, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, ahi, bh0, bh1);
}

// word k (0..7) of halo pixel p
__device__ __forceinline__ int halo_slot(int p, int k) {
  return p * kTcChunk + (k ^ (((p >> 2) & 1) << 2));
}

// a lane's A fragment of the m16 tile whose row m is halo pixel p0 + m
// (rows g, g + 8; channels t4, t4 + 4), split into TF32 hi and lo
__device__ __forceinline__ void load_a(const float* xs, int p0, int g, int t4,
                                       uint32_t* hi, uint32_t* lo) {
  const float a[4] = {xs[halo_slot(p0 + g, t4)], xs[halo_slot(p0 + g + 8, t4)],
                      xs[halo_slot(p0 + g, t4 + 4)],
                      xs[halo_slot(p0 + g + 8, t4 + 4)]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = to_tf32(a[e]);
    lo[e] = to_tf32(a[e] - __uint_as_float(hi[e]));
  }
}

// two neighbouring outputs (channels co, co + 1) of a thread
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <int CIN, int COUT, bool RELU, bool POOL, bool WRAP>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_tf32x3(const float* __restrict__ x, const float4* __restrict__ wtc,
               const float* __restrict__ bias, float* __restrict__ y, int H, int W) {
  // x: (N, H, W, CIN); wtc: (CIN/8, 9, COUT/8, 32) float4 (ops/codec.py
  // pack_tc); y: (N, H, W, COUT), or (N, ceil(H/2), ceil(W/2), COUT) when POOL
  using S = TcConv<COUT>;
  constexpr int NCH = CIN / kTcK, NJ = COUT / 8;
  extern __shared__ float4 tc_smem[];
  float* sm = reinterpret_cast<float*>(tc_smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // (bit operations: a signed % and / here cost registers that made ptxas
  // spill at the 255 limit)
  const int rp = warp & (S::kRowPairs - 1), nh = warp >> S::kRowPairsLog2;
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * S::kRows, tx0 = blockIdx.x * kTcCols;
  const float* xn = x + static_cast<size_t>(n) * H * W * CIN;

  // thread t copies 16-byte half t & 1 of halo pixels t / 2 + 128 i; each
  // source pixel is resolved once. Rows/cols past the image (a ragged last
  // tile) feed no stored output: clamp them to stay in bounds. Bit 2 of
  // those pixels, the swizzle bit, is bit 3 of t for every i.
  const int half = tid & 1;
  const int dst0 = (tid >> 1) * kTcChunk + 4 * (half ^ ((tid >> 3) & 1));
  int src[S::kLoads];
#pragma unroll
  for (int i = 0; i < S::kLoads; ++i) {
    const int p = (tid >> 1) + i * (kThreads / 2);
    const int gy = pad1<WRAP>(min(ty0 + p / kTcHaloW - 1, H), H);
    const int gx = pad1<WRAP>(min(tx0 + p % kTcHaloW - 1, W), W);
    src[i] = gy * W + gx;
  }

  auto load_chunk = [&](int c, int stage) {
    float* base = sm + stage * S::kStage;
    const float4* wsrc = wtc + static_cast<size_t>(c) * S::kW4;
    float4* wdst = reinterpret_cast<float4*>(base);
    for (int i = tid; i < S::kW4; i += kThreads) cp_async16(wdst + i, wsrc + i);
    float* xs = base + 4 * S::kW4;
#pragma unroll
    for (int i = 0; i < S::kLoads; ++i)
      if (tid + i * kThreads < 2 * S::kHalo)
        cp_async16(xs + dst0 + i * (kThreads / 2) * kTcChunk,
                   xn + static_cast<size_t>(src[i]) * CIN + c * kTcK + (kTcK / 2) * half);
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  load_chunk(0, 0);
  for (int c = 0; c < NCH; ++c) {
    if (c + 1 < NCH) load_chunk(c + 1, (c + 1) & 1);
    cp_async_wait(c + 1 < NCH);
    __syncthreads();
    const float* base = sm + (c & 1) * S::kStage;
    const float* xs = base + 4 * S::kW4;
    // the chunk's 27 products per output sum into a fresh partial, added to
    // the total with one rounded FADD
    float part[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int r = tap / 3, s = tap % 3;
      const float4* ws = reinterpret_cast<const float4*>(base);
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        load_a(xs, (2 * rp + mt + r) * kTcHaloW + s, g, t4, ahi[mt], alo[mt]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = ws[(tap * NJ + nh * 8 + j) * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_3xtf32(part[mt][j], ahi[mt], alo[mt], b);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
    __syncthreads();   // this stage is refilled two chunks on
  }

  // epilogue: c0/c1 are (pixel tx0 + g, channels co, co + 1), c2/c3 pixel
  // tx0 + g + 8; tile mt is image row ty0 + 2 rp + mt
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = nh * 64 + 8 * j + 2 * t4;
    const float b0 = __ldg(bias + co), b1 = __ldg(bias + co + 1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float t = acc[mt][j][e] + (e & 1 ? b1 : b0);
        acc[mt][j][e] = RELU ? fmaxf(t, 0.f) : t;
      }
  }
  const int X0 = tx0 + g, X1 = tx0 + g + 8;
  if constexpr (POOL) {
    const int PH = (H + 1) / 2, PW = (W + 1) / 2;
    const int PY = ty0 / 2 + rp;
    const bool in_y1 = ty0 + 2 * rp + 1 < H;
    float* yp = y + (static_cast<size_t>(n) * PH + PY) * PW * COUT;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = nh * 64 + 8 * j + 2 * t4;
      float m[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in_x = (e < 2 ? X0 : X1) < W;
        const float top = in_x ? acc[0][j][e] : -INFINITY;
        const float bot = in_x && in_y1 ? acc[1][j][e] : -INFINITY;
        m[e] = fmaxf(top, bot);
        m[e] = fmaxf(m[e], __shfl_xor_sync(0xffffffffu, m[e], 4));
      }
      if ((g & 1) == 0 && PY < PH) {
        if (X0 / 2 < PW) store2(yp + static_cast<size_t>(X0 / 2) * COUT + co, m[0], m[1]);
        if (X1 / 2 < PW) store2(yp + static_cast<size_t>(X1 / 2) * COUT + co, m[2], m[3]);
      }
    }
  } else {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int Y = ty0 + 2 * rp + mt;
      if (Y >= H) continue;
      float* yp = y + (static_cast<size_t>(n) * H + Y) * W * COUT;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = nh * 64 + 8 * j + 2 * t4;
        if (X0 < W)
          store2(yp + static_cast<size_t>(X0) * COUT + co, acc[mt][j][0], acc[mt][j][1]);
        if (X1 < W)
          store2(yp + static_cast<size_t>(X1) * COUT + co, acc[mt][j][2], acc[mt][j][3]);
      }
    }
  }
}

template <int C, bool WRAP>
__global__ void __launch_bounds__(kThreads, 1)
upconv_tf32x3(const float* __restrict__ x, const float4* __restrict__ wup,
              const float* __restrict__ bias, float* __restrict__ y, int Hc, int Wc) {
  // x: (N, Hc, Wc, C) coarse; wup: (C/8, 16, C/8, 32) float4 (ops/codec.py
  // pack_up: chunk, tap-phase 8a + 4u + 2b + v, n8 tile, lane); y: (N, 2Hc,
  // 2Wc, C)
  static_assert(C == 64 || C == 128, "channels");
  using S = UpConv;
  constexpr int NCH = C / kTcK, NJ = C / 8;
  constexpr bool BOTH = C == 64;       // a block takes both row phases
  extern __shared__ float4 tc_smem[];
  float* sm = reinterpret_cast<float*>(tc_smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r = warp & 3;                              // coarse row in the block
  const int a = BOTH ? warp >> 2 : blockIdx.y & 1;     // row phase
  const int nh = BOTH ? 0 : warp >> 2;                 // channel half
  const int wa = BOTH ? a : 0;                         // a's place in a stage
  const int i0 = (BOTH ? blockIdx.y : blockIdx.y >> 1) * kUpRows;
  const int j0 = blockIdx.x * kTcCols;
  const int n = blockIdx.z;
  const float* xn = x + static_cast<size_t>(n) * Hc * Wc * C;

  // thread t < 216 copies 16-byte half t & 1 of halo pixel t / 2: coarse row
  // i0 - 1 + t / 2 / 18, column j0 - 1 + t / 2 % 18, clamped into the image
  // (the edge pad; WRAP: wrapped; past a ragged edge it feeds no stored
  // output)
  const int half = tid & 1, hp = tid >> 1;
  const bool copies = tid < 2 * kUpHalo;
  int gy, gx;
  if constexpr (WRAP) {
    gy = wrap1(min(i0 - 1 + hp / kTcHaloW, Hc), Hc);
    gx = wrap1(min(j0 - 1 + hp % kTcHaloW, Wc), Wc);
  } else {
    gy = min(max(i0 - 1 + hp / kTcHaloW, 0), Hc - 1);
    gx = min(max(j0 - 1 + hp % kTcHaloW, 0), Wc - 1);
  }
  const float* src = xn + (static_cast<size_t>(gy) * Wc + gx) * C + (kTcK / 2) * half;
  const int dst = hp * kTcChunk + 4 * (half ^ ((hp >> 2) & 1));

  auto load_chunk = [&](int c, int stage) {
    float* base = sm + stage * S::kStage;
    const float4* wsrc = wup + static_cast<size_t>(BOTH ? c : 2 * c + a) * S::kW4;
    float4* wdst = reinterpret_cast<float4*>(base);
    for (int i = tid; i < S::kW4; i += kThreads) cp_async16(wdst + i, wsrc + i);
    if (copies) cp_async16(base + 4 * S::kW4 + dst, src + c * kTcK);
    cp_async_commit();
  };

  float acc[2][8][4];    // [column phase b][n8 tile][fragment]
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][j][e] = 0.f;

  load_chunk(0, 0);
  for (int c = 0; c < NCH; ++c) {
    if (c + 1 < NCH) load_chunk(c + 1, (c + 1) & 1);
    cp_async_wait(c + 1 < NCH);
    __syncthreads();
    const float* base = sm + (c & 1) * S::kStage;
    const float* xs = base + 4 * S::kW4;
    // the chunk's products per output (4 taps x 3) sum into a fresh partial,
    // added to the total with one rounded FADD
    float part[2][8][4];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[b][j][e] = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      // halo row r + a + u is coarse row i0 + r + a - 1 + u; its fragments at
      // coarse column offsets -1, 0, +1 (halo slots 0, 1, 2)
      const float4* ws = reinterpret_cast<const float4*>(base) + wa * 8 * NJ * 32;
      uint32_t ahi[3][4], alo[3][4];
#pragma unroll
      for (int s = 0; s < 3; ++s)
        load_a(xs, (r + a + u) * kTcHaloW + s, g, t4, ahi[s], alo[s]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const float4 w = ws[((4 * u + 2 * b + v) * NJ + nh * 8 + j) * 32 + lane];
            mma_3xtf32(part[b][j], ahi[b + v], alo[b + v], w);
          }
    }
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][j][e] += part[b][j][e];
    __syncthreads();   // this stage is refilled two chunks on
  }

  // epilogue: tile b's c0/c1 are (coarse column j0 + g, channels co, co + 1),
  // c2/c3 coarse column j0 + g + 8; they land at fine column 2 j + b of fine
  // row 2 (i0 + r) + a
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = nh * 64 + 8 * j + 2 * t4;
    const float b0 = __ldg(bias + co), b1 = __ldg(bias + co + 1);
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[b][j][e] = fmaxf(acc[b][j][e] + (e & 1 ? b1 : b0), 0.f);
  }
  const int i = i0 + r;
  if (i >= Hc) return;
  const int J0 = j0 + g, J1 = j0 + g + 8;
  float* yp = y + ((static_cast<size_t>(n) * Hc + i) * 2 + a) * 2 * Wc * C;
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = nh * 64 + 8 * j + 2 * t4;
      if (J0 < Wc)
        store2(yp + static_cast<size_t>(2 * J0 + b) * C + co, acc[b][j][0], acc[b][j][1]);
      if (J1 < Wc)
        store2(yp + static_cast<size_t>(2 * J1 + b) * C + co, acc[b][j][2], acc[b][j][3]);
    }
}

template <class Kernel>
int launch_dyn(Kernel kern, dim3 grid, int smem, void* stream, const float* x,
               const void* w, const float* b, float* y, int h, int wd) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, reinterpret_cast<const float4*>(w), b, y, h, wd);
  return static_cast<int>(cudaGetLastError());
}

template <int CIN, int COUT, bool RELU, bool POOL, bool WRAP>
int launch_tc(const float* x, const void* wtc, const float* b, float* y, int n, int h,
              int wd, void* stream) {
  using S = TcConv<COUT>;
  const dim3 grid((wd + kTcCols - 1) / kTcCols, (h + S::kRows - 1) / S::kRows, n);
  return launch_dyn(conv3x3_tf32x3<CIN, COUT, RELU, POOL, WRAP>, grid, S::kSmem, stream,
                    x, wtc, b, y, h, wd);
}

template <int CIN, int COUT, bool WRAP>
int launch_tc_rp(const float* x, const void* wtc, const float* b, float* y, int n, int h,
                 int wd, int relu, int pool, void* stream) {
  if (relu && pool)
    return launch_tc<CIN, COUT, true, true, WRAP>(x, wtc, b, y, n, h, wd, stream);
  if (relu) return launch_tc<CIN, COUT, true, false, WRAP>(x, wtc, b, y, n, h, wd, stream);
  if (pool) return launch_tc<CIN, COUT, false, true, WRAP>(x, wtc, b, y, n, h, wd, stream);
  return launch_tc<CIN, COUT, false, false, WRAP>(x, wtc, b, y, n, h, wd, stream);
}

template <int COUT, bool WRAP>
int launch_tc_cin(const float* x, const void* wtc, const float* b, float* y, int n, int h,
                  int wd, int cin, int relu, int pool, void* stream) {
  if (cin == 64)
    return launch_tc_rp<64, COUT, WRAP>(x, wtc, b, y, n, h, wd, relu, pool, stream);
  if (cin == 128)
    return launch_tc_rp<128, COUT, WRAP>(x, wtc, b, y, n, h, wd, relu, pool, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the wide convs at 64 or 128 input channels, ReLU, pool and the pad mode
// chosen at run time
template <int COUT>
int launch_tc_conv(const float* x, const void* wtc, const float* b, float* y, int n, int h,
                   int wd, int cin, int relu, int pool, int wrap, void* stream) {
  if (n <= 0 || n > 65535 || h < min_side(wrap) || wd < min_side(wrap))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wrap)
    return launch_tc_cin<COUT, true>(x, wtc, b, y, n, h, wd, cin, relu, pool, stream);
  return launch_tc_cin<COUT, false>(x, wtc, b, y, n, h, wd, cin, relu, pool, stream);
}

template <int C, bool WRAP>
int launch_up(const float* x, const void* wup, const float* b, float* y, int n, int hc,
              int wc, void* stream) {
  const int blocks_y = (hc + kUpRows - 1) / kUpRows * (C == 64 ? 1 : 2);
  const dim3 grid((wc + kTcCols - 1) / kTcCols, blocks_y, n);
  return launch_dyn(upconv_tf32x3<C, WRAP>, grid, UpConv::kSmem, stream, x, wup, b, y, hc,
                    wc);
}

template <bool WRAP>
int launch_up_c(const float* x, const void* wup, const float* b, float* y, int n, int hc,
                int wc, int c, void* stream) {
  if (c == 64) return launch_up<64, WRAP>(x, wup, b, y, n, hc, wc, stream);
  if (c == 128) return launch_up<128, WRAP>(x, wup, b, y, n, hc, wc, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Every entry point: wrap 0 pads by reflection, 1 circularly.

// (N, H, W, 3) -> relu(conv) (N, H, W, 64); y 16-byte aligned (TMA stores)
int optex_rgb_to_relu1(const float* x, const float* w, const float* b, float* y,
                       int n, int h, int wd, int wrap, void* stream) {
  return wrap ? launch_entry<true>(x, w, b, y, n, h, wd, stream)
              : launch_entry<false>(x, w, b, y, n, h, wd, stream);
}

// (N, H, W, cin) -> (N, H, W, 64), or (N, ceil(H/2), ceil(W/2), 64) when
// pooled; wtc: the split weights in fragment order (ops/codec.py pack_tc)
int optex_conv3x3_p2(const float* x, const float* wtc, const float* b, float* y,
                     int n, int h, int wd, int cin, int relu, int pool, int wrap,
                     void* stream) {
  return launch_tc_conv<64>(x, wtc, b, y, n, h, wd, cin, relu, pool, wrap, stream);
}

// (N, H, W, cin) -> (N, H, W, 128), or (N, ceil(H/2), ceil(W/2), 128) when
// pooled; wtc as for conv3x3_p2
int optex_conv3x3_full(const float* x, const float* wtc, const float* b, float* y,
                       int n, int h, int wd, int cin, int relu, int pool, int wrap,
                       void* stream) {
  return launch_tc_conv<128>(x, wtc, b, y, n, h, wd, cin, relu, pool, wrap, stream);
}

// coarse (N, Hc, Wc, c) -> relu(conv(nearest_up_x2)) (N, 2Hc, 2Wc, c); wup:
// the folded per-phase taps, split, in fragment order (ops/codec.py pack_up)
int optex_upconv_p2(const float* x, const float* wup, const float* b, float* y,
                    int n, int hc, int wc, int c, int wrap, void* stream) {
  if (n <= 0 || n > 65535 || hc < 1 || wc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return wrap ? launch_up_c<true>(x, wup, b, y, n, hc, wc, c, stream)
              : launch_up_c<false>(x, wup, b, y, n, hc, wc, c, stream);
}

// (N, H, W, 64) -> conv (N, H, W, 3), no ReLU (the renorm is folded into w, b);
// x 16-byte aligned (TMA loads)
int optex_final_to_rgb(const float* x, const float* w, const float* b, float* y,
                       int n, int h, int wd, int wrap, void* stream) {
  return wrap ? launch_final<true>(x, w, b, y, n, h, wd, stream)
              : launch_final<false>(x, w, b, y, n, h, wd, stream);
}

const char* optex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
