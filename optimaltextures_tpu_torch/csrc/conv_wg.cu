// The bf16 tensor-core convs of the codec for Hopper (sm_90a) on wgmma, one
// kernel body in two modes, the bf16 function of three Pallas kernels:
//
//   conv3x3_wg<COUT, CIN, ...>  optimaltextures_tpu/ops/pallas/codec.py:282
//                               conv3x3_p2 (body _conv_p2_kernel :244, COUT
//                               64) and :376 conv3x3_full (_conv_full_kernel
//                               :340, COUT 128)
//   upconv_wg<C, ...>           :449 upconv_p2 (body _upconv_kernel :424)
//
//   conv:   y[n, h, w, co] = [pool2x2] [relu] (b[co] + sum_{r, s, ci}
//                              xpad[n, h + r, w + s, ci] * W[r, s, ci, co])
//   upconv: y[n, 2i + a, 2j + b, co] = relu(b[co] + sum_{u, v, ci}
//                              xedge[n, i + a + u, j + b + v, ci] * F[a, b, u, v, ci, co])
//
// on NHWC bf16 x (Cin 64 or 128) with 1-px reflect padding (the conv) or
// the coarse image's 1-px edge padding (the upconv: nearest-x2, reflect pad
// and the 3x3 conv fold, per output phase (a, b), into the 2x2 taps F of
// ops/codec.py fold_up on the edge-padded coarse image), bf16 weights, f32
// accumulate, an f32 bias, ReLU and the ceil-mode 2x2 max-pool in f32, one
// rounding to bf16 at the store. Each mode also has a wrap instantiation
// (the last template parameter, WRAP; the reflect ones are the code they
// were): 1-px circular padding, the tileable runs' halo, under which the
// conv and the upconv alike read the wrapped (coarse) image: a fine-scale
// wrap of a nearest-upsampled image is the coarse-scale wrap. Only the
// producer's row and pixel index changes (halo1).
//
// What bounds them on the H100: operations, or nearly. The conv does 2 x 9
// x Cin FLOPs an output value against 4 bytes of traffic (bf16 in and out):
// 288-576 FLOP/B, above the card's ridge (295 FLOP/B at 989 TF/s dense bf16
// and 3.35 TB/s) at Cin 128 and level with it at Cin 64. The upconv does 2
// x 4 x C FLOPs a fine output value against ~2.5 bytes: its 64-channel call
// is bytes-bound (its output is 4x its input). So the products run on
// wgmma, the one way to the full bf16 tensor-core rate, no operand byte is
// staged twice, and the output leaves in whole 128-byte lines.
//
// Design: an implicit GEMM D[co][px] = A[co][k] * B[k][px] per output row,
// M = 64 output channels, N = a strip of NS pixels of the row (64 at Cin
// 64 and in the upconv, 32 at Cin 128), K = taps x Cin in k16 steps,
// wgmma.m64nNk16 with both operands K-major in shared memory.
// * Kinds of block. A block keeps one kind for its whole life: kind =
//   blockIdx.x % KINDS, and it takes items blockIdx.x / KINDS, stepping by
//   gridDim.x / KINDS. The conv's kinds are its 64-channel co halves (2 at
//   COUT 128, 1 at COUT 64); the upconv's are (row phase a, column phase b,
//   co half): 4 at C 64 and 8 at C 128. The kinds of one item run on
//   neighbouring blocks at the same time, so L2 serves the later reads of
//   each input row.
// * A, the kind's weights, stays resident: copied once a launch (ops/codec.py
//   pack_wg and pack_wg_up: the shared-memory image itself, [tap][64-ci
//   block][co][64 ci] in the 128-byte swizzle; 9 taps (r, s), or the
//   upconv's 4 folded taps (u, v) of its phase). 73,728 or 147,456 bytes for
//   the conv, 32,768 or 65,536 for the upconv.
// * B is the halo: a ring of 8 row slots, each the strip's NS + 2 pixels of
//   one input row (coarse in the upconv) in wgmma's unswizzled K-major
//   layout, [ci group of 8][pixel][16 bytes]: a core matrix (8 pixels x 8
//   ci) is 128 contiguous bytes. A consumer's row pair (rows y, y + 1)
//   reads ring rows g0 .. g0 + 3 (input rows y - 1 .. y + 2). Conv tap (r,
//   s) of row y + j reads ring row g0 + j + r from pixel s; upconv tap (u,
//   v) of coarse row y + j in phase (a, b) reads ring row g0 + j + a + u
//   from pixel b + v. A pixel shift is a start address 16 bytes a pixel on,
//   legal in this layout for every shift (in the 128-byte swizzle it would
//   leave the 1024-byte pattern). The descriptor's stride between 8-pixel
//   groups (SBO) is 128 bytes and its stride between ci groups (LBO) the
//   group pitch, an odd multiple of 16 bytes so the producer's stores
//   spread over the banks.
// * Work items are (image, band of rows, column strip) per kind; a block
//   walks its items and each item's band from top to bottom. Two consumer
//   warpgroups take alternate row pairs (two accumulator sets each), so
//   one's epilogue overlaps the other's wgmma. A slot is free once both
//   warpgroups have released its row, each in ring order and only after
//   seeing it land: a warpgroup frees every row below the end of the pair
//   it finished, and at a band's end the rest of the band, rows it never
//   read (a band's first two or last two) included. So no slot gets two
//   loads ahead of a warpgroup's in-order wait (a parity wait would mistake
//   the phase two loads on for the one it waits for).
// * A producer warpgroup fills the ring: its warp w loads the rows whose ring
//   counter is w mod 4, with 16-byte cp.async (the padding resolved per row
//   and per pixel as it loads: the conv reflects, row -1 is row 1 and row H
//   is row H - 2; the upconv clamps, row -1 is row 0 and row Hc is row Hc -
//   1), waits for them, fences them into the async proxy and arrives on the
//   slot's "full" mbarrier once the consumers have freed it ("empty"
//   mbarrier). Four rows stay in flight, and a slot's rows all come from one
//   warp, in order.
// * Epilogue: each accumulator row is one co, so the bias is one f32 a
//   register row, then ReLU; the pool needs no shuffle: a thread's columns
//   2t, 2t + 1 are a horizontal pool pair (strips start at even columns) and
//   the vertical pair is the same register of the other row's set; a pixel
//   past the image enters the max as -inf. One rounding to bf16, staged as
//   [px][co] and written with 16-byte stores along co, a pixel's 64
//   channels one 128-byte line: consecutive lines in the conv, every other
//   pixel of fine row 2 (y + j) + a from column b in the upconv.
// * The band height is chosen at launch to balance the items over the
//   blocks of a kind (all rows in one band at batch 128; bands at batch 1).
//   Every offset into x and y is 64-bit: at batch 128 a 512^2 x 64 tensor
//   holds 2^31 elements.
//
// The entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() (or cudaErrorInvalidValue for bad sizes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kRing = 8;            // halo row slots
constexpr int kConsumers = 256;     // two warpgroups
constexpr int kThreads = 384;       // + the producer warpgroup
constexpr int kStageStride = 72;    // bf16 a staged pixel: 64 co + 8 of padding
constexpr int kBlockBytes = 64 * 128;   // A of one tap and 64-ci block

template <int CIN, int NS, int TAPS>
struct Cfg {
  static_assert((CIN == 64 || CIN == 128) && NS % 16 == 0, "shape");
  static constexpr int kGroups = CIN / 8;                      // 16-byte ci groups
  static constexpr int kPx = NS + 2;                           // halo pixels a row
  static constexpr int kPitch = (kPx % 2 ? kPx : kPx + 1) * 16;   // group pitch
  static constexpr int kSlot = kGroups * kPitch;
  static constexpr int kKb = CIN / 64;                         // 64-ci blocks a tap
  static constexpr int kWBytes = TAPS * kKb * kBlockBytes;     // one kind's A
  static constexpr int kOffRing = kWBytes;
  static constexpr int kOffStage = kOffRing + kRing * kSlot;
  static constexpr int kStageBytes = NS * kStageStride * 2;    // a warpgroup's row
  static constexpr int kOffBar = kOffStage + 2 * kStageBytes;
  static constexpr int kSmem = kOffBar + 2 * kRing * 8 + 1024;   // + alignment slack
  static_assert(kSmem <= 232448, "shared memory");
  // a slot's rows all come from one producer warp, in order
  static_assert(kRing % 4 == 0, "ring slots a multiple of the producer warps");
};

// the strip width of a mode: m64n64k16 where the resident weights leave room
// for a 64-pixel ring (the conv at Cin 64, the upconv), m64n32k16 otherwise
template <bool UP, int CIN>
constexpr int kStrip = UP || CIN == 64 ? 64 : 32;

// 1-px reflection into [0, n) for i in [-1, n]; n >= 2
__device__ __forceinline__ int reflect1(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * n - 2 - i : i;
}

// the edge pad: i clamped into [0, n)
__device__ __forceinline__ int clamp1(int i, int n) { return min(max(i, 0), n - 1); }

// 1-px circular wrap into [0, n) for i in [-1, n]; n >= 1 (no % or /)
__device__ __forceinline__ int wrap1(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// the producer's halo row or pixel index, i in [-1, n + 1] (past n: a last
// pair's second row, which feeds no stored output): the conv reflects, the
// upconv clamps (the coarse edge pad), and under WRAP both wrap
template <bool UP, bool WRAP>
__device__ __forceinline__ int halo1(int i, int n) {
  if constexpr (WRAP)
    return wrap1(min(i, n), n);
  else if constexpr (UP)
    return clamp1(i, n);
  else
    return reflect1(min(i, n), n);
}

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

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma shared-memory descriptors: the 128-byte swizzle (layout type 1; 8-row
// groups 1024 bytes apart, the leading offset unused for K-major), and the
// unswizzled "interleave" layout (type 0) with its two strides
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_interleave(uint32_t addr, uint32_t lbo,
                                                    uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 f32) = [d +] A (64 x 16) * B (16 x 64), both K-major
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 32 f32) = [d +] A (64 x 16) * B (16 x 32), both K-major
__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// a work item: image n, output rows y0 .. y0 + 2 np - 1 (coarse rows in the
// upconv; the last pair's second row may lie past the image), columns w0 ..
// w0 + NS - 1; its halo rows are y0 - 1 .. y0 + 2 np, 2 np + 2 ring rows
struct Item {
  int n, y0, w0, np;
};

template <int NS>
__device__ __forceinline__ Item decode(long long it, int h, int band, int bands,
                                       int strips) {
  Item m;
  const int strip = static_cast<int>(it % strips);
  const long long rest = it / strips;
  m.y0 = static_cast<int>(rest % bands) * band;
  m.n = static_cast<int>(rest / bands);
  m.w0 = strip * NS;
  m.np = (min(band, h - m.y0) + 1) / 2;
  return m;
}

// a consumer warpgroup waits, in order, until every ring row below `end` has
// landed; `seen` counts the rows it has watched land. In order, because a
// parity wait cannot tell a slot's phase k from phase k - 2: a wait for row
// g comes after row g - 8 (the slot's previous row) was seen to land, and
// row g + 8 cannot land before this warpgroup has released row g.
__device__ __forceinline__ void wait_landed(uint32_t s_bar, uint32_t& seen,
                                            uint32_t end) {
  for (; seen < end; ++seen) mbar_wait(s_bar + 8 * (seen % kRing), (seen / kRing) & 1);
}

// a consumer warpgroup releases, in order, every ring row below `end` it has
// not released yet (`freed` counts them), once it has seen each land and
// every thread of it is done reading them (the caller's named barrier)
__device__ __forceinline__ void release_to(uint32_t s_bar, uint32_t& seen,
                                           uint32_t& freed, uint32_t end, int ctid) {
  wait_landed(s_bar, seen, end);
  if (ctid == 0)
    for (uint32_t r = freed; r < end; ++r) mbar_arrive(s_bar + 8 * (kRing + r % kRing));
  freed = end;
}

// The kernel body. UP: the folded upconv (C -> C, 4 taps, kinds (a, b,
// half), the edge pad, the strided store; RELU, no POOL); else the 3x3 conv
// (9 taps, kinds = co halves, the reflect pad). WRAP: the circular pad in
// either. h, w: the input's (coarse) size.
template <bool UP, int CIN, int COUT, bool RELU, bool POOL, bool WRAP>
__device__ __forceinline__ void wg_body(const __nv_bfloat16* __restrict__ x,
                                        const __nv_bfloat16* __restrict__ wwg,
                                        const float* __restrict__ bias,
                                        __nv_bfloat16* __restrict__ y, int n_img, int h,
                                        int w, int band, int bands) {
  static_assert(!(UP && POOL) && (COUT == 64 || COUT == 128), "mode");
  constexpr int NS = kStrip<UP, CIN>;
  constexpr int kTaps = UP ? 4 : 9;
  constexpr int kHalves = COUT / 64;
  constexpr int kKinds = (UP ? 4 : 1) * kHalves;
  using C = Cfg<CIN, NS, kTaps>;
  constexpr int kAcc = NS / 2;   // f32 accumulators a thread holds for one row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (saddr(smem_raw) & 1023u)) & 1023u);
  const uint32_t s_w = saddr(sm), s_ring = s_w + C::kOffRing, s_bar = s_w + C::kOffBar;
  const int tid = threadIdx.x;
  const int kind = blockIdx.x % kKinds;
  const int half = kind % kHalves;
  const int pa = kind / kHalves / 2, pb = kind / kHalves % 2;   // the upconv's phase

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(s_bar + 8 * i, 32);             // full: the loading warp's lanes
      mbar_init(s_bar + 8 * (kRing + i), 2);    // empty: both warpgroups' release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the kind's weights: the shared-memory image as ops/codec.py pack_wg /
  // pack_wg_up lays it out, copied once
  const uint4* wsrc = reinterpret_cast<const uint4*>(wwg) + kind * (C::kWBytes / 16);
  for (int i = tid; i < C::kWBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(sm)[i] = __ldg(wsrc + i);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int strips = (w + NS - 1) / NS;
  const long long items = static_cast<long long>(n_img) * bands * strips;
  const long long first = blockIdx.x / kKinds, step = gridDim.x / kKinds;

  // the role, warp-uniform to the compiler: a branch on threadIdx alone
  // would put the consumers' wgmma on a divergent path, which ptxas
  // serializes
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {
    // ---- producer warpgroup: warp pw loads ring rows g = pw mod 4 ----
    const int pw = (tid - kConsumers) >> 5, lane = tid & 31;
    uint32_t g = 0;
    for (long long it = first; it < items; it += step) {
      const Item m = decode<NS>(it, h, band, bands, strips);
      for (int r = 0; r < 2 * m.np + 2; ++r, ++g) {
        if ((g & 3) != static_cast<uint32_t>(pw)) continue;
        const int slot = g % kRing;
        mbar_wait(s_bar + 8 * (kRing + slot), ((g / kRing) & 1) ^ 1);
        // rows past the image (a last pair's second row) feed no stored output
        const int iy = halo1<UP, WRAP>(m.y0 - 1 + r, h);
        const __nv_bfloat16* src =
            x + (static_cast<int64_t>(m.n) * h + iy) * w * CIN;
        const uint32_t dst = s_ring + slot * C::kSlot;
        for (int e = lane; e < C::kPx * C::kGroups; e += 32) {
          const int p = e / C::kGroups, gi = e % C::kGroups;
          const int ix = halo1<UP, WRAP>(m.w0 - 1 + p, w);
          cp_async16(dst + gi * C::kPitch + p * 16,
                     src + static_cast<int64_t>(ix) * CIN + gi * 8);
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(s_bar + 8 * slot);
      }
    }
    return;
  }

  // ---- consumer warpgroups: wg takes the block's row pairs k = wg mod 2 ----
  const int wg = role, ctid = tid & 127, warp = ctid >> 5, lane = tid & 31;
  const int co = 16 * warp + (lane >> 2);   // accumulator rows co, co + 8
  const float b0 = __ldg(bias + 64 * half + co), b1 = __ldg(bias + 64 * half + co + 8);
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(sm + C::kOffStage + wg * C::kStageBytes);
  const uint64_t a0 = desc_sw128(s_w);
  uint32_t g = 0;      // ring counter of the item's first halo row
  uint32_t seen = 0;   // ring rows this warpgroup has seen land
  uint32_t freed = 0;  // ring rows this warpgroup has released
  uint32_t pair = 0;   // the block's row pairs so far
  float acc[2][kAcc];
  for (long long it = first; it < items; it += step) {
    const Item m = decode<NS>(it, h, band, bands, strips);
    for (int p = 0; p < m.np; ++p, ++pair) {
      if ((pair & 1) != static_cast<uint32_t>(wg)) continue;
      const uint32_t g0 = g + 2 * p;
      wait_landed(s_bar, seen, g0 + 4);
      // bd[i]: ring row g0 + i (the upconv's row phase a: g0 + a + i)
      uint64_t bd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        bd[i] = desc_interleave(s_ring + ((g0 + (UP ? pa : 0) + i) % kRing) * C::kSlot,
                                C::kPitch, 128);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap) {
        // row and pixel offsets: conv tap (r, s) = (tap / 3, tap % 3); upconv
        // tap (u, v) = (tap / 2, tap % 2) reads pixel b + v
        const int r = UP ? tap / 2 : tap / 3;
        const int s = UP ? pb + tap % 2 : tap % 3;
#pragma unroll
        for (int kk = 0; kk < CIN / 16; ++kk) {
          // A: block (tap, kk / 4), +32 bytes per k16 step inside the swizzled
          // row; B: ring row + r, pixel s, ci groups 2 kk and 2 kk + 1
          const uint64_t a =
              a0 + (((tap * C::kKb + kk / 4) * kBlockBytes + (kk % 4) * 32) >> 4);
          const uint32_t boff = (2 * kk * C::kPitch + s * 16) >> 4;
#pragma unroll
          for (int j = 0; j < 2; ++j) wgmma(acc[j], a, bd[j + r] + boff, tap | kk);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_acc(acc[0]);
      fence_acc(acc[1]);

      // epilogue: (row y + j, co + 8 hh, pixel 8 jj + 2 (lane % 4) + e) is
      // acc[j][4 jj + 2 hh + e]
      const int yr = m.y0 + 2 * p;
      const int t4 = lane & 3;
#pragma unroll
      for (int j = 0; j < (POOL ? 1 : 2); ++j) {
        if (yr + j >= h) continue;   // the pair's second row past the image
#pragma unroll
        for (int jj = 0; jj < NS / 8; ++jj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float bb = hh ? b1 : b0;
            if constexpr (POOL) {
              // the window's four pixels; one past the image enters as -inf
              const bool y1 = yr + 1 < h;
              float mx = -INFINITY;
#pragma unroll
              for (int jr = 0; jr < 2; ++jr)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  float t = acc[jr][4 * jj + 2 * hh + e] + bb;
                  t = RELU ? fmaxf(t, 0.f) : t;
                  const bool in = m.w0 + 8 * jj + 2 * t4 + e < w && (jr == 0 || y1);
                  mx = in ? fmaxf(mx, t) : mx;
                }
              stage[(4 * jj + t4) * kStageStride + co + 8 * hh] = __float2bfloat16_rn(mx);
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float t = acc[j][4 * jj + 2 * hh + e] + bb;
                t = RELU ? fmaxf(t, 0.f) : t;
                stage[(8 * jj + 2 * t4 + e) * kStageStride + co + 8 * hh] =
                    __float2bfloat16_rn(t);
              }
            }
          }
        bar_sync(1 + wg);
        // every thread of the warpgroup is past its wgmma wait: free the
        // rows up to the pair's last (this warpgroup's next pair starts 4 on)
        if (j == 0) release_to(s_bar, seen, freed, g0 + 4, ctid);
        // the output row and its first pixel; staged pixel px goes `pstep`
        // output pixels on (the upconv: fine row 2 (y + j) + a, columns
        // 2 (w0 + px) + b)
        const int oh = UP ? 2 * h : POOL ? (h + 1) / 2 : h;
        const int ow = UP ? 2 * w : POOL ? (w + 1) / 2 : w;
        const int oy = UP ? 2 * (yr + j) + pa : POOL ? yr / 2 : yr + j;
        const int ox = UP ? 2 * m.w0 + pb : POOL ? m.w0 / 2 : m.w0;
        constexpr int pstep = UP ? 2 : 1;
        const int npx = POOL ? min(NS / 2, ow - ox) : min(NS, w - m.w0);
        __nv_bfloat16* op =
            y + ((static_cast<int64_t>(m.n) * oh + oy) * ow + ox) * COUT + 64 * half;
        for (int q = ctid; q < npx * 8; q += 128) {
          const int px = q >> 3, c = q & 7;
          *reinterpret_cast<uint4*>(op + static_cast<int64_t>(px) * pstep * COUT + c * 8) =
              *reinterpret_cast<const uint4*>(stage + px * kStageStride + c * 8);
        }
        bar_sync(1 + wg);
      }
    }
    g += 2 * m.np + 2;
    release_to(s_bar, seen, freed, g, ctid);   // the band's rows left
  }
}

template <int COUT, int CIN, bool RELU, bool POOL, bool WRAP>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wg(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wwg,
           const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int n_img,
           int h, int w, int band, int bands) {
  wg_body<false, CIN, COUT, RELU, POOL, WRAP>(x, wwg, bias, y, n_img, h, w, band, bands);
}

template <int C, bool WRAP>
__global__ void __launch_bounds__(kThreads, 1)
upconv_wg(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wwg,
          const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int n_img,
          int h, int w, int band, int bands) {
  wg_body<true, C, C, true, false, WRAP>(x, wwg, bias, y, n_img, h, w, band, bands);
}

// the band height (even) that spreads n_tiles x bands items best over the
// blocks of a kind: the least rows a block loads, each item costing its
// band + 2 halo rows and ~2 rows of filling and draining
void choose_band(long long tiles, int h, int per_kind, int* band, int* bands) {
  long long best = LLONG_MAX;
  for (int k = 1; k <= (h + 1) / 2; ++k) {
    int b = (h + k - 1) / k;
    b += b & 1;
    const int nb = (h + b - 1) / b;
    const long long cost = (tiles * nb + per_kind - 1) / per_kind * (b + 4);
    if (cost < best) {
      best = cost;
      *band = b;
      *bands = nb;
    }
  }
}

template <bool UP, int CIN, int COUT, class Kernel>
int launch(Kernel kern, const __nv_bfloat16* x, const void* wwg, const float* b,
           __nv_bfloat16* y, int n, int h, int w, cudaStream_t stream) {
  constexpr int NS = kStrip<UP, CIN>;
  constexpr int kKinds = (UP ? 4 : 1) * (COUT / 64);
  constexpr int kSmem = Cfg<CIN, NS, UP ? 4 : 9>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const int per_kind = sms / kKinds > 0 ? sms / kKinds : 1;
  const long long tiles = static_cast<long long>(n) * ((w + NS - 1) / NS);
  int band = 2, bands = 1;
  choose_band(tiles, h, per_kind, &band, &bands);
  const long long items = tiles * bands;
  const int grid = kKinds * static_cast<int>(items < per_kind ? items : per_kind);
  kern<<<grid, kThreads, kSmem, stream>>>(x, static_cast<const __nv_bfloat16*>(wwg), b, y,
                                          n, h, w, band, bands);
  return static_cast<int>(cudaGetLastError());
}

template <int COUT, int CIN, bool WRAP>
int launch_rp(const __nv_bfloat16* x, const void* wwg, const float* b, __nv_bfloat16* y,
              int n, int h, int w, int relu, int pool, cudaStream_t stream) {
  if (relu && pool)
    return launch<false, CIN, COUT>(conv3x3_wg<COUT, CIN, true, true, WRAP>, x, wwg, b, y,
                                    n, h, w, stream);
  if (relu)
    return launch<false, CIN, COUT>(conv3x3_wg<COUT, CIN, true, false, WRAP>, x, wwg, b, y,
                                    n, h, w, stream);
  if (pool)
    return launch<false, CIN, COUT>(conv3x3_wg<COUT, CIN, false, true, WRAP>, x, wwg, b, y,
                                    n, h, w, stream);
  return launch<false, CIN, COUT>(conv3x3_wg<COUT, CIN, false, false, WRAP>, x, wwg, b, y,
                                  n, h, w, stream);
}

template <int COUT, bool WRAP>
int launch_cin(const __nv_bfloat16* x, const void* wwg, const float* b, __nv_bfloat16* y,
               int n, int h, int wd, int cin, int relu, int pool, cudaStream_t s) {
  if (cin == 64) return launch_rp<COUT, 64, WRAP>(x, wwg, b, y, n, h, wd, relu, pool, s);
  if (cin == 128) return launch_rp<COUT, 128, WRAP>(x, wwg, b, y, n, h, wd, relu, pool, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the reflection needs 2 pixels a side, the wrap 1
template <int COUT>
int launch_conv(const __nv_bfloat16* x, const void* wwg, const float* b, __nv_bfloat16* y,
                int n, int h, int wd, int cin, int relu, int pool, int wrap, void* stream) {
  const int least = wrap ? 1 : 2;
  if (n <= 0 || h < least || wd < least || h > INT_MAX - 8 || wd > INT_MAX - 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wrap) return launch_cin<COUT, true>(x, wwg, b, y, n, h, wd, cin, relu, pool, s);
  return launch_cin<COUT, false>(x, wwg, b, y, n, h, wd, cin, relu, pool, s);
}

}  // namespace

extern "C" {

// Every entry point: wrap 0 pads by reflection (the upconv: the coarse
// edge pad), 1 circularly.

// (N, H, W, cin) bf16 -> [relu] conv (N, H, W, 64) bf16, or its 2x2 ceil-mode
// max-pool (N, ceil(H/2), ceil(W/2), 64); wwg: ops/codec.py pack_wg's one
// image (Cout 64); b: (64,) f32
int optex_conv3x3_p2_bf16(const __nv_bfloat16* x, const void* wwg, const float* b,
                          __nv_bfloat16* y, int n, int h, int wd, int cin, int relu,
                          int pool, int wrap, void* stream) {
  return launch_conv<64>(x, wwg, b, y, n, h, wd, cin, relu, pool, wrap, stream);
}

// the same to 128 channels; wwg: pack_wg's two co halves; b: (128,) f32
int optex_conv3x3_full_bf16(const __nv_bfloat16* x, const void* wwg, const float* b,
                            __nv_bfloat16* y, int n, int h, int wd, int cin, int relu,
                            int pool, int wrap, void* stream) {
  return launch_conv<128>(x, wwg, b, y, n, h, wd, cin, relu, pool, wrap, stream);
}

// coarse (N, Hc, Wc, c) bf16 -> relu(conv3x3_<pad>(nearest_up_x2)) (N, 2Hc,
// 2Wc, c) bf16; wwg: ops/codec.py pack_wg_up's images, kind (a, b, co half);
// b: (c,) f32
int optex_upconv_p2_bf16(const __nv_bfloat16* x, const void* wwg, const float* b,
                         __nv_bfloat16* y, int n, int hc, int wc, int c, int wrap,
                         void* stream) {
  if (n <= 0 || hc < 1 || wc < 1 || hc > INT_MAX / 2 - 8 || wc > INT_MAX / 2 - 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 64)
    return wrap ? launch<true, 64, 64>(upconv_wg<64, true>, x, wwg, b, y, n, hc, wc, s)
                : launch<true, 64, 64>(upconv_wg<64, false>, x, wwg, b, y, n, hc, wc, s);
  if (c == 128)
    return wrap ? launch<true, 128, 128>(upconv_wg<128, true>, x, wwg, b, y, n, hc, wc, s)
                : launch<true, 128, 128>(upconv_wg<128, false>, x, wwg, b, y, n, hc, wc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the dynamic shared memory a launch asks for: the conv (up 0) or the upconv
// (up 1) at `cin` input channels
int optex_conv_wg_smem(int up, int cin) {
  if (cin != 64 && cin != 128) return 0;
  if (up) return cin == 64 ? Cfg<64, 64, 4>::kSmem : Cfg<128, 64, 4>::kSmem;
  return cin == 64 ? Cfg<64, 64, 9>::kSmem : Cfg<128, 32, 9>::kSmem;
}

const char* optex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
