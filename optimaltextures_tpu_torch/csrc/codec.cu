// Codec convolution kernels for Hopper (sm_90a): the port of the five Pallas
// kernels in optimaltextures_tpu/ops/pallas/codec.py.
//
// All five compute one operation: a 3x3 convolution with 1-px reflect
// padding and a bias, on NHWC float32 tensors, with an optional nearest-x2
// upsample in front, and an optional ReLU and 2x2 max-pool (taken after the
// ReLU, ceil mode) behind. What bounds each on the H100 sets its design:
//
//   rgb_to_relu1  conv3x3_reflect<3, 64, 16, 64, 3, true>    bytes
//   final_to_rgb  conv3x3_reflect<64, 3, 32, 4, 8, false>    bytes
//   conv3x3_p2    conv3x3_tf32x3<64|128, 64, RELU, POOL>     operations
//   conv3x3_full  conv3x3_tf32x3<64|128, 128, RELU, POOL>    operations
//   upconv_p2     upconv_tf32x3<64|128>                      operations
//
// The narrow entry and final convs do 54 / 1152 FLOPs per 4+256 / 256+12
// bytes of pixel traffic, below the card's ridge: a plain FFMA direct
// convolution that reads its input once and writes its output once. The
// wide convs do 2 x 9 x Cin multiply-adds per output value (upconv, folded:
// 2 x 4 x Cin) against 8 bytes of traffic, far above it: implicit GEMMs on
// the tensor cores, three TF32 products per f32 product.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a configuration
// it was not built for).

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

// 1-px reflection into [0, n) for i in [-1, n]; n >= 2.
__device__ __forceinline__ int reflect1(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * n - 2 - i : i;
}

// ---------------------------------------------------------------------------
// rgb_to_relu1 and final_to_rgb: conv3x3_reflect, an FFMA direct convolution.
//
// Replaces ops/pallas/codec.py:578 rgb_to_relu1 (body _entry_kernel :551)
// and :515 final_to_rgb (_final_kernel :491; the next stage's 1x1 RGB
// renorm is folded into its weights at pack time). Bytes-bound:
// * A block computes a TILE x TILE patch of output pixels for CO_TILE output
//   channels of one image. Thread t owns one 2x2 pixel quad and CPT
//   consecutive output channels, so each thread's stores are float4-wide
//   (the 64-channel output of the entry conv is written once, coalesced).
// * Input channels stream through shared memory CI_CHUNK at a time: the
//   (TILE+2)^2 halo with the reflect indices resolved while loading, plus
//   the weight slice [tap][ci][co] for the block's output channels. No
//   padded copy reaches device memory.
// * Each thread keeps its 4 x CPT accumulators in f32 registers; per input
//   channel it reads a 4x4 input window once and each weight float4 once
//   (broadcast across the warp, which shares the channel group).

template <int CIN, int COUT, int TILE, int CO_TILE, int CI_CHUNK, bool RELU>
__global__ void __launch_bounds__(kThreads)
conv3x3_reflect(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y, int H,
                int W) {
  // x: (N, H, W, CIN); w: (3, 3, CIN, COUT) HWIO; y: (N, H, W, COUT)
  constexpr int QS = TILE / 2;           // quads per tile side
  constexpr int NQ = QS * QS;            // quads per tile
  constexpr int NG = kThreads / NQ;      // channel groups per block
  constexpr int CPT = CO_TILE / NG;      // output channels per thread
  constexpr int HS = TILE + 2;           // halo side
  constexpr int CO_TILES = (COUT + CO_TILE - 1) / CO_TILE;
  static_assert(NQ * NG == kThreads, "thread layout");
  static_assert(CPT * NG == CO_TILE && CPT % 4 == 0, "channel layout");
  static_assert(CIN % CI_CHUNK == 0, "input-channel chunking");

  __shared__ float xs[CI_CHUNK * HS * HS];
  __shared__ __align__(16) float ws[9 * CI_CHUNK * CO_TILE];

  const int tid = threadIdx.x;
  const int q = tid % NQ, g = tid / NQ;
  const int qy = q / QS, qx = q % QS;
  const int n = blockIdx.z / CO_TILES;
  const int co0 = (blockIdx.z % CO_TILES) * CO_TILE;
  const int ty0 = blockIdx.y * TILE, tx0 = blockIdx.x * TILE;
  const float* xn = x + static_cast<size_t>(n) * H * W * CIN;

  float acc[4][CPT];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[p][k] = 0.f;

  for (int c0 = 0; c0 < CIN; c0 += CI_CHUNK) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < HS * HS * CI_CHUNK; i += kThreads) {
      const int ci = i % CI_CHUNK, p = i / CI_CHUNK;
      // rows/cols past the image (a ragged last tile) feed no stored output:
      // clamp them to stay in bounds
      const int gy = reflect1(min(ty0 + p / HS - 1, H), H);
      const int gx = reflect1(min(tx0 + p % HS - 1, W), W);
      xs[ci * HS * HS + p] =
          __ldg(xn + (static_cast<size_t>(gy) * W + gx) * CIN + c0 + ci);
    }
    for (int i = tid; i < 9 * CI_CHUNK * CO_TILE; i += kThreads) {
      const int co = i % CO_TILE, r = i / CO_TILE;  // r = tap * CI_CHUNK + ci
      const int tap = r / CI_CHUNK, ci = r % CI_CHUNK;
      const int gco = co0 + co;
      ws[i] = gco < COUT
                  ? __ldg(w + (static_cast<size_t>(tap) * CIN + c0 + ci) * COUT + gco)
                  : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < CI_CHUNK; ++ci) {
      float v[4][4];
      const float* xc = xs + ci * HS * HS + (2 * qy) * HS + 2 * qx;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) v[a][b] = xc[a * HS + b];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int kh = tap / 3, kw = tap % 3;
        const float4* wp = reinterpret_cast<const float4*>(
            ws + (tap * CI_CHUNK + ci) * CO_TILE + g * CPT);
#pragma unroll
        for (int k4 = 0; k4 < CPT / 4; ++k4) {
          const float4 wv = wp[k4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float xv = v[kh + p / 2][kw + p % 2];
            acc[p][4 * k4 + 0] = fmaf(xv, wv.x, acc[p][4 * k4 + 0]);
            acc[p][4 * k4 + 1] = fmaf(xv, wv.y, acc[p][4 * k4 + 1]);
            acc[p][4 * k4 + 2] = fmaf(xv, wv.z, acc[p][4 * k4 + 2]);
            acc[p][4 * k4 + 3] = fmaf(xv, wv.w, acc[p][4 * k4 + 3]);
          }
        }
      }
    }
  }

  // epilogue: bias, ReLU
  const int cbase = co0 + g * CPT;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const float bk = cbase + k < COUT ? __ldg(bias + cbase + k) : 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float t = acc[p][k] + bk;
      acc[p][k] = RELU ? fmaxf(t, 0.f) : t;
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int Y = ty0 + 2 * qy + p / 2, X = tx0 + 2 * qx + p % 2;
    if (Y >= H || X >= W) continue;
    float* yp = y + ((static_cast<size_t>(n) * H + Y) * W + X) * COUT + cbase;
    if (COUT % 4 == 0) {
#pragma unroll
      for (int k4 = 0; k4 < CPT / 4; ++k4)
        reinterpret_cast<float4*>(yp)[k4] =
            make_float4(acc[p][4 * k4], acc[p][4 * k4 + 1], acc[p][4 * k4 + 2],
                        acc[p][4 * k4 + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < CPT; ++k)
        if (cbase + k < COUT) yp[k] = acc[p][k];
    }
  }
}

template <int CIN, int COUT, int TILE, int CO_TILE, int CI_CHUNK, bool RELU>
int launch(const float* x, const float* w, const float* b, float* y, int n,
           int h, int wd, void* stream) {
  constexpr int CO_TILES = (COUT + CO_TILE - 1) / CO_TILE;
  const dim3 grid((wd + TILE - 1) / TILE, (h + TILE - 1) / TILE, n * CO_TILES);
  conv3x3_reflect<CIN, COUT, TILE, CO_TILE, CI_CHUNK, RELU>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, w, b, y, h,
                                                                 wd);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// conv3x3_p2, conv3x3_full and upconv_p2 on the tensor cores:
// conv3x3_tf32x3 and upconv_tf32x3.
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
// Both are implicit GEMMs on mma.sync.m16n8k8 (M = output pixels, N =
// output channels, K = taps x Cin) with one skeleton:
// * Input channels stream through shared memory 8 at a time (one k8 step),
//   double-buffered with 16-byte cp.async so the next chunk loads while this
//   one multiplies: the chunk's halo (indices resolved once per pixel, not
//   per element; ci is contiguous in NHWC) and its weights for every tap. A
//   halo pixel's two 16-byte halves swap places when bit 2 of its index is
//   set, so the A-fragment loads of a warp (8 consecutive pixels x 4
//   channels) hit 32 distinct banks.
// * A fragments are read from the halo at each tap's offset (the implicit
//   im2col; a shifted 2-D window is why this is mma.sync and not wgmma) and
//   split in registers. The weights are split once at pack time
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
// conv3x3_tf32x3<CIN, COUT, RELU, POOL>, COUT in {64, 128}:
// * A block computes kRows x 16 output pixels for all COUT channels. Warp w
//   owns rows 2(w % RP) and 2(w % RP) + 1 (one m16 tile each: the tile's
//   row m is column m of the image row) and channels 64(w / RP)..+63: 8
//   rows (RP = 4 row pairs, two channel halves) at COUT = 128, 16 rows (RP
//   = 8) at COUT = 64. The halo is (kRows + 2) x 18, reflect-padded.
// * Epilogue: bias, ReLU, then the ceil-mode 2x2 pool in registers: a
//   thread holds both rows of a window (its two m16 tiles), and the
//   horizontal neighbour is lane ^ 4, one shuffle away. Pixels past the
//   image enter the max as -inf.
// 158,976 (COUT 128) or 94,464 (COUT 64) bytes of dynamic shared memory.
//
// upconv_tf32x3<C>, C in {64, 128}: relu(conv3x3_reflect(nearest_up_x2(x)))
// from the coarse x. A fine-scale reflection of a nearest-upsampled image
// is a coarse-scale edge pad, and the upsample folds into the conv: fine
// pixel (2i + a, 2j + b) is a 2x2 conv of the edge-padded coarse image at
// rows i + a - 1 + u and columns j + b - 1 + v (u, v in {0, 1}) with the
// folded taps of phase (a, b) (ops/codec.py pack_up). 4 taps a fine pixel
// where the fine-scale conv takes 9, and the upsampled tensor never exists.
// * An m16 tile is 16 coarse columns of one coarse row for one output phase
//   (a, b): its outputs land at fine columns 2j + b of fine row 2i + a. A
//   warp takes one coarse row and one row phase a, and the two column
//   phases b = 0, 1 as its two m16 tiles. They read coarse column offsets
//   {-1, 0} and {0, +1}: the three column-shifted A fragments of a coarse
//   row are loaded and split once and feed 4 products.
// * A block computes 4 coarse rows x 16 coarse columns. At C = 64 its warps
//   are 4 rows x both row phases, and a stage holds all 16 tap-phases'
//   weights. At C = 128 those would be 128 KB a stage, so a block takes one
//   row phase (the grid doubles) and its warps are 4 rows x 2 channel
//   halves. Either way a stage is 64 KB of weights plus a 6 x 18 coarse
//   halo: 137,984 bytes of dynamic shared memory.

constexpr int kTcCols = 16;                 // output columns (m16 rows) per block
constexpr int kTcHaloW = kTcCols + 2;
constexpr int kTcChunk = 8;                 // input channels per stage

template <int COUT>
struct TcConv {
  static_assert(COUT == 64 || COUT == 128, "output channels");
  static constexpr int kRowPairsLog2 = COUT == 128 ? 2 : 3;
  static constexpr int kRowPairs = 1 << kRowPairsLog2;  // per block
  static constexpr int kRows = 2 * kRowPairs;           // output rows per block
  static constexpr int kHalo = (kRows + 2) * kTcHaloW;  // halo pixels
  static constexpr int kW4 = 9 * (COUT / 8) * 32;       // float4s of weights a stage
  static constexpr int kStage = 4 * kW4 + kHalo * kTcChunk;   // floats a stage
  static constexpr int kSmem = 2 * kStage * 4;          // bytes
  static constexpr int kLoads = (2 * kHalo + kThreads - 1) / kThreads;  // halo halves a thread
};

constexpr int kUpRows = 4;                           // coarse rows per block
constexpr int kUpHalo = (kUpRows + 2) * kTcHaloW;    // 108 coarse halo pixels
constexpr int kUpW4 = 8 * 16 * 32;                   // float4s of weights a stage
constexpr int kUpStage = 4 * kUpW4 + kUpHalo * kTcChunk;
constexpr int kUpSmem = 2 * kUpStage * 4;

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

// word of channel k (0..7) of halo pixel p
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

template <int CIN, int COUT, bool RELU, bool POOL>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_tf32x3(const float* __restrict__ x, const float4* __restrict__ wtc,
               const float* __restrict__ bias, float* __restrict__ y, int H,
               int W) {
  // x: (N, H, W, CIN); wtc: (CIN/8, 9, COUT/8, 32) float4 (ops/codec.py
  // pack_tc); y: (N, H, W, COUT), or (N, ceil(H/2), ceil(W/2), COUT) when POOL
  using S = TcConv<COUT>;
  constexpr int NCH = CIN / kTcChunk, NJ = COUT / 8;
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
    const int gy = reflect1(min(ty0 + p / kTcHaloW - 1, H), H);
    const int gx = reflect1(min(tx0 + p % kTcHaloW - 1, W), W);
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
                   xn + static_cast<size_t>(src[i]) * CIN + c * kTcChunk + 4 * half);
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
    const float4* ws = reinterpret_cast<const float4*>(base);
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
        if (X0 / 2 < PW)
          *reinterpret_cast<float2*>(yp + static_cast<size_t>(X0 / 2) * COUT + co) =
              make_float2(m[0], m[1]);
        if (X1 / 2 < PW)
          *reinterpret_cast<float2*>(yp + static_cast<size_t>(X1 / 2) * COUT + co) =
              make_float2(m[2], m[3]);
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
          *reinterpret_cast<float2*>(yp + static_cast<size_t>(X0) * COUT + co) =
              make_float2(acc[mt][j][0], acc[mt][j][1]);
        if (X1 < W)
          *reinterpret_cast<float2*>(yp + static_cast<size_t>(X1) * COUT + co) =
              make_float2(acc[mt][j][2], acc[mt][j][3]);
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
upconv_tf32x3(const float* __restrict__ x, const float4* __restrict__ wup,
              const float* __restrict__ bias, float* __restrict__ y, int Hc,
              int Wc) {
  // x: (N, Hc, Wc, C) coarse; wup: (C/8, 16, C/8, 32) float4 (ops/codec.py
  // pack_up: chunk, tap-phase 8a + 4u + 2b + v, n8 tile, lane);
  // y: (N, 2Hc, 2Wc, C)
  static_assert(C == 64 || C == 128, "channels");
  constexpr int NCH = C / kTcChunk, NJ = C / 8;
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
  // (the edge pad; past a ragged edge it feeds no stored output)
  const int half = tid & 1, hp = tid >> 1;
  const bool copies = tid < 2 * kUpHalo;
  const int gy = min(max(i0 - 1 + hp / kTcHaloW, 0), Hc - 1);
  const int gx = min(max(j0 - 1 + hp % kTcHaloW, 0), Wc - 1);
  const float* src = xn + (static_cast<size_t>(gy) * Wc + gx) * C + 4 * half;
  const int dst = hp * kTcChunk + 4 * (half ^ ((hp >> 2) & 1));

  auto load_chunk = [&](int c, int stage) {
    float* base = sm + stage * kUpStage;
    const float4* wsrc = wup + static_cast<size_t>(BOTH ? c : 2 * c + a) * kUpW4;
    float4* wdst = reinterpret_cast<float4*>(base);
    for (int i = tid; i < kUpW4; i += kThreads) cp_async16(wdst + i, wsrc + i);
    if (copies) cp_async16(base + 4 * kUpW4 + dst, src + c * kTcChunk);
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
    const float* base = sm + (c & 1) * kUpStage;
    const float4* ws = reinterpret_cast<const float4*>(base) + wa * 8 * NJ * 32;
    const float* xs = base + 4 * kUpW4;
    // the chunk's 12 products per output (4 taps x 3) sum into a fresh
    // partial, added to the total with one rounded FADD
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
        *reinterpret_cast<float2*>(yp + static_cast<size_t>(2 * J0 + b) * C + co) =
            make_float2(acc[b][j][0], acc[b][j][1]);
      if (J1 < Wc)
        *reinterpret_cast<float2*>(yp + static_cast<size_t>(2 * J1 + b) * C + co) =
            make_float2(acc[b][j][2], acc[b][j][3]);
    }
}

template <class Kernel>
int launch_dyn(Kernel kern, dim3 grid, int smem, void* stream, const float* x,
               const float* w, const float* b, float* y, int h, int wd) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, reinterpret_cast<const float4*>(w), b, y, h, wd);
  return static_cast<int>(cudaGetLastError());
}

template <int CIN, int COUT, bool RELU, bool POOL>
int launch_tc(const float* x, const float* wtc, const float* b, float* y, int n,
              int h, int wd, void* stream) {
  using S = TcConv<COUT>;
  const dim3 grid((wd + kTcCols - 1) / kTcCols, (h + S::kRows - 1) / S::kRows, n);
  return launch_dyn(conv3x3_tf32x3<CIN, COUT, RELU, POOL>, grid, S::kSmem,
                    stream, x, wtc, b, y, h, wd);
}

template <int CIN, int COUT>
int launch_tc_rp(const float* x, const float* wtc, const float* b, float* y,
                 int n, int h, int wd, int relu, int pool, void* stream) {
  if (relu && pool) return launch_tc<CIN, COUT, true, true>(x, wtc, b, y, n, h, wd, stream);
  if (relu) return launch_tc<CIN, COUT, true, false>(x, wtc, b, y, n, h, wd, stream);
  if (pool) return launch_tc<CIN, COUT, false, true>(x, wtc, b, y, n, h, wd, stream);
  return launch_tc<CIN, COUT, false, false>(x, wtc, b, y, n, h, wd, stream);
}

// the wide convs at 64 or 128 input channels, ReLU and pool chosen at run time
template <int COUT>
int launch_tc_conv(const float* x, const float* wtc, const float* b, float* y,
                   int n, int h, int wd, int cin, int relu, int pool,
                   void* stream) {
  if (n <= 0 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (cin == 64) return launch_tc_rp<64, COUT>(x, wtc, b, y, n, h, wd, relu, pool, stream);
  if (cin == 128) return launch_tc_rp<128, COUT>(x, wtc, b, y, n, h, wd, relu, pool, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int C>
int launch_up(const float* x, const float* wup, const float* b, float* y, int n,
              int hc, int wc, void* stream) {
  const int blocks_y = (hc + kUpRows - 1) / kUpRows * (C == 64 ? 1 : 2);
  const dim3 grid((wc + kTcCols - 1) / kTcCols, blocks_y, n);
  return launch_dyn(upconv_tf32x3<C>, grid, kUpSmem, stream, x, wup, b, y, hc, wc);
}

}  // namespace

extern "C" {

// (N, H, W, 3) -> relu(conv) (N, H, W, 64)
int optex_rgb_to_relu1(const float* x, const float* w, const float* b, float* y,
                       int n, int h, int wd, void* stream) {
  return launch<3, 64, 16, 64, 3, true>(x, w, b, y, n, h, wd, stream);
}

// (N, H, W, cin) -> (N, H, W, 64), or (N, ceil(H/2), ceil(W/2), 64) when
// pooled; wtc: the split weights in fragment order (ops/codec.py pack_tc)
int optex_conv3x3_p2(const float* x, const float* wtc, const float* b, float* y,
                     int n, int h, int wd, int cin, int relu, int pool,
                     void* stream) {
  return launch_tc_conv<64>(x, wtc, b, y, n, h, wd, cin, relu, pool, stream);
}

// (N, H, W, cin) -> (N, H, W, 128), or (N, ceil(H/2), ceil(W/2), 128) when
// pooled; wtc as for conv3x3_p2
int optex_conv3x3_full(const float* x, const float* wtc, const float* b, float* y,
                       int n, int h, int wd, int cin, int relu, int pool,
                       void* stream) {
  return launch_tc_conv<128>(x, wtc, b, y, n, h, wd, cin, relu, pool, stream);
}

// coarse (N, Hc, Wc, c) -> relu(conv(nearest_up_x2)) (N, 2Hc, 2Wc, c); wup:
// the folded per-phase taps, split, in fragment order (ops/codec.py pack_up)
int optex_upconv_p2(const float* x, const float* wup, const float* b, float* y,
                    int n, int hc, int wc, int c, void* stream) {
  if (n <= 0 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (c == 64) return launch_up<64>(x, wup, b, y, n, hc, wc, stream);
  if (c == 128) return launch_up<128>(x, wup, b, y, n, hc, wc, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// (N, H, W, 64) -> conv (N, H, W, 3), no ReLU (the renorm is folded into w, b)
int optex_final_to_rgb(const float* x, const float* w, const float* b, float* y,
                       int n, int h, int wd, void* stream) {
  return launch<64, 3, 32, 4, 8, false>(x, w, b, y, n, h, wd, stream);
}

const char* optex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
