// Codec convolution kernels for Hopper (sm_90a): the port of the five Pallas
// kernels in optimaltextures_tpu/ops/pallas/codec.py.
//
// All five compute the same operation: a 3x3 convolution with 1-px reflect
// padding and a bias, on NHWC float32 tensors, with an optional nearest-x2
// upsample in front (UP), and an optional ReLU and 2x2 max-pool (taken after
// the ReLU, ceil mode) behind (RELU, POOL). Two templates serve them:
//
//   rgb_to_relu1  conv3x3_reflect<3,   64,  16, 64, 3, RELU>
//   conv3x3_p2    conv3x3_reflect<64|128, 64,  16, 64, 8, RELU?, POOL?>
//   upconv_p2     conv3x3_reflect<C,   C,   16, 64, 8, RELU, UP>   C in {64, 128}
//   final_to_rgb  conv3x3_reflect<64,  3,   32, 4,  8>
//   conv3x3_full  conv3x3_tf32x3<64|128, RELU?, POOL?>   (tensor cores, below)
//
// conv3x3_reflect (a plain FFMA direct convolution):
// * A block computes a TILE x TILE patch of output pixels (at the conv's own
//   resolution) for CO_TILE output channels of one image. Thread t owns one
//   2x2 pixel quad and CPT consecutive output channels, so the fused max-pool
//   reduces in registers and each thread's stores are float4-wide.
// * Input channels stream through shared memory CI_CHUNK at a time: the
//   (TILE+2)^2 halo with the reflect indices resolved while loading (and, for
//   UP, the fine-to-coarse index halving: a fine-scale reflection of a
//   nearest-upsampled image reads the coarse image's edge pixel, so the 4x
//   upsampled tensor never exists in device memory), plus the weight slice
//   [tap][ci][co] for the block's output channels.
// * Each thread keeps its 4 x CPT accumulators in f32 registers; per input
//   channel it reads a 4x4 input window once and each weight float4 once
//   (broadcast across the warp, which shares the channel group).
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

template <int CIN, int COUT, int TILE, int CO_TILE, int CI_CHUNK, bool RELU,
          bool POOL, bool UP>
__global__ void __launch_bounds__(kThreads)
conv3x3_reflect(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y, int H,
                int W) {
  // H, W: the conv's resolution (the output's before pooling); the input is
  // (H/2, W/2) when UP. x: (N, IH, IW, CIN); w: (3, 3, CIN, COUT) HWIO.
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
  const int IH = UP ? H / 2 : H, IW = UP ? W / 2 : W;
  const float* xn = x + static_cast<size_t>(n) * IH * IW * CIN;

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
      int gy = min(ty0 + p / HS - 1, H), gx = min(tx0 + p % HS - 1, W);
      gy = reflect1(gy, H);
      gx = reflect1(gx, W);
      if (UP) {
        gy >>= 1;
        gx >>= 1;
      }
      xs[ci * HS * HS + p] =
          __ldg(xn + (static_cast<size_t>(gy) * IW + gx) * CIN + c0 + ci);
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

  // epilogue: bias, ReLU, then the optional 2x2 max-pool
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

  if (POOL) {
    // ceil mode: at an odd H (W) the last window holds one row (column); the
    // quad's pixels past the image stay out of the max
    const int PH = (H + 1) / 2, PW = (W + 1) / 2;
    const int py = ty0 / 2 + qy, px = tx0 / 2 + qx;
    if (py >= PH || px >= PW) return;
    const bool row1 = 2 * py + 1 < H, col1 = 2 * px + 1 < W;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const float top = col1 ? fmaxf(acc[0][k], acc[1][k]) : acc[0][k];
      const float bot = col1 ? fmaxf(acc[2][k], acc[3][k]) : acc[2][k];
      acc[0][k] = row1 ? fmaxf(top, bot) : top;
    }
    float* yp = y + ((static_cast<size_t>(n) * PH + py) * PW + px) * COUT + cbase;
    if (COUT % 4 == 0) {
#pragma unroll
      for (int k4 = 0; k4 < CPT / 4; ++k4)
        reinterpret_cast<float4*>(yp)[k4] =
            make_float4(acc[0][4 * k4], acc[0][4 * k4 + 1], acc[0][4 * k4 + 2],
                        acc[0][4 * k4 + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < CPT; ++k)
        if (cbase + k < COUT) yp[k] = acc[0][k];
    }
    return;
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

template <int CIN, int COUT, int TILE, int CO_TILE, int CI_CHUNK, bool RELU,
          bool POOL, bool UP>
int launch(const float* x, const float* w, const float* b, float* y, int n,
           int h, int wd, void* stream) {
  constexpr int CO_TILES = (COUT + CO_TILE - 1) / CO_TILE;
  const dim3 grid((wd + TILE - 1) / TILE, (h + TILE - 1) / TILE, n * CO_TILES);
  conv3x3_reflect<CIN, COUT, TILE, CO_TILE, CI_CHUNK, RELU, POOL, UP>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, w, b, y, h,
                                                                 wd);
  return static_cast<int>(cudaGetLastError());
}

// the encoder/decoder convs at 64 or 128 input channels, ReLU and pool chosen
// at run time
template <int CIN, int COUT>
int launch_rp(const float* x, const float* w, const float* b, float* y, int n,
              int h, int wd, int relu, int pool, void* stream) {
  if (relu && pool)
    return launch<CIN, COUT, 16, 64, 8, true, true, false>(x, w, b, y, n, h, wd, stream);
  if (relu)
    return launch<CIN, COUT, 16, 64, 8, true, false, false>(x, w, b, y, n, h, wd, stream);
  if (pool)
    return launch<CIN, COUT, 16, 64, 8, false, true, false>(x, w, b, y, n, h, wd, stream);
  return launch<CIN, COUT, 16, 64, 8, false, false, false>(x, w, b, y, n, h, wd, stream);
}

// ---------------------------------------------------------------------------
// conv3x3_full on the tensor cores: conv3x3_tf32x3<CIN, RELU, POOL>.
//
// Replaces ops/pallas/codec.py:376 conv3x3_full (body _conv_full_kernel :340):
// Cin in {64, 128} -> 128 channels. What bounds it on the H100: operations
// (2 * 9 * Cin multiply-adds per output value against 8 bytes of pixel
// traffic). The FFMA template above reaches ~41% of the 67 TF/s FP32 rate;
// this one runs on the tensor cores, which take TF32 (10 explicit mantissa
// bits) and so cannot hold the 2e-5 relative bound in one product. Each
// operand is split into a TF32 "hi" part and a TF32 "lo" remainder
// (cvt.rna.tf32.f32 on x and on x - hi) and three products are summed in
// f32 accumulators, hi*hi + hi*lo + lo*hi; the dropped lo*lo term is ~2^-22
// relative. Its least time is the 3xTF32 work at the 495 TF/s TF32 rate.
//
// Design, an implicit GEMM on mma.sync.m16n8k8 (M = output pixels, N = 128
// output channels, K = 9 taps x Cin):
// * A block computes 8 rows x 16 columns of output pixels for all 128
//   channels. Warp w owns rows 2(w%4) and 2(w%4)+1 (one m16 tile each: the
//   tile's row m is column m of the image row) and channels 64(w/4)..+63
//   (8 n8 tiles): 64 f32 accumulators a thread.
// * Input channels stream through shared memory 8 at a time (one k8 step),
//   double-buffered with 16-byte cp.async so the next chunk loads while this
//   one multiplies: the reflect-padded 10 x 18 halo (reflect indices
//   resolved once per pixel, not per element; ci is contiguous in NHWC) and
//   the chunk's weights for all 9 taps. A halo pixel's two 16-byte halves
//   swap places when bit 2 of its index is set, so the A-fragment loads of a
//   warp (8 consecutive pixels x 4 channels) hit 32 distinct banks.
// * A fragments are read from the halo at each tap's offset (the implicit
//   im2col; a shifted 2-D window is why this is mma.sync and not wgmma) and
//   split in registers. The weights are split once at pack time
//   (ops/codec.py pack_tc) and stored in fragment order, so a lane's
//   {hi(k), hi(k+4), lo(k), lo(k+4)} for an n8 tile is one 16-byte load.
// * The tensor cores' f32 accumulate rounds toward zero: chained through
//   all 9 x Cin / 8 x 3 products it biased outputs by ~1e-5 relative. So
//   each chunk's 27 products sum in a fresh partial that one rounded FADD
//   adds to the total (bias ~5e-7; 255 registers, no spills).
// * Epilogue: bias, ReLU, then the ceil-mode 2x2 pool in registers: a
//   thread holds both rows of a window (its two m16 tiles), and the
//   horizontal neighbour is lane ^ 4, one shuffle away. Pixels past the
//   image enter the max as -inf.
// 158,976 bytes of dynamic shared memory: one block (8 warps) per SM.

constexpr int kTcRows = 8;                          // output rows per block
constexpr int kTcCols = 16;                         // output columns per block
constexpr int kTcHaloW = kTcCols + 2;
constexpr int kTcHalo = (kTcRows + 2) * kTcHaloW;   // 180 halo pixels
constexpr int kTcChunk = 8;                         // input channels per stage
constexpr int kTcW4 = 9 * 16 * 32;                  // float4s of weights per stage
constexpr int kTcStageFloats = 4 * kTcW4 + kTcHalo * kTcChunk;
constexpr int kTcSmemBytes = 2 * kTcStageFloats * 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
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

// word of channel k (0..7) of halo pixel p
__device__ __forceinline__ int halo_slot(int p, int k) {
  return p * kTcChunk + (k ^ (((p >> 2) & 1) << 2));
}

template <int CIN, bool RELU, bool POOL>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_tf32x3(const float* __restrict__ x, const float4* __restrict__ wtc,
               const float* __restrict__ bias, float* __restrict__ y, int H,
               int W) {
  // x: (N, H, W, CIN); wtc: (CIN/8, 9, 16, 32) float4 (ops/codec.py pack_tc);
  // y: (N, H, W, 128), or (N, ceil(H/2), ceil(W/2), 128) when POOL
  constexpr int NCH = CIN / kTcChunk;
  constexpr int COUT = 128;
  extern __shared__ float4 tc_smem[];
  float* sm = reinterpret_cast<float*>(tc_smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rp = warp & 3, nh = warp >> 2;
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * kTcRows, tx0 = blockIdx.x * kTcCols;
  const float* xn = x + static_cast<size_t>(n) * H * W * CIN;

  // each thread copies halo halves tid and tid + 256 (of 2 x 180); the
  // source pixel is resolved once. Rows/cols past the image (a ragged last
  // tile) feed no stored output: clamp them to stay in bounds.
  size_t src[2];
  int dst[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int item = tid + i * kThreads;
    const int p = item >> 1, half = item & 1;
    int gy = min(ty0 + p / kTcHaloW - 1, H), gx = min(tx0 + p % kTcHaloW - 1, W);
    gy = reflect1(gy, H);
    gx = reflect1(gx, W);
    src[i] = (static_cast<size_t>(gy) * W + gx) * CIN + 4 * half;
    dst[i] = item < 2 * kTcHalo ? p * kTcChunk + 4 * (half ^ ((p >> 2) & 1)) : -1;
  }

  auto load_chunk = [&](int c, int stage) {
    float* base = sm + stage * kTcStageFloats;
    const float4* wsrc = wtc + static_cast<size_t>(c) * kTcW4;
    float4* wdst = reinterpret_cast<float4*>(base);
    for (int i = tid; i < kTcW4; i += kThreads) cp_async16(wdst + i, wsrc + i);
    float* xs = base + 4 * kTcW4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (dst[i] >= 0) cp_async16(xs + dst[i], xn + src[i] + c * kTcChunk);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
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
    if (c + 1 < NCH) {
      load_chunk(c + 1, (c + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* base = sm + (c & 1) * kTcStageFloats;
    const float4* ws = reinterpret_cast<const float4*>(base);
    const float* xs = base + 4 * kTcW4;
    // the chunk's 27 products per output sum into a fresh partial, added to
    // the total with one rounded FADD: the tensor cores' own accumulate
    // rounds toward zero, and a chain of all 9 Cin / 8 x 3 adds drifts
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
      for (int mt = 0; mt < 2; ++mt) {
        const int p0 = (2 * rp + mt + r) * kTcHaloW + g + s;   // pixel of row g
        const float a[4] = {xs[halo_slot(p0, t4)], xs[halo_slot(p0 + 8, t4)],
                            xs[halo_slot(p0, t4 + 4)], xs[halo_slot(p0 + 8, t4 + 4)]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ahi[mt][e] = to_tf32(a[e]);
          alo[mt][e] = to_tf32(a[e] - __uint_as_float(ahi[mt][e]));
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = ws[(tap * 16 + nh * 8 + j) * 32 + lane];
        const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
        const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(part[mt][j], alo[mt], bh0, bh1);   // small terms first
          mma_tf32(part[mt][j], ahi[mt], bl0, bl1);
          mma_tf32(part[mt][j], ahi[mt], bh0, bh1);
        }
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
    return;
  }
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

template <int CIN, bool RELU, bool POOL>
int launch_tc(const float* x, const float* wtc, const float* b, float* y, int n,
              int h, int wd, void* stream) {
  auto kern = conv3x3_tf32x3<CIN, RELU, POOL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((wd + kTcCols - 1) / kTcCols, (h + kTcRows - 1) / kTcRows, n);
  kern<<<grid, kThreads, kTcSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, reinterpret_cast<const float4*>(wtc), b, y, h, wd);
  return static_cast<int>(cudaGetLastError());
}

template <int CIN>
int launch_tc_rp(const float* x, const float* wtc, const float* b, float* y,
                 int n, int h, int wd, int relu, int pool, void* stream) {
  if (relu && pool) return launch_tc<CIN, true, true>(x, wtc, b, y, n, h, wd, stream);
  if (relu) return launch_tc<CIN, true, false>(x, wtc, b, y, n, h, wd, stream);
  if (pool) return launch_tc<CIN, false, true>(x, wtc, b, y, n, h, wd, stream);
  return launch_tc<CIN, false, false>(x, wtc, b, y, n, h, wd, stream);
}

}  // namespace

extern "C" {

// (N, H, W, 3) -> relu(conv) (N, H, W, 64)
int optex_rgb_to_relu1(const float* x, const float* w, const float* b, float* y,
                       int n, int h, int wd, void* stream) {
  return launch<3, 64, 16, 64, 3, true, false, false>(x, w, b, y, n, h, wd, stream);
}

// (N, H, W, cin) -> (N, H, W, 64), or (N, ceil(H/2), ceil(W/2), 64) when pooled
int optex_conv3x3_p2(const float* x, const float* w, const float* b, float* y,
                     int n, int h, int wd, int cin, int relu, int pool,
                     void* stream) {
  if (cin == 64) return launch_rp<64, 64>(x, w, b, y, n, h, wd, relu, pool, stream);
  if (cin == 128) return launch_rp<128, 64>(x, w, b, y, n, h, wd, relu, pool, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// (N, H, W, cin) -> (N, H, W, 128), or (N, ceil(H/2), ceil(W/2), 128) when
// pooled; wtc: the split weights in fragment order (ops/codec.py pack_tc)
int optex_conv3x3_full(const float* x, const float* wtc, const float* b, float* y,
                       int n, int h, int wd, int cin, int relu, int pool,
                       void* stream) {
  if (n <= 0 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (cin == 64) return launch_tc_rp<64>(x, wtc, b, y, n, h, wd, relu, pool, stream);
  if (cin == 128) return launch_tc_rp<128>(x, wtc, b, y, n, h, wd, relu, pool, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// coarse (N, Hc, Wc, c) -> relu(conv(nearest_up_x2)) (N, 2Hc, 2Wc, c)
int optex_upconv_p2(const float* x, const float* w, const float* b, float* y,
                    int n, int hc, int wc, int c, void* stream) {
  if (c == 64)
    return launch<64, 64, 16, 64, 8, true, false, true>(x, w, b, y, n, 2 * hc, 2 * wc, stream);
  if (c == 128)
    return launch<128, 128, 16, 64, 8, true, false, true>(x, w, b, y, n, 2 * hc, 2 * wc, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// (N, H, W, 64) -> conv (N, H, W, 3), no ReLU (the renorm is folded into w, b)
int optex_final_to_rgb(const float* x, const float* w, const float* b, float* y,
                       int n, int h, int wd, void* stream) {
  return launch<64, 3, 32, 4, 8, false, false, false>(x, w, b, y, n, h, wd, stream);
}

const char* optex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
