// Codec convolution kernels for Hopper (sm_90a): the port of the five Pallas
// kernels in optimaltextures_tpu/ops/pallas/codec.py.
//
// All five compute the same operation: a 3x3 convolution with 1-px reflect
// padding and a bias, on NHWC float32 tensors, with an optional nearest-x2
// upsample in front (UP), and an optional ReLU and 2x2 max-pool (taken after
// the ReLU, ceil mode) behind (RELU, POOL). One template serves them all:
//
//   rgb_to_relu1  conv3x3_reflect<3,   64,  16, 64, 3, RELU>
//   conv3x3_p2    conv3x3_reflect<64|128, 64,  16, 64, 8, RELU?, POOL?>
//   conv3x3_full  conv3x3_reflect<64|128, 128, 16, 64, 8, RELU?, POOL?>
//   upconv_p2     conv3x3_reflect<C,   C,   16, 64, 8, RELU, UP>   C in {64, 128}
//   final_to_rgb  conv3x3_reflect<64,  3,   32, 4,  8>
//
// Design (a plain FFMA direct convolution; no wgmma or TMA yet):
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

#include <cstddef>

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

// (N, H, W, cin) -> (N, H, W, 128), or (N, ceil(H/2), ceil(W/2), 128) when pooled
int optex_conv3x3_full(const float* x, const float* w, const float* b, float* y,
                       int n, int h, int wd, int cin, int relu, int pool,
                       void* stream) {
  if (cin == 64) return launch_rp<64, 128>(x, w, b, y, n, h, wd, relu, pool, stream);
  if (cin == 128) return launch_rp<128, 128>(x, w, b, y, n, h, wd, relu, pool, stream);
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
