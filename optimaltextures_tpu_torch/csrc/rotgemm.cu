// The two rotation products of every cdf/sort sliced-OT step, on the tensor
// cores in 3xTF32, for Hopper (sm_90a):
//
//   rot_gemm_fwd<NB>   rows (C, N) = R^T X^T from the samples X (N, C), with
//                      the exact minimum and maximum of every row it wrote
//   rot_gemm_back<NB>  Y (N, C) = M^T R^T from the matched rows M (C, N)
//   rot_gemm_range     the per-block row ranges of rot_gemm_fwd combined
//
// They replace no Pallas kernel: the JAX package leaves both products to
// XLA at precision=HIGHEST (optimaltextures_tpu/transport.py), and cuBLAS
// ran them as f32 FFMA GEMMs at ~39% of the FP32 rate. What bounds them on
// the H100: the clouds are tall and skinny (N up to 2^25 samples, C the PCA
// width: 24 at relu1, 174 at relu3), so each product reads the cloud once
// and writes it once, 8C bytes a sample against 2C^2 FLOPs. That is bytes
// at relu1 and relu2, and near balance at relu3 once three TF32 products
// stand for one f32 product (C = 174, 2^21 samples: 0.87 ms of bytes
// against 0.77 ms of 3xTF32 work at 495 TF/s). So the design streams the
// cloud through shared memory once, keeps the rotation resident, and spends
// the tensor cores' margin on precision:
//
// * The products are f32-accurate: each operand is split into a TF32 "hi"
//   part (rounded to nearest, ties away, cvt.rna.tf32.f32's rounding) and
//   the exact remainder "lo" = x - hi, whose leading TF32 bits the tensor
//   cores read, and hi*hi + hi*lo + lo*hi is summed; the dropped lo*lo term
//   is ~2^-22 relative. The tensor cores' f32 accumulate rounds toward zero,
//   so every two 8-deep k-steps sum their six products (the small ones
//   first) in a fresh partial that one rounded FADD adds to the total: the
//   truncations never see the total.
// * wgmma, A from registers, B from shared memory. M = 64 samples a
//   warpgroup (the cloud), two warpgroups a block; N = NB output channels
//   (the rotation: a slice of NB of them a block, NB a template argument,
//   8 to 96); K = input channels in steps of 8. mma.sync was tried first:
//   on the H100 its TF32 rate is ~0.65 of wgmma's, and the loads and splits
//   around it did not overlap it (relu3 at 25% of its bound, relu1 and
//   relu2 as now). wgmma runs asynchronously: for NB < 96 a round's six
//   products are in flight while the last round's partial is added (two
//   partials; at NB 96 one, to stay within 255 registers).
// * The rotation slice stays resident, split once a launch into hi and lo
//   planes in wgmma's unswizzled K-major layout: a core matrix is 8 output
//   channels x 4 k (128 contiguous bytes), the 8-channel groups 128 bytes
//   apart, the 4-k groups NB / 8 x 128 bytes apart. At relu3 (C = 174 to
//   179) two slices of 88 or 96 channels, 124-141 KB a block; whole planes
//   would be 248 KB, over a block's 227 KB.
// * The cloud streams through a ring of 2-4 stages of 128 samples x (up to
//   64 channels) fed by cp.async, 16 bytes a copy where the rows allow it
//   (C or N a multiple of 4), else 8 or 4 (an odd C's rows are only 4-byte
//   aligned; 16-byte copies of shifted rows cost more in the A loads than
//   they saved), with the padding past C and N zero-filled by the copy
//   itself. Blocks are persistent: a block walks its slice's tiles, the
//   slices of one tile run on neighbouring blocks (L2 serves the second
//   read), and the next stages load while this one multiplies. Each thread
//   loads its A fragment with two 8-byte loads and splits it: the
//   fragment's rows g and g + 8 are the samples 2g and 2g + 1 of the warp's
//   16, and in the forward product its k = t, t + 4 are the stage's columns
//   2t, 2t + 1 (the rotation's planes hold their k in the same order).
//   Stage rows are padded so these loads are conflict-free (forward sample
//   rows at 4 mod 8 floats, back channel rows at 8 mod 16).
// * The accumulators hold two neighbouring samples of each channel. The
//   back product stores a sample's two channels together along C (8 bytes
//   where C is even). The forward product transposes its tile through
//   shared memory (half the channels at a time at NB 96) and stores each
//   channel's samples along N, 16 bytes a lane, keeping each lane's running
//   min and max of what it stored (NaN if any value was); lanes, then
//   warpgroups, then blocks reduce them, the last step in rot_gemm_range
//   over the blocks' partials, on the same stream with no sync. min and max
//   are exact in any order, so the ranges equal torch.aminmax of the rows
//   bit for bit.
// * Where the time goes at relu3 (a clock64 profile of the kernel): the
//   chunk barrier with the copies ~46% and the A loads ~26%, the wgmma
//   wait 2%: the two slices each read the whole cloud, and the TF32 B
//   operand's shared-memory reads (64 B a clock a wgmma, three products a
//   k-step) crowd the loads. Also tried and slower: a 2-block cluster
//   sharing the cloud through distributed shared memory, rings of up to 8
//   stages, direct 8-byte stores in place of the transposed tile.
//
// The tiling (NB and the slices, wg, the K chunk, the stages, the grid)
// comes from the caller (ops/rotgemm.py plan(), adapted to the observed C
// and N); the entry point checks it and returns cudaErrorInvalidValue for
// one it cannot run. Every C from 1 to 512 and every N from 1 runs.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxC = 512;
constexpr int kSmemLimit = 232448;   // a block's dynamic shared memory on the H100

struct Args {
  const float* src;   // forward: x (N, C); back: rows (C, N)
  const float* rot;   // (C, C)
  float* dst;         // forward: rows (C, N); back: y (N, C)
  float* part;        // forward: (grid, 2, C) per-block row ranges
  int c, n;
  int kp;             // C rounded up to 8: the K extent
  int wg;             // warpgroups a block (64 samples each)
  int kc;             // K chunk of a stage (a multiple of 8)
  int stages;         // 2..4
  int slices;         // channel slices of NB: block b takes slice b % slices
  int ss;             // a stage's row stride: forward kc + 4, back 64 wg + 8
  int stage_floats;
  int vec;            // floats a cp.async: 1, 2 or 4
  int vec_store;      // forward: 16-byte row stores (N % 4 == 0); back: 8-byte (C even)
  int ostage;         // back, one slice: the tile staged in shared memory, then 16-byte stores
};

// v = hi + lo: hi is v rounded to TF32, to nearest with ties away from zero
// (cvt.rna.tf32.f32's rounding, as two integer operations: cvt.rna expands
// to six on sm_90, with an Inf check this split leaves out); lo = v - hi is
// exact, and the tensor cores read its leading TF32 bits
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// the unswizzled K-major wgmma descriptor (layout type 0): lbo the stride
// between 4-k core matrices, sbo between 8-row groups
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
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x NB f32) = [d +] A (64 x 8, registers) * B (8 x NB, K-major)
template <int NB>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NB / 2], const uint32_t (&a)[4],
                                           uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<24>(float (&d)[12], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<48>(float (&d)[24], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<88>(float (&d)[44], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43}, {%44, %45, %46, %47}, %48, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<96>(float (&d)[48], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// V floats from src to dst, or V zeros when !ok (src is then not read)
template <int V>
__device__ __forceinline__ void cp_async_z(float* dst, const float* src, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = ok ? 4 * V : 0;
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                 "n"(4 * V), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` groups are in flight (stages - 2)
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A (outer x inner) block of src (row stride sstride) into dst (row stride
// dstride) in V-float copies; copies at o >= outer_ok or i >= inner_ok write
// zeros. A row of W = inner / V copies takes 32 / W rows a warp at a time
// (W <= 32) or one row a warp in steps of 32 copies, so the lanes of an
// instruction copy consecutive addresses with no division in the loop.
template <int V>
__device__ __forceinline__ void copy_block(float* dst, int dstride, const float* src,
                                           long long sstride, int outer, int inner,
                                           int outer_ok, int inner_ok) {
  const int W = inner / V, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  if (W <= 32) {
    const int rpw = 32 / W, lr = lane / W, w = lane - lr * W;   // rows a warp, this lane's
    if (lr >= rpw) return;
    const bool col_ok = w * V < inner_ok;
    for (int o = warp * rpw + lr; o < outer; o += warps * rpw) {
      const bool ok = col_ok && o < outer_ok;
      cp_async_z<V>(dst + o * dstride + w * V, ok ? src + o * sstride + w * V : src, ok);
    }
  } else {
    for (int o = warp; o < outer; o += warps)
      for (int w = lane; w < W; w += 32) {
        const bool ok = o < outer_ok && w * V < inner_ok;
        cp_async_z<V>(dst + o * dstride + w * V, ok ? src + o * sstride + w * V : src, ok);
      }
  }
}

// NaN-propagating min and max (torch.aminmax's)
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// a thread's A fragment of k-step ks (rows g, g + 8: samples 2g, 2g + 1 of
// the warp's 16, stage row nw on), split; zero past the chunk's k-steps
template <bool FWD>
__device__ __forceinline__ void load_a(const float* xs, int ss, int ks, int ksteps, int nw,
                                       int g, int tig, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  if (ks < ksteps) {
    if (FWD) {   // stage [sample][k]; k = tig, tig + 4 are columns 2 tig, 2 tig + 1
      const float* r = xs + (nw + 2 * g) * ss + 8 * ks + 2 * tig;
      const float2 v0 = *reinterpret_cast<const float2*>(r);
      const float2 v1 = *reinterpret_cast<const float2*>(r + ss);
      a[0] = v0.x;
      a[1] = v1.x;
      a[2] = v0.y;
      a[3] = v1.y;
    } else {     // stage [k][sample]
      const float* r = xs + (8 * ks + tig) * ss + nw + 2 * g;
      const float2 v0 = *reinterpret_cast<const float2*>(r);
      const float2 v1 = *reinterpret_cast<const float2*>(r + 4 * ss);
      a[0] = v0.x;
      a[1] = v0.y;
      a[2] = v1.x;
      a[3] = v1.y;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) split(a[e], hi[e], lo[e]);
}

template <bool FWD, int NB>
__device__ __forceinline__ void rot_gemm_body(const Args& p) {
  constexpr int R = NB / 2;   // accumulators a thread
  // NB 96: one partial (no round in flight while the last is added) and the
  // forward tile transposed half its channels at a time, to keep within 255
  // registers and leave shared memory for a ring of 32-channel chunks
  constexpr bool kPipe = NB < 96;
  constexpr int TH = NB < 96 ? 1 : 2;
  extern __shared__ float4 rot_gemm_smem[];
  float* sm = reinterpret_cast<float*>(rot_gemm_smem);
  const int plane = NB * p.kp;
  float* bh = sm;                                   // hi plane
  float* bl = sm + plane;                           // lo plane
  float* ring = bl + plane;                         // stages x stage_floats
  const int tp = 64 * p.wg + 4;                     // forward: the tile, transposed,
  float* tbuf = ring + p.stages * p.stage_floats;   // NB / TH x tp,
  float* slot = tbuf + NB / TH * tp;                // and the ranges, 2 x wg x NB

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int T = blockDim.x;
  const int slice = blockIdx.x % p.slices;
  const int m0 = slice * NB;           // the slice's first output channel
  const int nt = 64 * p.wg;            // samples a tile
  const int nw = 16 * warp;            // the warp's first sample in a tile
  const int ntiles = (p.n + nt - 1) / nt;
  const int tile0 = blockIdx.x / p.slices, tstep = gridDim.x / p.slices;
  const int my_tiles = tile0 < ntiles ? (ntiles - 1 - tile0) / tstep + 1 : 0;
  const int nchunks = (p.kp + p.kc - 1) / p.kc;
  const int items = my_tiles * nchunks;

  // the slice's rotation, split into the hi and lo planes: B[k][r] is R[k][j]
  // (forward; its k in the A fragments' order) or R[j][k] (back), j = m0 + r;
  // zero past C
#pragma unroll 8
  for (int i = tid; i < plane; i += T) {   // unrolled: eight loads in flight
    // read along R's rows: j fastest (forward), k fastest (back)
    const int r = FWD ? i % NB : i / p.kp, k = FWD ? i / NB : i % p.kp;
    const int kk = FWD ? ((k & ~7) | ((k & 3) << 1) | ((k >> 2) & 1)) : k;
    const int j = m0 + r;
    float v = 0.f;
    if (j < p.c && kk < p.c) v = FWD ? p.rot[kk * p.c + j] : p.rot[j * p.c + kk];
    uint32_t h, l;
    split(v, h, l);
    const int off = ((k >> 2) * (NB / 8) + (r >> 3)) * 32 + (r & 7) * 4 + (k & 3);
    bh[off] = __uint_as_float(h);
    bl[off] = __uint_as_float(l);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // planes -> wgmma
  const uint32_t bh_addr = static_cast<uint32_t>(__cvta_generic_to_shared(bh));
  const uint32_t bl_addr = static_cast<uint32_t>(__cvta_generic_to_shared(bl));
  const uint32_t lbo = (NB / 8) * 128;   // bytes between 4-k core matrices

  auto load_item = [&](int q, int stage) {
    const int t = tile0 + (q / nchunks) * tstep;
    const int k0 = (q % nchunks) * p.kc;
    const int kw = min(p.kc, p.kp - k0);
    const int n0 = t * nt;
    float* d = ring + stage * p.stage_floats;
    if (FWD) {   // samples x channels: rows n of x, k0 .. k0 + kw
      const float* s = p.src + static_cast<long long>(n0) * p.c + k0;
      if (p.vec == 4)
        copy_block<4>(d, p.ss, s, p.c, nt, kw, p.n - n0, p.c - k0);
      else if (p.vec == 2)
        copy_block<2>(d, p.ss, s, p.c, nt, kw, p.n - n0, p.c - k0);
      else
        copy_block<1>(d, p.ss, s, p.c, nt, kw, p.n - n0, p.c - k0);
    } else {     // channels x samples: rows k0 .. k0 + kw of M, samples n0 ..
      const float* s = p.src + static_cast<long long>(k0) * p.n + n0;
      if (p.vec == 4)
        copy_block<4>(d, p.ss, s, p.n, kw, nt, p.c - k0, p.n - n0);
      else if (p.vec == 2)
        copy_block<2>(d, p.ss, s, p.n, kw, nt, p.c - k0, p.n - n0);
      else
        copy_block<1>(d, p.ss, s, p.n, kw, nt, p.c - k0, p.n - n0);
    }
  };

  float acc[R], pt0[R], pt1[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = pt0[i] = pt1[i] = 0.f;
  // forward: lane (warp, lane) of warpgroup wgi stores and ranges channels
  // rsub + 8k (k < NB / 8), samples 4 quad .. of the warpgroup's 64
  const int wgi = warp >> 2, quad = lane & 15, rsub = 2 * (warp & 3) + (lane >> 4);
  float rlo[NB / 8], rhi[NB / 8];
#pragma unroll
  for (int k = 0; k < NB / 8; ++k) {
    rlo[k] = INFINITY;
    rhi[k] = -INFINITY;
  }

  // the tile of item q is complete in acc: store it (and, forward, range it)
  auto epilogue = [&](int q) {
    // acc[4i + e] is channel m0 + 8i + 2 tig + (e & 1) of sample n0 + nw +
    // 2g + (e >> 1)
    const int n0 = (tile0 + (q / nchunks) * tstep) * nt;
    if (FWD) {
      // the warpgroup's 64 samples x NB channels, transposed through shared
      // memory (NB / TH channels at a time), then stored along N 16 bytes a
      // lane with their range
      const int sl = 64 * wgi + 4 * quad, s = n0 + sl;
      const bool full = n0 + nt <= p.n;
#pragma unroll
      for (int h = 0; h < TH; ++h) {
        if (h > 0) asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
#pragma unroll
        for (int i = h * NB / 8 / TH; i < (h + 1) * NB / 8 / TH; ++i)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2)
            *reinterpret_cast<float2*>(tbuf + (8 * i + 2 * tig + c2 - h * NB / TH) * tp + nw +
                                       2 * g) =
                make_float2(acc[4 * i + c2], acc[4 * i + 2 + c2]);
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
#pragma unroll
        for (int k = h * NB / 8 / TH; k < (h + 1) * NB / 8 / TH; ++k) {
          const int r = rsub + 8 * k, j = m0 + r;
          const float4 v =
              *reinterpret_cast<const float4*>(tbuf + (r - h * NB / TH) * tp + sl);
          float* row = p.dst + static_cast<long long>(j) * p.n + s;
          if (full && p.vec_store) {
            if (j < p.c) *reinterpret_cast<float4*>(row) = v;
            rlo[k] = nan_min(rlo[k], nan_min(nan_min(v.x, v.y), nan_min(v.z, v.w)));
            rhi[k] = nan_max(rhi[k], nan_max(nan_max(v.x, v.y), nan_max(v.z, v.w)));
          } else {
            const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (s + u < p.n) {
                if (j < p.c) row[u] = e[u];
                rlo[k] = nan_min(rlo[k], e[u]);
                rhi[k] = nan_max(rhi[k], e[u]);
              }
          }
        }
      }
    } else if (p.ostage) {
      // one slice: the warpgroup's 64 samples x C channels are contiguous
      // in y; staged in shared memory (tbuf, dense rows of C), they leave
      // in 16-byte stores whatever C's alignment (on the H100: C 76 at
      // 4.7M samples 1.55 ms staged, 2.30 direct; C 25 4.20 against 6.07
      // by 4-byte stores; C 24 3.96 and C 64 2.41 against 2.43 and 1.94 by
      // 8-byte ones)
      float* ot = tbuf + 64 * wgi * p.c;
#pragma unroll
      for (int i = 0; i < NB / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * i + 2 * tig + (e & 1);
          if (j < p.c) ot[(16 * (warp & 3) + 2 * g + (e >> 1)) * p.c + j] = acc[4 * i + e];
        }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
      const int rows = min(64, p.n - (n0 + 64 * wgi));
      const int total = rows > 0 ? rows * p.c : 0, tw = tid & 127;
      float* out = p.dst + static_cast<long long>(n0 + 64 * wgi) * p.c;
      for (int t = 4 * tw; t < (total & ~3); t += 512)
        *reinterpret_cast<float4*>(out + t) = *reinterpret_cast<const float4*>(ot + t);
      for (int t = (total & ~3) + tw; t < total; t += 128) out[t] = ot[t];
    } else {
      // rows 2g, 2g + 1 of the warp's 16 samples, two channels a store
      const int s = n0 + nw + 2 * g;
      const bool full = n0 + nt <= p.n && m0 + NB <= p.c && p.vec_store;
#pragma unroll
      for (int i = 0; i < NB / 8; ++i) {
        const int j = m0 + 8 * i + 2 * tig;
        float* out = p.dst + static_cast<long long>(s) * p.c + j;
        if (full) {
          *reinterpret_cast<float2*>(out) = make_float2(acc[4 * i], acc[4 * i + 1]);
          *reinterpret_cast<float2*>(out + p.c) = make_float2(acc[4 * i + 2], acc[4 * i + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j + (e & 1) < p.c && s + (e >> 1) < p.n)
              out[(e >> 1) * p.c + (e & 1)] = acc[4 * i + e];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
  };

  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < items) load_item(s, s);
    cp_async_commit();
  }
  // Rounds of two k-steps, pipelined: round r's six products go to the
  // fresh partial pt(r & 1) (the first one's scale-d 0, the small ones
  // first); once they are issued, round r - 1's are awaited and added to
  // acc, and when that was its tile's last round the tile's epilogue runs,
  // while round r's products are still in flight.
  int q = 0, ks = 0;          // the next round's item and first k-step
  int prev_q = -1;            // the item of the round in flight, if any
  bool prev_last = false;     // ... and whether it ends its tile
  auto round = [&](float (&pt)[R], float (&po)[R], uint32_t (&ah)[2][4],
                   uint32_t (&al)[2][4]) -> bool {
    if (q >= items) {
      wgmma_wait0();
      if (prev_q >= 0) {
        fence_acc(po);
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] += po[i];
        if (prev_last) epilogue(prev_q);
      }
      return false;
    }
    if (!kPipe && prev_q >= 0) {   // one partial: the last round first
      wgmma_wait0();
      fence_acc(po);
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] += po[i];
      if (prev_last) epilogue(prev_q);
      prev_q = -1;
    }
    const int chunk = q % nchunks;
    if (ks == 0) {
      cp_async_wait(p.stages - 2);
      __syncthreads();   // item q landed for every thread; stage (q - 1) is free
      const int qn = q + p.stages - 1;
      if (qn < items) load_item(qn, qn % p.stages);
      cp_async_commit();
    }
    const int k0 = chunk * p.kc;
    const int ksteps = min(p.kc, p.kp - k0) / 8;
    const float* xs = ring + (q % p.stages) * p.stage_floats;
    load_a<FWD>(xs, p.ss, ks, ksteps, nw, g, tig, ah[0], al[0]);
    load_a<FWD>(xs, p.ss, ks + 1, ksteps, nw, g, tig, ah[1], al[1]);
    const uint32_t k4 = static_cast<uint32_t>((k0 >> 2) + 2 * ks) * lbo;
    const uint32_t k4n = ks + 1 < ksteps ? k4 + 2 * lbo : k4;
    const uint64_t dh0 = desc_interleave(bh_addr + k4, lbo, 128);
    const uint64_t dl0 = desc_interleave(bl_addr + k4, lbo, 128);
    const uint64_t dh1 = desc_interleave(bh_addr + k4n, lbo, 128);
    const uint64_t dl1 = desc_interleave(bl_addr + k4n, lbo, 128);
    wgmma_fence();
    wgmma_tf32<NB>(pt, al[0], dh0, 0);
    wgmma_tf32<NB>(pt, ah[0], dl0, 1);
    wgmma_tf32<NB>(pt, al[1], dh1, 1);
    wgmma_tf32<NB>(pt, ah[1], dl1, 1);
    wgmma_tf32<NB>(pt, ah[0], dh0, 1);
    wgmma_tf32<NB>(pt, ah[1], dh1, 1);
    wgmma_commit();
    if (prev_q >= 0) {
      wgmma_wait1();
      fence_acc(po);
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] += po[i];
      if (prev_last) epilogue(prev_q);
    }
    prev_q = q;
    prev_last = ks + 2 >= ksteps && chunk == nchunks - 1;
    ks += 2;
    if (ks >= ksteps) {
      ks = 0;
      ++q;
    }
    return true;
  };
  uint32_t ah0[2][4], al0[2][4], ah1[2][4], al1[2][4];
  while (round(pt0, kPipe ? pt1 : pt0, ah0, al0) && round(kPipe ? pt1 : pt0, pt0, ah1, al1)) {
  }
  cp_async_wait(0);

  if (FWD) {
    // the block's range of each channel of its slice: the 16 lanes of a
    // channel, then the warpgroups, into part[block]
#pragma unroll
    for (int k = 0; k < NB / 8; ++k) {
      float lo = rlo[k], hi = rhi[k];
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      if (quad == 0) {
        slot[wgi * NB + rsub + 8 * k] = lo;
        slot[(p.wg + wgi) * NB + rsub + 8 * k] = hi;
      }
    }
    __syncthreads();
    for (int r = tid; r < NB; r += T) {
      const int j = m0 + r;
      if (j >= p.c) continue;
      float lo = INFINITY, hi = -INFINITY;
      for (int w = 0; w < p.wg; ++w) {
        lo = nan_min(lo, slot[w * NB + r]);
        hi = nan_max(hi, slot[(p.wg + w) * NB + r]);
      }
      p.part[(2LL * blockIdx.x) * p.c + j] = lo;
      p.part[(2LL * blockIdx.x + 1) * p.c + j] = hi;
    }
  }
}

// NB <= 32: two blocks an SM (the planner's choice there) need <= 128 registers
template <int NB>
__global__ void __launch_bounds__(256, NB <= 32 ? 2 : 1) rot_gemm_fwd(Args p) {
  rot_gemm_body<true, NB>(p);
}

template <int NB>
__global__ void __launch_bounds__(256, NB <= 32 ? 2 : 1) rot_gemm_back(Args p) {
  rot_gemm_body<false, NB>(p);
}

// lo[j], hi[j] over the partials of the blocks of channel j's slice
__global__ void rot_gemm_range(const float* __restrict__ part, float* __restrict__ lo,
                               float* __restrict__ hi, int c, int blocks, int slices,
                               int slice_rows) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= c) return;
  float l = INFINITY, u = -INFINITY;
  for (int b = j / slice_rows; b < blocks; b += slices) {
    l = nan_min(l, part[(2LL * b) * c + j]);
    u = nan_max(u, part[(2LL * b + 1) * c + j]);
  }
  lo[j] = l;
  hi[j] = u;
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

bool nb_supported(int nb) {
  switch (nb) {
    case 8: case 16: case 24: case 32: case 48: case 64: case 88: case 96:
      return true;
    default:
      return false;
  }
}

template <int NB>
cudaError_t launch(bool forward, const Args& p, int grid, int smem, cudaStream_t st) {
  // the shared-memory attribute is per device, so set at every launch
  cudaError_t err = cudaFuncSetAttribute(forward ? rot_gemm_fwd<NB> : rot_gemm_back<NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (forward)
    rot_gemm_fwd<NB><<<grid, 128 * p.wg, smem, st>>>(p);
  else
    rot_gemm_back<NB><<<grid, 128 * p.wg, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The dynamic shared memory of a tiling, or -1 if the tiling is not one
// the kernels take. ops/rotgemm.py smem_bytes() computes the same.
int optex_rot_gemm_smem(int forward, int c, int nb, int wg, int kc, int stages) {
  if (c < 1 || c > kMaxC || !nb_supported(nb) || wg < 1 || wg > 2 || kc < 8 || kc > 64 ||
      kc % 8 || stages < 2 || stages > 4)
    return -1;
  const int kp = round_up(c, 8), nt = 64 * wg;
  const int stage = forward ? nt * (kc + 4) : kc * (nt + 8);
  const int th = nb < 96 ? 1 : 2;   // the forward tile transposed in th parts
  const long long extra = forward ? nb / th * (nt + 4LL) + 2LL * wg * nb
                                  : ((c + nb - 1) / nb == 1 ? 1LL * nt * c : 0);   // back: the tile
  const long long bytes = 4LL * (2LL * nb * kp + static_cast<long long>(stages) * stage + extra);
  return bytes <= kSmemLimit ? static_cast<int>(bytes) : -1;
}

// forward: src x (N, C) -> dst rows (C, N), part (grid, 2, C) scratch, lo/hi
// (C,) the rows' ranges; back: src rows (C, N) -> dst y (N, C) (part, lo,
// hi unused). rot (C, C). dst must not overlap src. The grid is a multiple
// of the channel slices, ceil(C / nb).
int optex_rot_gemm(int forward, const float* src, const float* rot, float* dst, float* part,
                   float* lo, float* hi, int c, int n, int nb, int wg, int kc, int stages,
                   int grid, void* stream) {
  const int smem = optex_rot_gemm_smem(forward, c, nb, wg, kc, stages);
  if (smem < 0 || n < 1 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.src = src;
  p.rot = rot;
  p.dst = dst;
  p.part = part;
  p.c = c;
  p.n = n;
  p.kp = round_up(c, 8);
  p.wg = wg;
  p.kc = kc;
  p.stages = stages;
  p.slices = (c + nb - 1) / nb;
  const int nt = 64 * wg;
  p.ss = forward ? kc + 4 : nt + 8;
  p.stage_floats = forward ? nt * (kc + 4) : kc * (nt + 8);
  if (grid % p.slices) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t sp = reinterpret_cast<uintptr_t>(src);
  const int line = forward ? c : n;   // the copies run along src's rows
  p.vec = line % 4 == 0 && sp % 16 == 0 ? 4 : (line % 2 == 0 && sp % 8 == 0 ? 2 : 1);
  const uintptr_t dp = reinterpret_cast<uintptr_t>(dst);
  p.vec_store = forward ? n % 4 == 0 && dp % 16 == 0 : c % 2 == 0 && dp % 8 == 0;
  // staged stores pay where 8-byte ones cannot be made (odd C) or the
  // rows are long (NB >= 88: C 65 .. 96); shorter even rows store directly
  p.ostage = !forward && p.slices == 1 && dp % 16 == 0 && (!p.vec_store || nb >= 88);
  if (forward && (!part || !lo || !hi)) return static_cast<int>(cudaErrorInvalidValue);

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (nb) {
    case 8: err = launch<8>(forward, p, grid, smem, st); break;
    case 16: err = launch<16>(forward, p, grid, smem, st); break;
    case 24: err = launch<24>(forward, p, grid, smem, st); break;
    case 32: err = launch<32>(forward, p, grid, smem, st); break;
    case 48: err = launch<48>(forward, p, grid, smem, st); break;
    case 64: err = launch<64>(forward, p, grid, smem, st); break;
    case 88: err = launch<88>(forward, p, grid, smem, st); break;
    default: err = launch<96>(forward, p, grid, smem, st); break;
  }
  if (err != cudaSuccess || !forward) return static_cast<int>(err);
  rot_gemm_range<<<(c + 255) / 256, 256, 0, st>>>(part, lo, hi, c, grid, p.slices, nb);
  return static_cast<int>(cudaGetLastError());
}

const char* optex_rot_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
