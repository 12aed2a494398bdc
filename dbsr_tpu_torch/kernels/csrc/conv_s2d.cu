// Exact fine-resolution 3x3 SAME convolution on the phase-major
// space-to-depth-2 ("s2d") layout, float32:
//   x   [B, H2, W2, 4C]  fine pixel (2Y+qy, 2X+qx), channel c, at
//                        x[b, Y, X, (qy*2 + qx)*C + c]
//   w   [C, 9, Op]       w[c, ky*3 + kx, o] = weight[o, c, ky, kx] (OIHW),
//                        zero for o >= O; Op is O rounded up to kOC
//   out [B, H2, W2, 4O]  the same layout:
//   out_fine[y, x, o] = sum_{ky, kx, c} w[c, ky*3+kx, o]
//                                       * x_fine[y+ky-1, x+kx-1, c],
// zero outside the fine 2H2 x 2W2 plane. The backward's d_input is the same
// function of the output gradient with weight.flip(2, 3).transpose(0, 1).
//
// Replaces the TPU kernel dbsr_tpu/ops/conv_s2d_pallas.py:
// _conv3x3_block_impl (body _conv_kernel), which assembled the fine 4x4
// window of each coarse pixel into a [16C] patch row and multiplied it by
// the [16C, 4O] block weight, 7/16 of whose entries are zeros. The TPU
// kernel needed halo'd row bands stacked in HBM first; this one reads the
// unpadded input directly and skips the zero slots: it does the true
// 9*C*O multiply-adds per fine output pixel.
//
// Bounds on the H100 at the DBSR decoder's serving launch (B=8, H2=W2=192,
// C=O=32: 2*8*384^2*9*32*32 = 21.7 GFLOP, 302 MB of input and output):
// on the float32 FMA units, 0.325 ms at 67 TFLOP/s; as 3xTF32 tensor-core
// math (three TF32 products per multiply-add), 0.132 ms at 495 TFLOP/s;
// the bytes, 0.090 ms at 3.35 TB/s.
//
// Design: an implicit GEMM on the tensor cores at float32 accuracy.
// out[p, o] = sum_k A[p, k] Wt[k, o] with p the fine output pixels of a
// 16x32 tile, k = (ky, kx, c) (K = 9C) and o the block's 32 output
// channels. A is never formed: it is the 18x34 halo'd fine input tile in
// shared memory, read at each tap's offset.
// - 3xTF32: each operand v splits into big = cvt.rna.tf32(v) and small =
//   cvt.rna.tf32(v - big); per 8 channels of one tap a warp issues
//   mma.sync.m16n8k8 (TF32 in, float32 accumulate) for small*big, then
//   big*small, then big*big. small*small (below 2^-22 of the product) is
//   the only term dropped, not TF32's ~1e-3. The weights are split once
//   per stage in shared memory, the input as it is read into fragments.
// - Accumulation: the tensor core adds into its float32 sums truncating
//   (toward zero), so 108 MMAs into one running sum would bias it by up to
//   an ulp of the sum each (~1.4e-5 of the largest output at K = 288, in
//   tests/test_torch_port_kernels.py's model, against ~3e-6 for FFMA).
//   Each 8-deep step's three MMAs therefore start from zero and the step is
//   added to the running sum by a rounded float32 add: the truncation
//   falls on a sum of 8 products, and the model's error is ~1e-6. That
//   costs 64 float32 adds a thread beside the 48 MMAs of a tap and stage.
// - Staging: 8 input channels per stage, double-buffered: while the warps
//   run the MMAs of one stage, cp.async copies the next stage's input tile
//   (16-byte chunks: one fine pixel's channels are contiguous in the s2d
//   layout; 4-byte copies when C is not a multiple of 4; zero-filled
//   outside the plane and past C) and its weights; after the MMAs the
//   threads split those weights into TF32 parts in shared memory. A stage
//   is 19.6 KB of input and 18.4 KB of split weights; with both buffers and
//   the 10.4 KB of raw weights a block takes 85 KB, so two 256-thread
//   blocks share an SM (the whole C=32 tile and weights would take ~115 KB
//   and one block per SM). No integer division in any loop: the tile's
//   coordinates come from blockIdx once, the staging walks the halo with a
//   carried row and column.
// - Fragments: the staged pixel holds its 8 channels in order and the MMA's
//   k index t <-> channel 2t, t+4 <-> 2t+1 (the weights staged to match),
//   so each A fragment is two 8-byte shared loads, on distinct banks; the
//   split weights are staged fragment-major, one 16-byte load per n-tile.
// - Warps: 8, each two output rows of the tile (four m16 tiles) by all 32
//   output channels (four n8 tiles): 64 float32 sums a thread, 48 MMAs per
//   tap and stage, at most 128 registers (two blocks per SM).
// - Epilogue: each pixel's output channel pairs as 8-byte stores (4-byte
//   for an odd O), masked at the ragged tile and the padded O.
// Single pass, no atomics: deterministic.
//
// bfloat16 (x, weights and out bf16, the TPU kernel's DEFAULT-precision bf16
// matmul with float32 accumulation, one rounding of the output): one
// mma.sync.m16n8k16 (bf16 in, float32 accumulate) per 16 channels of one
// tap and n8 tile, where float32 takes three m16n8k8 TF32 ones; the same
// tile, warps and epilogue. Bound at the serving launch: 151 MB of bf16
// input and output, 0.045 ms at 3.35 TB/s (the FLOPs take 0.022 at 989
// TFLOP/s). 16 input channels a stage (39 KB for both input buffers); the
// weights come in bf16 already in the fragments' order, [C/16][O/32][tap]
// [n8][lane][4] (the wrapper builds it from the bf16-rounded weight): a
// stage's weights are one contiguous 9 KB copy, and a lane's two B
// registers of an n8 tile one 8-byte shared load. The MMA's k index t <->
// channel 4(t/2) + t%2 for t < 8 and 4((t-8)/2) + 2 + t%2 above (A and B
// alike), so that each A register pair (k 2t, 2t+1 and 2t+8, 2t+9) is
// channels 4t..4t+3 of one pixel, one 8-byte load. Each (stage, tap) MMA
// starts from zero and is added to the running sums by a rounded add, as
// the float32 path does.
#include "common.cuh"

#include <climits>
#include <cstdint>

namespace {

constexpr int kTileH = 16;                  // fine output rows per block
constexpr int kTileW = 32;                  // fine output columns per block
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloPix = kHaloH * kHaloW;   // 612 staged pixels
constexpr int kCC = 8;                      // input channels per stage
constexpr int kOC = 32;                     // output channels per block
constexpr int kNT = kOC / 8;                // n8 tiles per warp
constexpr int kMT = 4;                      // m16 tiles per warp
constexpr int kWarpRows = kMT / 2;          // output rows per warp
constexpr int kWarps = kTileH / kWarpRows;
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 2;               // blocks per SM
constexpr int kInFloats = kHaloPix * kCC;   // one stage of input
constexpr int kWItems = 9 * kNT * 32;       // one float4 per (tap, n8, lane)
constexpr int kRawRow = kOC + 4;            // staged raw weight row, floats
constexpr int kRawFloats = kCC * 9 * kRawRow;
constexpr int kSmemBytes = (2 * kInFloats + 2 * 4 * kWItems + kRawFloats) * 4;

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small + (below 2^-22 |v|), big and small TF32
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(__fsub_rn(v, __uint_as_float(big)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b, from zero sums
__device__ __forceinline__ void mma_from_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// Copy channels c0..c0+7 of the 18x34 halo'd tile at fine (y0-1, x0-1)
// into s (pixel-major, 8 floats a pixel): kParts copies of 8/kParts
// channels per pixel, thread i taking part i % kParts of every
// (kThreads/kParts)-th pixel.
template <int kParts>
__device__ __forceinline__ void stage_input(float* s, const float* xb, int y0,
                                            int x0, int H, int W, int W2,
                                            int C, int c0) {
  constexpr int kWidth = kCC / kParts;         // channels per copy
  constexpr int kStride = kThreads / kParts;   // pixels between a thread's
  const int part = threadIdx.x % kParts;
  int p = threadIdx.x / kParts;
  int hy = p / kHaloW;
  int hx = p - hy * kHaloW;
  const int c = c0 + part * kWidth;
  const int src_bytes = max(0, min(kWidth, C - c)) * 4;
  for (; p < kHaloPix; p += kStride) {
    const int y = y0 - 1 + hy;
    const int xx = x0 - 1 + hx;
    const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
    const float* src = in
        ? xb + (static_cast<long long>(y >> 1) * W2 + (xx >> 1)) * 4 * C
              + ((y & 1) * 2 + (xx & 1)) * C + c
        : xb;
    cp_async<kWidth * 4>(s + p * kCC + part * kWidth, src,
                         in ? src_bytes : 0);
    hx += kStride % kHaloW;
    hy += kStride / kHaloW;
    if (hx >= kHaloW) {
      hx -= kHaloW;
      ++hy;
    }
  }
}

// Copy the weights of channels c0..c0+7 (zeros past C) for the block's 32
// output channels into raw: row cc*9 + tap, kRawRow floats a row.
__device__ __forceinline__ void stage_weights(float* raw, const float* w,
                                              int C, int Op, int oc0,
                                              int c0) {
  const int rows = min(kCC, C - c0) * 9;
  for (int i = threadIdx.x; i < kCC * 9 * (kOC / 4); i += kThreads) {
    const int row = i >> 3;
    const int j = (i & 7) * 4;
    const bool ok = row < rows;
    cp_async<16>(raw + row * kRawRow + j,
                 ok ? w + static_cast<long long>(c0 * 9 + row) * Op + oc0 + j
                    : w,
                 ok ? 16 : 0);
  }
}

// Split the staged raw weights into TF32 parts, fragment-major: item
// i = (tap*kNT + n8)*32 + lane holds big and small of weight(c0 + 2t, tap,
// n8*8 + g) and weight(c0 + 2t + 1, ...) for lane = g*4 + t.
__device__ __forceinline__ void split_weights(float4* s, const float* raw) {
  for (int i = threadIdx.x; i < kWItems; i += kThreads) {
    const int tap = i >> 7;
    const int o = ((i >> 5) & 3) * 8 + ((i >> 2) & 7);
    const int t = i & 3;
    uint32_t b0, s0, b1, s1;
    split(raw[(2 * t * 9 + tap) * kRawRow + o], b0, s0);
    split(raw[((2 * t + 1) * 9 + tap) * kRawRow + o], b1, s1);
    s[i] = make_float4(__uint_as_float(b0), __uint_as_float(b1),
                       __uint_as_float(s0), __uint_as_float(s1));
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
conv_s2d_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, int H2, int W2, int C, int O,
                int Op) {
  extern __shared__ __align__(16) float smem[];
  float* s_in = smem;                                           // [2][612][8]
  float4* s_w = reinterpret_cast<float4*>(smem + 2 * kInFloats);  // [2][1152]
  float* s_raw = smem + 2 * kInFloats + 2 * 4 * kWItems;         // [72][36]

  const int H = 2 * H2;
  const int W = 2 * W2;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tile_y = blockIdx.x / tiles_x;
  const int y0 = tile_y * kTileH;
  const int x0 = (blockIdx.x - tile_y * tiles_x) * kTileW;
  const int oc0 = blockIdx.y * kOC;
  const long long b = blockIdx.z;
  const float* xb = x + b * H2 * W2 * 4 * C;
  float* ob = out + b * H2 * W2 * 4 * O;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool vec_in = (C & 3) == 0;
  const int stages = (C + kCC - 1) / kCC;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[m][n][k] = 0.0f;

  if (vec_in)
    stage_input<2>(s_in, xb, y0, x0, H, W, W2, C, 0);
  else
    stage_input<8>(s_in, xb, y0, x0, H, W, W2, C, 0);
  stage_weights(s_raw, w, C, Op, oc0, 0);
  cp_async_commit();
  cp_async_wait();
  __syncthreads();
  split_weights(s_w, s_raw);

  for (int st = 0; st < stages; ++st) {
    const int cur = st & 1;
    const bool more = st + 1 < stages;
    // this stage's split weights are in place; the other buffers and the
    // raw weights are free
    __syncthreads();
    if (more) {
      float* next = s_in + (cur ^ 1) * kInFloats;
      if (vec_in)
        stage_input<2>(next, xb, y0, x0, H, W, W2, C, (st + 1) * kCC);
      else
        stage_input<8>(next, xb, y0, x0, H, W, W2, C, (st + 1) * kCC);
      stage_weights(s_raw, w, C, Op, oc0, (st + 1) * kCC);
      cp_async_commit();
    }

    const float* in = s_in + cur * kInFloats;
    const float4* ws = s_w + cur * kWItems;
    // three taps (one kernel row) unrolled at a time: the nine unrolled
    // spill at the 128 registers that two blocks per SM leave a thread
#pragma unroll 3
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3;
      const int kx = tap - ky * 3;
      uint32_t bb[kNT][2], bs[kNT][2];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float4 v = ws[(tap * kNT + n) * 32 + lane];
        bb[n][0] = __float_as_uint(v.x);
        bb[n][1] = __float_as_uint(v.y);
        bs[n][0] = __float_as_uint(v.z);
        bs[n][1] = __float_as_uint(v.w);
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        // m16 tile m: output row warp*kWarpRows + m/2, columns (m%2)*16 +
        // 0..15; lane rows g and g+8, channels 2t and 2t+1
        const float* r = in + ((warp * kWarpRows + (m >> 1) + ky) * kHaloW
                               + (m & 1) * 16 + g + kx) * kCC + 2 * t;
        const float2 lo = *reinterpret_cast<const float2*>(r);
        const float2 hi = *reinterpret_cast<const float2*>(r + 8 * kCC);
        uint32_t ab[4], as[4];
        split(lo.x, ab[0], as[0]);
        split(hi.x, ab[1], as[1]);
        split(lo.y, ab[2], as[2]);
        split(hi.y, ab[3], as[3]);
        // this step's 8-deep sums from zero, then added to the running
        // sums by a rounded float32 add (see the note at the top)
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          float step[4];
          mma_from_zero(step, as, bb[n][0], bb[n][1]);
          mma(step, ab, bs[n][0], bs[n][1]);
          mma(step, ab, bb[n][0], bb[n][1]);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[m][n][k] = __fadd_rn(acc[m][n][k], step[k]);
        }
      }
    }

    if (more) {
      cp_async_wait();
      __syncthreads();  // the next stage's input and raw weights are in
      split_weights(s_w + (cur ^ 1) * kWItems, s_raw);
    }
  }

  const bool pairs = (O & 1) == 0;
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    const int y = y0 + warp * kWarpRows + (m >> 1);
    if (y >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // lane rows g, g+8
      const int xx = x0 + (m & 1) * 16 + g + 8 * h;
      if (xx >= W) continue;
      float* o = ob + (static_cast<long long>(y >> 1) * W2 + (xx >> 1)) * 4 * O
                 + ((y & 1) * 2 + (xx & 1)) * O;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int oc = oc0 + n * 8 + 2 * t;
        const float v0 = acc[m][n][2 * h];
        const float v1 = acc[m][n][2 * h + 1];
        if (pairs && oc + 1 < O) {
          *reinterpret_cast<float2*>(o + oc) = make_float2(v0, v1);
        } else {
          if (oc < O) o[oc] = v0;
          if (oc + 1 < O) o[oc + 1] = v1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16

constexpr int kCC16 = 16;                       // input channels per stage
constexpr int kInBf16 = kHaloPix * kCC16;       // one stage of input, bf16s
constexpr int kWBf16 = 9 * kNT * 32 * 4;        // one stage of weights, bf16s
constexpr int kSmemBf16 = (2 * kInBf16 + 2 * kWBf16) * 2;

// d = a b from zero sums; a: 4 regs of 2 bf16, b: 2 regs of 2 bf16
__device__ __forceinline__ void mma_bf16_from_zero(float (&d)[4],
                                                   const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// Copy channels c0..c0+15 of the 18x34 halo'd tile at fine (y0-1, x0-1)
// into s (pixel-major, 16 bf16 a pixel), zeros outside the plane and past
// C: two 16-byte cp.async a pixel where C % 8 == 0, else 2-byte loads.
__device__ __forceinline__ void stage_input_bf16(bf16* s, const bf16* xb,
                                                 int y0, int x0, int H, int W,
                                                 int W2, int C, int c0) {
  if ((C & 7) == 0) {
    for (int i = threadIdx.x; i < kHaloPix * 2; i += kThreads) {
      const int p = i >> 1;
      const int c = c0 + (i & 1) * 8;
      const int hy = p / kHaloW;
      const int y = y0 - 1 + hy;
      const int xx = x0 - 1 + p - hy * kHaloW;
      const bool in = y >= 0 && y < H && xx >= 0 && xx < W && c < C;
      const bf16* src = in
          ? xb + (static_cast<long long>(y >> 1) * W2 + (xx >> 1)) * 4 * C
                + ((y & 1) * 2 + (xx & 1)) * C + c
          : xb;
      cp_async<16>(s + i * 8, src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kInBf16; i += kThreads) {
      const int p = i >> 4;
      const int c = c0 + (i & 15);
      const int hy = p / kHaloW;
      const int y = y0 - 1 + hy;
      const int xx = x0 - 1 + p - hy * kHaloW;
      const bool in = y >= 0 && y < H && xx >= 0 && xx < W && c < C;
      s[i] = in ? xb[(static_cast<long long>(y >> 1) * W2 + (xx >> 1)) * 4 * C
                     + ((y & 1) * 2 + (xx & 1)) * C + c]
                : to_bf16(0.0f);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
conv_s2d_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     bf16* __restrict__ out, int H2, int W2, int C, int O,
                     int n_oc_blocks) {
  extern __shared__ __align__(16) bf16 smem_h[];
  bf16* s_in = smem_h;                        // [2][612][16]
  bf16* s_w = smem_h + 2 * kInBf16;           // [2][9][4][32][4]

  const int H = 2 * H2;
  const int W = 2 * W2;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tile_y = blockIdx.x / tiles_x;
  const int y0 = tile_y * kTileH;
  const int x0 = (blockIdx.x - tile_y * tiles_x) * kTileW;
  const int oc0 = blockIdx.y * kOC;
  const long long b = blockIdx.z;
  const bf16* xb = x + b * H2 * W2 * 4 * C;
  bf16* ob = out + b * H2 * W2 * 4 * O;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int stages = (C + kCC16 - 1) / kCC16;
  // stage st's weights of this block's output channels
  auto stage_weights = [&](bf16* dst, int st) {
    const bf16* src =
        w + (static_cast<long long>(st) * n_oc_blocks + blockIdx.y) * kWBf16;
    for (int i = threadIdx.x; i < kWBf16 / 8; i += kThreads)
      cp_async<16>(dst + i * 8, src + i * 8, 16);
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[m][n][k] = 0.0f;

  stage_input_bf16(s_in, xb, y0, x0, H, W, W2, C, 0);
  stage_weights(s_w, 0);
  cp_async_commit();
  cp_async_wait();

  for (int st = 0; st < stages; ++st) {
    const int cur = st & 1;
    const bool more = st + 1 < stages;
    // this stage's input and weights are in; the other buffers are free
    __syncthreads();
    if (more) {
      stage_input_bf16(s_in + (cur ^ 1) * kInBf16, xb, y0, x0, H, W, W2, C,
                       (st + 1) * kCC16);
      stage_weights(s_w + (cur ^ 1) * kWBf16, st + 1);
      cp_async_commit();
    }

    const bf16* in = s_in + cur * kInBf16;
    const uint2* ws = reinterpret_cast<const uint2*>(s_w + cur * kWBf16);
#pragma unroll 3
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3;
      const int kx = tap - ky * 3;
      uint2 bw[kNT];
#pragma unroll
      for (int n = 0; n < kNT; ++n) bw[n] = ws[(tap * kNT + n) * 32 + lane];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        // m16 tile m: output row warp*kWarpRows + m/2, columns (m%2)*16 +
        // 0..15; lane rows g and g+8, channels 4t..4t+3
        const bf16* r = in + ((warp * kWarpRows + (m >> 1) + ky) * kHaloW
                              + (m & 1) * 16 + g + kx) * kCC16 + 4 * t;
        const uint2 lo = *reinterpret_cast<const uint2*>(r);
        const uint2 hi = *reinterpret_cast<const uint2*>(r + 8 * kCC16);
        const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          float step[4];
          mma_bf16_from_zero(step, a, bw[n].x, bw[n].y);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[m][n][k] = __fadd_rn(acc[m][n][k], step[k]);
        }
      }
    }
    if (more) cp_async_wait();
  }

  const bool pairs = (O & 1) == 0;
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    const int y = y0 + warp * kWarpRows + (m >> 1);
    if (y >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // lane rows g, g+8
      const int xx = x0 + (m & 1) * 16 + g + 8 * h;
      if (xx >= W) continue;
      bf16* o = ob + (static_cast<long long>(y >> 1) * W2 + (xx >> 1)) * 4 * O
                + ((y & 1) * 2 + (xx & 1)) * O;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int oc = oc0 + n * 8 + 2 * t;
        const float v0 = acc[m][n][2 * h];
        const float v1 = acc[m][n][2 * h + 1];
        if (pairs && oc + 1 < O) {
          *reinterpret_cast<uint32_t*>(o + oc) = pack_bf16x2(v0, v1);
        } else {
          if (oc < O) o[oc] = to_bf16(v0);
          if (oc + 1 < O) o[oc + 1] = to_bf16(v1);
        }
      }
    }
  }
}

// the grid of a launch (tiles, O blocks, B), or an error
int conv_grid(int B, int H2, int W2, int C, int O, dim3& grid) {
  if (C <= 0 || O <= 0 || B > 65535 || H2 > INT_MAX / 2 || W2 > INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = ((2LL * H2 + kTileH - 1) / kTileH)
                          * ((2LL * W2 + kTileW - 1) / kTileW);
  const int Op = (O + kOC - 1) / kOC * kOC;
  if (tiles > INT_MAX || Op / kOC > 65535
      || static_cast<long long>(C + kCC16) * 9 * Op > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  grid = dim3(static_cast<unsigned>(tiles), Op / kOC, B);
  return 0;
}

}  // namespace

// x [B, H2, W2, 4C], w [C, 9, Op] with Op = O rounded up to 32, out
// [B, H2, W2, 4O]; float32, contiguous, 16-byte aligned. Any C, O >= 1 and
// any plane whose fine size 2*H2 x 2*W2 fits an int; B <= 65535.
DBSR_EXPORT int dbsr_conv_s2d_f32(const float* x, const float* w, float* out,
                                  int B, int H2, int W2, int C, int O,
                                  void* stream) {
  dim3 grid;
  if (const int err = conv_grid(B, H2, W2, C, O, grid)) return err;
  if (B == 0 || H2 == 0 || W2 == 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      conv_s2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_s2d_kernel<<<grid, kThreads, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(x, w, out, H2, W2, C,
                                                         O, grid.y * kOC);
  return static_cast<int>(cudaGetLastError());
}

// x [B, H2, W2, 4C] and out [B, H2, W2, 4O] bfloat16; w the bf16 weights in
// the fragments' order, [ceil(C/16)][ceil(O/32)][9][4][32][4] (zeros past C
// and O); contiguous, 16-byte aligned. Any C, O >= 1.
DBSR_EXPORT int dbsr_conv_s2d_bf16(const bf16* x, const bf16* w, bf16* out,
                                   int B, int H2, int W2, int C, int O,
                                   void* stream) {
  dim3 grid;
  if (const int err = conv_grid(B, H2, W2, C, O, grid)) return err;
  if (B == 0 || H2 == 0 || W2 == 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      conv_s2d_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBf16);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_s2d_bf16_kernel<<<grid, kThreads, kSmemBf16,
                         static_cast<cudaStream_t>(stream)>>>(
      x, w, out, H2, W2, C, O, grid.y);
  return static_cast<int>(cudaGetLastError());
}
