// The weight gradient of the fine-resolution 3x3 SAME convolution on the
// phase-major space-to-depth-2 ("s2d") layout, bfloat16 operands, float32
// sums and result:
//   x  [B, H2, W2, 4C]  fine pixel (2Y+qy, 2X+qx), channel c, at
//                       x[b, Y, X, (qy*2 + qx)*C + c]
//   g  [B, H2, W2, 4O]  the output gradient, the same layout
//   dk [O, C, 3, 3]     dk[o, c, ky, kx] = sum_{b, y, x} g_fine[b, y, x, o]
//                                      * x_fine[b, y+ky-1, x+kx-1, c],
// x_fine zero outside the fine 2H2 x 2W2 plane (conv_s2d.cu computes the
// forward and d_input).
//
// Replaces no TPU kernel: the JAX package leaves this term to XLA
// (dbsr_tpu/ops/conv_s2d_pallas.py:_bwd, a conv of the unfolded operands at
// Precision.DEFAULT for bf16: bf16 products, float32 sums). Here the same
// term went to cuDNN's float32 weight gradient on float32 copies of the
// unfolded operands. A bf16 x bf16 product is exact in float32, so the
// tensor core forms the same products; only the order of the sums differs.
//
// Bound on the H100 at the DBSR decoder's training launch (B=16,
// H2=W2=192, C=O=32): a GEMM of M = O = 32, N = 9C = 288, K = 16*384^2 =
// 2,359,296 fine pixels, 43.5 GFLOP, 0.044 ms at 989 TFLOP/s; 302 MB of bf16
// x and g read once, 0.090 ms at 3.35 TB/s. Bytes bound it (~144 FLOP a byte
// against the card's 295), so mma.sync with staging kept ahead suffices.
//
// Design: the main kernel streams the inputs once, straight from the s2d
// layout, and writes one [32, 9, 32] float32 partial a block; a second
// kernel sums the partials.
// - Work: a job is one coarse output row of one strip of 16 coarse (32 fine)
//   columns: 64 fine output pixels. The jobs, strip by strip and row by row
//   within a strip, are cut into gridDim.x contiguous ranges, one a block
//   (kMinBlocks blocks an SM, at most one a job: dweight_blocks, which
//   alone sizes the grid and the partials' scratch), so a block's range
//   crosses a strip boundary at most once or twice at the training shape.
//   blockIdx.y picks 32 input and 32 output channels; zeros stand past C
//   and O.
// - Staging: cp.async in 16-byte chunks (one chunk is 8 channels of one fine
//   pixel in the s2d layout; plain loads where C or O is not a multiple of
//   8), kDepth coarse rows ahead: x in a ring of kDepth + 3 coarse rows (a
//   job reads its rows Y-1, Y and Y+1, with one fine column of halo on each
//   side), g in a ring of kDepth + 1. Both are de-interleaved in shared
//   memory into fine rows of fine pixels, 40 bf16 a pixel (32 channels and
//   16 bytes of padding: 8 consecutive pixels fall on 8 distinct 16-byte
//   bank groups). Zeros outside the plane come from cp.async's zero fill.
// - Products: ldmatrix.trans turns 8 pixels' 8 channels into the k-pairs of
//   mma.sync.m16n8k16 (bf16 in, float32 accumulate): A = g^T (output
//   channels by 16 pixels), B = x at the tap's offset (16 pixels by 8 input
//   channels). Warp w takes the input channels (w % 4)*8..+7, all 32 output
//   channels (two m16 tiles), all nine taps, and fine output row w / 4 of
//   each job: 72 float32 sums a thread. A job costs a warp 4 A loads, 9 B
//   loads (x4 each) and 36 MMAs.
// - Accumulation: the tensor core adds into its float32 sums truncating
//   (conv_s2d.cu's note), so an MMA chain never runs long: each chain is the
//   two 16-pixel halves of one fine row of one job, 32 products, started
//   from zero and added to the running sum by a rounded float32 add. A
//   running sum takes ~140 such adds at the training shape. At the end the
//   two warps of each channel group add their sums in a fixed order
//   (through shared memory) and write the block's partial.
// - Reduction: s2d_dweight_reduce_kernel sums a weight's gridDim.x partials
//   in float64, in a fixed order (8 strided groups, then the groups in
//   order), and rounds once to float32. No atomics: the same inputs give the
//   same bits on the same card and grid.
#include "common.cuh"

#include <climits>
#include <cstdint>

namespace {

constexpr int kStripX = 16;               // coarse columns a strip
constexpr int kFineW = 2 * kStripX;       // fine output columns a strip
constexpr int kHaloW = kFineW + 2;        // staged fine x columns
constexpr int kCB = 32;                   // input channels a block
constexpr int kOB = 32;                   // output channels a block
constexpr int kPix = 40;                  // bf16s a staged pixel
constexpr int kDepth = 3;                 // coarse rows staged ahead
constexpr int kXSlots = kDepth + 3;
constexpr int kGSlots = kDepth + 1;
constexpr int kXSlot = 2 * kHaloW * kPix; // bf16s a staged x coarse row
constexpr int kGSlot = 2 * kFineW * kPix; // bf16s a staged g coarse row
constexpr int kThreads = 256;             // 8 warps
constexpr int kMinBlocks = 2;             // blocks an SM
constexpr int kTaps = 9;
constexpr int kPartial = kOB * kTaps * kCB;  // floats a block writes
constexpr int kSmemBytes = (kXSlots * kXSlot + kGSlots * kGSlot) * 2;
static_assert(kSmemBytes >= kPartial * 4, "the combine reuses the rings");
constexpr int kReduceGroups = 8;          // warps of the reduce kernel

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// d = a b from zero sums
__device__ __forceinline__ void mma_from_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// d += a b
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage x's coarse row Yr (zeros outside 0..H2-1) of the strip at coarse
// column X0, channels c0..c0+31 (zeros past C), into dst: fine row qy at
// dst + qy*kHaloW*kPix, fine column x0 - 1 + j at pixel j (x0 = 2*X0).
template <bool kVec>
__device__ __forceinline__ void stage_x(bf16* dst, const bf16* xb, int Yr,
                                        int X0, int H2, int W2, int C,
                                        int c0) {
  const bool row_in = Yr >= 0 && Yr < H2;
  if constexpr (kVec) {
    // (coarse pixel X0-1+i/16, phase (i/4)%4, 8-channel chunk i%4)
    for (int i = threadIdx.x; i < (kStripX + 2) * 16; i += kThreads) {
      const int ch = i & 3;
      const int q = (i >> 2) & 3;
      const int X = X0 - 1 + (i >> 4);
      const int j = 2 * (X - X0) + (q & 1) + 1;
      if (j < 0 || j >= kHaloW) continue;
      const int c = c0 + ch * 8;
      const bool in = row_in && X >= 0 && X < W2 && c < C;
      const bf16* src =
          in ? xb + (static_cast<long long>(Yr) * W2 + X) * 4 * C + q * C + c
             : xb;
      cp_async<16>(dst + ((q >> 1) * kHaloW + j) * kPix + ch * 8, src,
                   in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < (kStripX + 2) * 4 * kCB; i += kThreads) {
      const int cl = i & (kCB - 1);
      const int q = (i / kCB) & 3;
      const int X = X0 - 1 + i / (4 * kCB);
      const int j = 2 * (X - X0) + (q & 1) + 1;
      if (j < 0 || j >= kHaloW) continue;
      const int c = c0 + cl;
      const bool in = row_in && X >= 0 && X < W2 && c < C;
      dst[((q >> 1) * kHaloW + j) * kPix + cl] =
          in ? xb[(static_cast<long long>(Yr) * W2 + X) * 4 * C + q * C + c]
             : to_bf16(0.0f);
    }
  }
}

// Stage g's coarse row Y (in the plane) of the strip at coarse column X0,
// output channels o0..o0+31 (zeros past O and W2), into dst: fine row qy at
// dst + qy*kFineW*kPix, fine column x0 + j at pixel j.
template <bool kVec>
__device__ __forceinline__ void stage_g(bf16* dst, const bf16* gb, int Y,
                                        int X0, int W2, int O, int o0) {
  if constexpr (kVec) {
    for (int i = threadIdx.x; i < kStripX * 16; i += kThreads) {
      const int ch = i & 3;
      const int q = (i >> 2) & 3;
      const int X = X0 + (i >> 4);
      const int j = 2 * (X - X0) + (q & 1);
      const int o = o0 + ch * 8;
      const bool in = X < W2 && o < O;
      const bf16* src =
          in ? gb + (static_cast<long long>(Y) * W2 + X) * 4 * O + q * O + o
             : gb;
      cp_async<16>(dst + ((q >> 1) * kFineW + j) * kPix + ch * 8, src,
                   in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kStripX * 4 * kOB; i += kThreads) {
      const int ol = i & (kOB - 1);
      const int q = (i / kOB) & 3;
      const int X = X0 + i / (4 * kOB);
      const int j = 2 * (X - X0) + (q & 1);
      const int o = o0 + ol;
      const bool in = X < W2 && o < O;
      dst[((q >> 1) * kFineW + j) * kPix + ol] =
          in ? gb[(static_cast<long long>(Y) * W2 + X) * 4 * O + q * O + o]
             : to_bf16(0.0f);
    }
  }
}

template <bool kVecX, bool kVecG>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
s2d_dweight_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                   float* __restrict__ partial, int B, int H2, int W2, int C,
                   int O, int n_ob) {
  extern __shared__ __align__(16) bf16 smem_dw[];
  bf16* s_x = smem_dw;                          // [kXSlots][2][34][40]
  bf16* s_g = smem_dw + kXSlots * kXSlot;       // [kGSlots][2][32][40]

  const int cb = blockIdx.y / n_ob;
  const int c0 = cb * kCB;
  const int o0 = (blockIdx.y - cb * n_ob) * kOB;
  const int strips = (W2 + kStripX - 1) / kStripX;
  const long long jobs = static_cast<long long>(B) * strips * H2;
  const long long j_end = jobs * (blockIdx.x + 1) / gridDim.x;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nt = warp & 3;   // input channels nt*8..nt*8+7
  const int p = warp >> 2;   // fine output row 2Y + p of each job
  const int mi = lane >> 3;  // the 8x8 matrix whose row this lane addresses
  const int r8 = lane & 7;

  float acc[2][kTaps][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int t = 0; t < kTaps; ++t)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[m][t][k] = 0.0f;

  for (long long J = jobs * blockIdx.x / gridDim.x; J < j_end;) {
    // one segment: coarse rows Ya..Ya+n-1 of strip s
    const long long s = J / H2;
    const int Ya = static_cast<int>(J - s * H2);
    const int n = static_cast<int>(min(static_cast<long long>(H2 - Ya),
                                       j_end - J));
    const int b = static_cast<int>(s / strips);
    const int X0 = static_cast<int>(s - static_cast<long long>(b) * strips)
                   * kStripX;
    const bf16* xb = x + static_cast<long long>(b) * H2 * W2 * 4 * C;
    const bf16* gb = g + static_cast<long long>(b) * H2 * W2 * 4 * O;

    // group k: x row Ya+1+k (slot (k+2) % kXSlots) and g row Ya+k (slot
    // k % kGSlots), group 0 also x rows Ya-1 and Ya (slots 0 and 1); x row
    // Ya-1+m lives in slot m % kXSlots
    auto stage = [&](int k) {
      if (k < n) {
        stage_x<kVecX>(s_x + (k + 2) % kXSlots * kXSlot, xb, Ya + 1 + k, X0,
                       H2, W2, C, c0);
        stage_g<kVecG>(s_g + k % kGSlots * kGSlot, gb, Ya + k, X0, W2, O, o0);
      }
      cp_async_commit();
    };
    // the MMAs of job i (coarse row Ya+i)
    auto compute = [&](int i) {
      // A: g's fine row p, pixels h*16 + 0..15, output channels m*16 +
      // 0..15; matrix mi: channels +8 for odd mi, pixels +8 for mi >= 2
      const bf16* gs = s_g + i % kGSlots * kGSlot + p * kFineW * kPix;
      uint32_t a[2][2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int m = 0; m < 2; ++m)
          ldmatrix_x4_trans(a[h][m], gs + (h * 16 + (mi >> 1) * 8 + r8) * kPix
                                         + (m * 2 + (mi & 1)) * 8);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        // input fine row 2Y + p + ky - 1: coarse row Y + (rr >> 1), fine
        // row rr & 1 of it; x row Y-1+m' sits in slot (i + m') % kXSlots
        const int rr = p + ky - 1;
        const bf16* xs = s_x + (i + 1 + (rr >> 1)) % kXSlots * kXSlot
                         + (rr & 1) * kHaloW * kPix;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          // B: x at fine column x0 + h*16 + k + kx - 1 (staged pixel
          // h*16 + k + kx), channels nt*8..+7; matrix mi: half mi >> 1,
          // pixels +8 for odd mi
          uint32_t bx[4];
          ldmatrix_x4_trans(bx, xs + ((mi >> 1) * 16 + (mi & 1) * 8 + r8 + kx)
                                    * kPix + nt * 8);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            // one chain: the row's two 16-pixel halves from zero, then a
            // rounded add (see the note at the top)
            float step[4];
            mma_from_zero(step, a[0][m], bx[0], bx[1]);
            mma(step, a[1][m], bx[2], bx[3]);
#pragma unroll
            for (int k2 = 0; k2 < 4; ++k2)
              acc[m][ky * 3 + kx][k2] =
                  __fadd_rn(acc[m][ky * 3 + kx][k2], step[k2]);
          }
        }
      }
    };

    stage_x<kVecX>(s_x, xb, Ya - 1, X0, H2, W2, C, c0);
    stage_x<kVecX>(s_x + kXSlot, xb, Ya, X0, H2, W2, C, c0);
    for (int k = 0; k < kDepth; ++k) stage(k);
    for (int i = 0; i < n; ++i) {
      stage(i + kDepth);
      cp_async_wait<kDepth>();  // groups 0..i are in
      __syncthreads();
      compute(i);
      __syncthreads();  // the slots staged next are free
    }
    J += n;
  }

  // the two fine rows' warps of each channel group: row 1's sums through
  // shared memory, added to row 0's in that order
  cp_async_wait<0>();
  __syncthreads();
  float* s_acc = reinterpret_cast<float*>(smem_dw);  // [72][4][32]
  if (p == 1) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int t = 0; t < kTaps; ++t)
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2)
          s_acc[(((m * kTaps + t) * 4 + k2) * 4 + nt) * 32 + lane] =
              acc[m][t][k2];
  }
  __syncthreads();
  if (p == 0) {
    // element (o, tap, c) at (o*9 + tap)*32 + c: lane (g8, t4) holds
    // outputs m*16 + g8 (+8) and channels nt*8 + 2*t4 (+1)
    float* pb = partial
        + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x)
              * kPartial;
    const int g8 = lane >> 2;
    const int t4 = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int t = 0; t < kTaps; ++t)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int o = m * 16 + g8 + 8 * hi;
          const float* other =
              s_acc + (((m * kTaps + t) * 4 + 2 * hi) * 4 + nt) * 32 + lane;
          const float v0 = __fadd_rn(acc[m][t][2 * hi], other[0]);
          const float v1 = __fadd_rn(acc[m][t][2 * hi + 1], other[4 * 32]);
          *reinterpret_cast<float2*>(pb + (o * kTaps + t) * kCB + nt * 8
                                     + 2 * t4) = make_float2(v0, v1);
        }
  }
}

// out[o, c, tap] = sum over the G partials of (o, tap, c), float64, fixed
// order; blockIdx.x = (o % 32)*9 + tap, lane = c % 32, blockIdx.y = the
// main kernel's channel block
__global__ void __launch_bounds__(kReduceGroups * 32)
s2d_dweight_reduce_kernel(const float* __restrict__ partial,
                          float* __restrict__ out, int G, int C, int O,
                          int n_ob) {
  __shared__ double red[kReduceGroups][32];
  const int lane = threadIdx.x & 31;
  const int grp = threadIdx.x >> 5;
  const float* src = partial
      + static_cast<long long>(blockIdx.y) * G * kPartial
      + blockIdx.x * 32 + lane;
  double sum = 0.0;
  for (int k = grp; k < G; k += kReduceGroups)
    sum += static_cast<double>(src[static_cast<long long>(k) * kPartial]);
  red[grp][lane] = sum;
  __syncthreads();
  if (grp != 0) return;
#pragma unroll
  for (int k = 1; k < kReduceGroups; ++k) sum += red[k][lane];
  const int cb = blockIdx.y / n_ob;
  const int o = (blockIdx.y - cb * n_ob) * kOB + blockIdx.x / kTaps;
  const int c = cb * kCB + lane;
  if (o < O && c < C)
    out[(static_cast<long long>(o) * C + c) * kTaps + blockIdx.x % kTaps] =
        static_cast<float>(sum);
}

// blocks of the main kernel on a card of sms (>= 1) multiprocessors:
// kMinBlocks an SM, at most one a job, at least one
long long dweight_blocks(int B, int H2, int W2, int sms) {
  const long long jobs =
      static_cast<long long>(B) * H2 * ((W2 + kStripX - 1) / kStripX);
  const long long most = static_cast<long long>(kMinBlocks) * sms;
  return jobs < 1 ? 1 : (jobs < most ? jobs : most);
}

template <bool kVecX, bool kVecG>
int launch_main(dim3 grid, cudaStream_t stream, const bf16* x, const bf16* g,
                float* partial, int B, int H2, int W2, int C, int O,
                int n_ob) {
  auto kernel = s2d_dweight_kernel<kVecX, kVecG>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(x, g, partial, B, H2, W2, C,
                                                 O, n_ob);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of the partial scratch that dbsr_conv_s2d_dweight_bf16 takes for
// these sizes on a card of sms multiprocessors: one [32, 9, 32] partial a
// block, a channel block pair and a row range. 0 for sizes it refuses.
DBSR_EXPORT long long dbsr_conv_s2d_dweight_scratch_floats(int B, int H2,
                                                           int W2, int C,
                                                           int O, int sms) {
  if (C <= 0 || O <= 0 || sms <= 0 || B < 0 || H2 < 0 || W2 < 0) return 0;
  const long long n_cb = (C + kCB - 1) / kCB;
  const long long n_ob = (O + kOB - 1) / kOB;
  return n_cb * n_ob * dweight_blocks(B, H2, W2, sms) * kPartial;
}

// x [B, H2, W2, 4C] and g [B, H2, W2, 4O] bfloat16; partial float32 scratch
// of dbsr_conv_s2d_dweight_scratch_floats(B, H2, W2, C, O, sms) floats; out
// [O, C, 3, 3] float32; contiguous, 16-byte aligned. sms: the card's
// multiprocessors, which size the grid (dweight_blocks). Any C, O >= 1, any
// B, H2, W2 >= 0 (zeros for an empty plane).
DBSR_EXPORT int dbsr_conv_s2d_dweight_bf16(const bf16* x, const bf16* g,
                                           float* partial, float* out, int B,
                                           int H2, int W2, int C, int O,
                                           int sms, void* stream) {
  if (C <= 0 || O <= 0 || sms <= 0 || B < 0 || H2 < 0 || W2 < 0
      || C > INT_MAX / 4 || O > INT_MAX / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = static_cast<int>(dweight_blocks(B, H2, W2, sms));
  const int n_cb = (C + kCB - 1) / kCB;
  const int n_ob = (O + kOB - 1) / kOB;
  if (static_cast<long long>(n_cb) * n_ob > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(G, n_cb * n_ob);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vx = (C & 7) == 0;
  const bool vg = (O & 7) == 0;
  int err = vx ? (vg ? launch_main<true, true>(grid, st, x, g, partial, B,
                                              H2, W2, C, O, n_ob)
                     : launch_main<true, false>(grid, st, x, g, partial, B,
                                               H2, W2, C, O, n_ob))
               : (vg ? launch_main<false, true>(grid, st, x, g, partial, B,
                                               H2, W2, C, O, n_ob)
                     : launch_main<false, false>(grid, st, x, g, partial, B,
                                                H2, W2, C, O, n_ob));
  if (err) return err;
  s2d_dweight_reduce_kernel<<<dim3(kOB * kTaps, n_cb * n_ob),
                              kReduceGroups * 32, 0, st>>>(partial, out, G,
                                                           C, O, n_ob);
  return static_cast<int>(cudaGetLastError());
}
