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
// Bound on the H100: operations. The DBSR decoder's launch at serving
// (B=8, H2=W2=192, C=O=32) does 2*8*384^2*9*32*32 = 21.7 GFLOP, 0.325 ms at
// the 67 TFLOP/s float32 rate; its 302 MB of input and output need 0.090 ms
// at 3.35 TB/s.
//
// Design: one block of 256 threads per (16x16 fine output tile, 32 output
// channels, image). The block stages the 18x18 halo'd input tile (zeros
// outside the plane), 16 input channels at a time, channel-major with
// 16-byte-aligned rows, and the 16x9x32 weights of those channels in shared
// memory. Each thread owns 4 consecutive fine pixels of one row and 8 output
// channels (32 float32 sums in registers): per input channel and kernel row
// it reads 6 inputs (one float4, one float2) and, per kernel column, 8
// weights (two float4, the same for the threads of one channel group), for
// 96 fused multiply-adds. Single-pass, no atomics: deterministic.
#include "common.cuh"

#include <climits>

namespace {

constexpr int kTile = 16;                 // fine output tile, kTile^2 pixels
constexpr int kHalo = kTile + 2;          // staged rows and columns
constexpr int kRow = 20;                  // smem row stride, floats (16 B)
constexpr int kPlane = kHalo * kRow + 4;  // smem stride between channels
constexpr int kCC = 16;                   // input channels per staged chunk
constexpr int kOC = 32;                   // output channels per block
constexpr int kPix = 4;                   // fine pixels per thread (along x)
constexpr int kOut = 8;                   // output channels per thread
constexpr int kGroups = kOC / kOut;       // 4 channel groups
constexpr int kSegs = kTile / kPix;       // 4 row segments
constexpr int kThreads = kTile * kSegs * kGroups;  // 256

__global__ void __launch_bounds__(kThreads)
conv_s2d_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, int H2, int W2, int C, int O,
                int Op) {
  __shared__ __align__(16) float s_in[kCC * kPlane];
  __shared__ __align__(16) float s_w[kCC * 9 * kOC];

  const int H = 2 * H2;
  const int W = 2 * W2;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const int oc0 = blockIdx.y * kOC;
  const long long b = blockIdx.z;
  const float* xb = x + b * H2 * W2 * 4 * C;
  float* ob = out + b * H2 * W2 * 4 * O;

  const int tid = threadIdx.x;
  const int og = tid % kGroups;
  const int seg = (tid / kGroups) % kSegs;
  const int ty = tid / (kGroups * kSegs);

  float acc[kPix][kOut];
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int q = 0; q < kOut; ++q) acc[p][q] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    __syncthreads();  // the previous chunk is consumed
    // halo'd input tile; channel fastest, so a warp reads runs of kCC
    // consecutive channels of one fine pixel
    for (int i = tid; i < kHalo * kHalo * kCC; i += kThreads) {
      const int cc = i % kCC;
      const int pix = i / kCC;
      const int hy = pix / kHalo;
      const int hx = pix - hy * kHalo;
      const int y = y0 - 1 + hy;
      const int xx = x0 - 1 + hx;
      const int c = c0 + cc;
      float v = 0.0f;
      if (c < C && y >= 0 && y < H && xx >= 0 && xx < W) {
        const int q = (y & 1) * 2 + (xx & 1);
        v = xb[(static_cast<long long>(y >> 1) * W2 + (xx >> 1)) * 4 * C
               + q * C + c];
      }
      s_in[cc * kPlane + hy * kRow + hx] = v;
    }
    for (int i = tid; i < kCC * 9 * kOC; i += kThreads) {
      const int o = i % kOC;
      const int ct = i / kOC;  // chunk channel * 9 + tap
      const int c = c0 + ct / 9;
      s_w[i] = c < C
          ? w[(static_cast<long long>(c) * 9 + ct % 9) * Op + oc0 + o] : 0.0f;
    }
    __syncthreads();

    const int n = min(kCC, C - c0);
    for (int cc = 0; cc < n; ++cc) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float* r = s_in + cc * kPlane + (ty + ky) * kRow + seg * kPix;
        const float4 a = *reinterpret_cast<const float4*>(r);
        const float2 e = *reinterpret_cast<const float2*>(r + 4);
        const float v[kPix + 2] = {a.x, a.y, a.z, a.w, e.x, e.y};
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* wr = s_w + (cc * 9 + ky * 3 + kx) * kOC + og * kOut;
          const float4 w0 = *reinterpret_cast<const float4*>(wr);
          const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
          const float wv[kOut] = {w0.x, w0.y, w0.z, w0.w,
                                  w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int p = 0; p < kPix; ++p)
#pragma unroll
            for (int q = 0; q < kOut; ++q)
              acc[p][q] = fmaf(v[p + kx], wv[q], acc[p][q]);
        }
      }
    }
  }

  const int y = y0 + ty;
  if (y >= H) return;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int xx = x0 + seg * kPix + p;
    if (xx >= W) continue;
    const int q = (y & 1) * 2 + (xx & 1);
    float* o = ob + (static_cast<long long>(y >> 1) * W2 + (xx >> 1)) * 4 * O
               + q * O;
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const int oc = oc0 + og * kOut + k;
      if (oc < O) o[oc] = acc[p][k];
    }
  }
}

}  // namespace

// x [B, H2, W2, 4C], w [C, 9, Op] with Op = O rounded up to 32, out
// [B, H2, W2, 4O]; float32, contiguous, 16-byte aligned. Any C, O >= 1 and
// any plane whose fine size 2*H2 x 2*W2 fits an int; B <= 65535.
DBSR_EXPORT int dbsr_conv_s2d_f32(const float* x, const float* w, float* out,
                                  int B, int H2, int W2, int C, int O,
                                  void* stream) {
  if (C <= 0 || O <= 0 || B > 65535 || H2 > INT_MAX / 2 || W2 > INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H2 == 0 || W2 == 0) return 0;
  const long long tiles = ((2LL * H2 + kTile - 1) / kTile)
                          * ((2LL * W2 + kTile - 1) / kTile);
  const int Op = (O + kOC - 1) / kOC * kOC;
  if (tiles > INT_MAX || Op / kOC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), Op / kOC, B);
  conv_s2d_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, H2, W2, C, O, Op);
  return static_cast<int>(cudaGetLastError());
}
