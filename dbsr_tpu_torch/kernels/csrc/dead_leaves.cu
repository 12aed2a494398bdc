// The dead-leaves composite: L anti-aliased, shaded ellipses painted in
// order over a background, at every pixel of n images:
//   out[i, y, x, :] = the leaves of table[i] composited over bg[i]
// (the arithmetic is in dbsr_tpu_torch/ops/dead_leaves.py's docstring).
//
// Replaces no Pallas kernel: the JAX package leaves this loop
// (dbsr_tpu/data/procedural.py:dead_leaves_image) to XLA, and the port's
// plain version is one round of ~23 full-image elementwise passes a leaf,
// ~1.56 GB of device-memory traffic a leaf for a chunk of 32 images of 432^2.
//
// Bound on the H100: operations. 38 float32 operations a pixel a leaf (2
// subtractions, 4 + 4 for the rotation, 5 for d, 4 for cover, 6 for shade,
// 1 for keep, 12 for the blend; two of them IEEE divisions and one a square
// root, each several instructions). None fuses into an FMA (the bits forbid
// it), so they issue at half of the 67 TFLOP/s that counts an FMA as two:
// [32, 432, 432] with L = 300 is ~5.97M pixels x 300 leaves x 38 = 68
// GFLOP, ~2.0 ms at 33.5 T operations/s, against ~72 MB of output (0.021 ms
// at 3.35 TB/s) and a 422 KB table.
//
// Design: a 3-D grid of (column tile, row tile, image), one thread per
// pixel, 16x16 pixels a block (432 = 27 x 16: no idle lanes at the pool's
// size). The block stages its image's leaf table through shared memory in
// slices of kSlice leaves, each leaf padded to 12 floats so that a thread
// reads it as three broadcast 16-byte loads. Each thread walks the leaves
// in painter's order and keeps its pixel's RGB in registers; it writes its
// 12 bytes once (a warp's stores are two runs of 192 contiguous bytes).
// Bits: every operation is the plain version's, in its order, with the
// _rn intrinsics, which nvcc never contracts into FMAs, so the image equals
// the plain version's on the same card bit for bit (PyTorch's CUDA
// elementwise ops round each operation once: a + alpha*b with alpha = +-1
// is a - b or a + b exactly; a / b and sqrt are IEEE; clamp is
// fminf(fmaxf(v, lo), hi)). No culling: a tile could skip a leaf that
// provably covers none of it (cover 0 leaves img*1 + c*0 = img), but the
// composite is ~1% of a round's render once fused, and the skip would keep
// a -0.0 that the plain version's + (+0.0) turns into +0.0.
#include "common.cuh"

namespace {

constexpr int kTileX = 16;
constexpr int kTileY = 16;
constexpr int kThreads = kTileX * kTileY;
constexpr int kParams = 11;  // ops/dead_leaves.py:LEAF_PARAMS
constexpr int kPadded = 12;
constexpr int kSlice = 256;  // leaves staged at a time
constexpr float kGradAmp = 0.35f;  // ops/dead_leaves.py:GRAD_AMP

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads)
dead_leaves_composite_kernel(const float* __restrict__ bg,
                             const float* __restrict__ table,
                             float* __restrict__ out, int L, int H, int W) {
  __shared__ __align__(16) float s_leaf[kSlice * kPadded];
  const int img_idx = blockIdx.z;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  const float xf = static_cast<float>(x);
  const float yf = static_cast<float>(y);
  float img[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) img[c] = __ldg(bg + img_idx * 3 + c);

  const float* leaves = table + static_cast<long long>(img_idx) * L * kParams;
  for (int base = 0; base < L; base += kSlice) {
    const int count = min(kSlice, L - base);
    __syncthreads();  // the previous slice's reads are done
    for (int e = tid; e < count * kParams; e += kThreads) {
      const int j = e / kParams;
      s_leaf[j * kPadded + (e - j * kParams)] =
          __ldg(leaves + static_cast<long long>(base) * kParams + e);
    }
    __syncthreads();
    for (int j = 0; j < count; ++j) {
      const float4 p0 = *reinterpret_cast<const float4*>(s_leaf + j * kPadded);
      const float4 p1 =
          *reinterpret_cast<const float4*>(s_leaf + j * kPadded + 4);
      const float4 p2 =
          *reinterpret_cast<const float4*>(s_leaf + j * kPadded + 8);
      const float r = p0.x, cx = p0.y, cy = p0.z, ct = p0.w;
      const float st = p1.x, a = p1.y;
      const float color[3] = {p1.z, p1.w, p2.x};
      const float gx = p2.y, gy = p2.z;

      const float dx = __fsub_rn(xf, cx);
      const float dy = __fsub_rn(yf, cy);
      const float xr =
          __fmul_rn(__fadd_rn(__fmul_rn(ct, dx), __fmul_rn(st, dy)), a);
      const float yr =
          __fdiv_rn(__fadd_rn(__fmul_rn(-st, dx), __fmul_rn(ct, dy)), a);
      const float d = __fsqrt_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(xr, xr), __fmul_rn(yr, yr)), 1e-8f));
      const float cover = clamp01(__fadd_rn(0.5f, __fsub_rn(r, d)));
      const float shade = __fadd_rn(
          1.0f,
          __fdiv_rn(__fmul_rn(kGradAmp, __fadd_rn(__fmul_rn(gx, xr),
                                                  __fmul_rn(gy, yr))),
                    r));
      const float keep = __fsub_rn(1.0f, cover);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        img[c] = __fadd_rn(__fmul_rn(img[c], keep),
                           __fmul_rn(__fmul_rn(color[c], shade), cover));
    }
  }
  if (x >= W || y >= H) return;
  float* o = out + ((static_cast<long long>(img_idx) * H + y) * W + x) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c] = img[c];
}

}  // namespace

// bg [n, 3], table [n, L, 11], out [n, H, W, 3]; float32, contiguous;
// n <= 65535, H and W < 2^20.
DBSR_EXPORT int dbsr_dead_leaves_composite_f32(const float* bg,
                                               const float* table, float* out,
                                               int n, int L, int H, int W,
                                               void* stream) {
  if (n > 65535 || H >= (1 << 20) || W >= (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || H == 0 || W == 0) return 0;
  const long long rows = (static_cast<long long>(H) + kTileY - 1) / kTileY;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTileX, kTileY);
  const dim3 grid((W + kTileX - 1) / kTileX, static_cast<unsigned>(rows),
                  static_cast<unsigned>(n));
  dead_leaves_composite_kernel<<<grid, block, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      bg, table, out, L, H, W);
  return static_cast<int>(cudaGetLastError());
}
