// Bilinear resampling of channels-last float32 images at per-frame affine
// coordinates, with a downsample factor d and a border crop, zeros padding:
//   out[b, n, r, x, c] = bilinear(images[b], inv[b, n] @ (fx, fy, 1))[c],
//   fx = (x + 0.5) d - 0.5 + border,  fy = (r + 0.5) d - 0.5 + border,
// out-of-image taps weigh 0.
//
// Replaces the TPU kernel dbsr_tpu/ops/resample_pallas.py:_resample_impl
// (body _resample_kernel), which avoided TPU gathers by contracting a band
// of source rows against bilinear hat matrices on the MXU (at bf16 DEFAULT
// precision, unless asked for HIGHEST) and so only took rotation-only
// affines within a bounded band. The card gathers well: this is a direct
// gather, exact float32, for any affine.
//
// Bound on the H100: memory. One read of the images and one write of the
// output: fused synthesis (d=4, border 24, [16, 432, 432, 3] -> [16, 8, 96,
// 96, 3]) ~35.8 MB + 14.2 MB, ~0.015 ms at 3.35 TB/s; strict synthesis (d=1,
// border 0, -> [16, 8, 432, 432, 3]) ~287 MB written, ~0.096 ms.
//
// Design: one thread per output pixel (b, n, r, x). It forms the source
// coordinate from the frame's six affine entries elementwise, then the four
// floor taps (clamped index, weight 0 out of range) exactly as
// interp.sample_bilinear does, and sums the C channel values of the taps in
// tap order (00, 01, 10, 11). All coordinate and weight arithmetic uses the
// _rn intrinsics, which nvcc never contracts into FMAs, so the result is
// bit-identical to the plain PyTorch version (ops/resample.py). The images
// are small (36 MB) and neighbouring threads share taps, so re-reads hit L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 4;

__global__ void __launch_bounds__(kThreads)
resample_kernel(const float* __restrict__ images,
                const float* __restrict__ invs, float* __restrict__ out,
                int N, int H, int W, int C, int OH, int OW, float d,
                float border, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int x = static_cast<int>(i % OW);
  const long long t = i / OW;
  const int r = static_cast<int>(t % OH);
  const long long bn = t / OH;  // b * N + n
  const long long b = bn / N;
  const float* m = invs + bn * 6;

  const float fx = __fadd_rn(
      __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(x), 0.5f), d), 0.5f),
      border);
  const float fy = __fadd_rn(
      __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(r), 0.5f), d), 0.5f),
      border);
  const float u = __fadd_rn(__fadd_rn(__fmul_rn(m[0], fx), __fmul_rn(m[1], fy)),
                            m[2]);
  const float v = __fadd_rn(__fadd_rn(__fmul_rn(m[3], fx), __fmul_rn(m[4], fy)),
                            m[5]);

  const float x0 = floorf(u);
  const float y0 = floorf(v);
  const float wx = __fsub_rn(u, x0);
  const float wy = __fsub_rn(v, y0);
  const float ax = __fsub_rn(1.0f, wx);
  const float ay = __fsub_rn(1.0f, wy);
  const float w[4] = {__fmul_rn(ay, ax), __fmul_rn(ay, wx), __fmul_rn(wy, ax),
                      __fmul_rn(wy, wx)};

  const float* src = images + b * H * W * C;
  float acc[kMaxC];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float yi = y0 + static_cast<float>(k >> 1);
    const float xi = x0 + static_cast<float>(k & 1);
    const bool valid = yi >= 0.0f && yi < static_cast<float>(H) && xi >= 0.0f &&
                       xi < static_cast<float>(W);
    const int yc = static_cast<int>(fminf(fmaxf(yi, 0.0f), H - 1.0f));
    const int xc = static_cast<int>(fminf(fmaxf(xi, 0.0f), W - 1.0f));
    const float wk = valid ? w[k] : 0.0f;
    const float* px = src + (static_cast<long long>(yc) * W + xc) * C;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c >= C) break;
      const float term = __fmul_rn(__ldg(px + c), wk);
      acc[c] = k == 0 ? term : __fadd_rn(acc[c], term);
    }
  }
  float* o = out + i * C;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c >= C) break;
    o[c] = acc[c];
  }
}

}  // namespace

// images [B, H, W, C], invs [B, N, 2, 3], out [B, N, OH, OW, C]; float32,
// contiguous; 1 <= C <= 4.
DBSR_EXPORT int dbsr_resample_f32(const float* images, const float* invs,
                                  float* out, int B, int N, int H, int W,
                                  int C, int OH, int OW, int d, int border,
                                  void* stream) {
  if (C < 1 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(B) * N * OH * OW;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  resample_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      images, invs, out, N, H, W, C, OH, OW, static_cast<float>(d),
      static_cast<float>(border), total);
  return static_cast<int>(cudaGetLastError());
}
