// Bilinear backward warp of channels-last float32 features, zeros padding:
//   out[b, p, c] = sum over the 4 floor taps q of (p + flow[b, p]) of
//                  w_q * feat[b, q, c],  out-of-range taps weigh 0.
//
// Replaces the TPU kernel dbsr_tpu/ops/warp_pallas.py:_warp_pallas_impl
// (body _warp_kernel), which built a one-hot [T, P] operator per tile and
// rode the MXU to avoid TPU gathers. The card gathers well, so this is a
// direct gather.
//
// Bound on the H100: memory. The least traffic is one read of feat and flow
// and one write of out; at the encoder's [104, 48, 48, 512] that is
// ~0.98 GB, ~0.29 ms at 3.35 TB/s. Neighbouring pixels share taps, so the
// re-reads of feat mostly hit L1/L2.
//
// Design: one block per tile of kPix output pixels of one frame. The first
// kPix threads compute each pixel's four tap offsets and weights once, into
// shared memory, with exactly the arithmetic of interp.sample_bilinear /
// warp_pallas._tap_weights (floor taps, clamped index, weight 0 where the
// tap is out of range). Then all threads walk (pixel, 4-channel group)
// pairs with 16-byte loads and stores, channel-contiguous, so a warp reads
// 512 contiguous bytes per tap. Products and sums use the _rn intrinsics,
// which nvcc never contracts into FMAs: the result is bit-identical to the
// plain PyTorch version (ops/warp.py:warp_feat_plain), which sums the four
// terms in the same order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 16;

__device__ __forceinline__ float4 axpy_rn(float w, float4 v, float4 acc) {
  return make_float4(__fadd_rn(acc.x, __fmul_rn(v.x, w)),
                     __fadd_rn(acc.y, __fmul_rn(v.y, w)),
                     __fadd_rn(acc.z, __fmul_rn(v.z, w)),
                     __fadd_rn(acc.w, __fmul_rn(v.w, w)));
}

__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ feat, const float* __restrict__ flow,
            float* __restrict__ out, int H, int W, int C) {
  __shared__ long long s_off[kPix][4];  // element offset of each tap in the frame
  __shared__ float s_w[kPix][4];

  const int P = H * W;
  const long long frame = blockIdx.y;
  const int p0 = blockIdx.x * kPix;
  const int npix = min(kPix, P - p0);

  if (threadIdx.x < npix) {
    const int p = p0 + threadIdx.x;
    const float* fl = flow + (frame * P + p) * 2;
    const float x = __fadd_rn(static_cast<float>(p % W), fl[0]);
    const float y = __fadd_rn(static_cast<float>(p / W), fl[1]);
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float wx = __fsub_rn(x, x0);
    const float wy = __fsub_rn(y, y0);
    const float ax = __fsub_rn(1.0f, wx);
    const float ay = __fsub_rn(1.0f, wy);
    const float w[4] = {__fmul_rn(ay, ax), __fmul_rn(ay, wx),
                        __fmul_rn(wy, ax), __fmul_rn(wy, wx)};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float yi = y0 + static_cast<float>(t >> 1);
      const float xi = x0 + static_cast<float>(t & 1);
      const bool valid = yi >= 0.0f && yi < static_cast<float>(H) &&
                         xi >= 0.0f && xi < static_cast<float>(W);
      const int yc = static_cast<int>(fminf(fmaxf(yi, 0.0f), H - 1.0f));
      const int xc = static_cast<int>(fminf(fmaxf(xi, 0.0f), W - 1.0f));
      s_off[threadIdx.x][t] = (static_cast<long long>(yc) * W + xc) * C;
      s_w[threadIdx.x][t] = valid ? w[t] : 0.0f;
    }
  }
  __syncthreads();

  const int C4 = C / 4;
  const float* fb = feat + frame * P * C;
  float* ob = out + (frame * P + p0) * C;
  for (int i = threadIdx.x; i < npix * C4; i += kThreads) {
    const int q = i / C4;
    const int c = (i - q * C4) * 4;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(fb + s_off[q][t] + c));
      if (t == 0) {
        acc = make_float4(__fmul_rn(v.x, s_w[q][0]), __fmul_rn(v.y, s_w[q][0]),
                          __fmul_rn(v.z, s_w[q][0]), __fmul_rn(v.w, s_w[q][0]));
      } else {
        acc = axpy_rn(s_w[q][t], v, acc);
      }
    }
    *reinterpret_cast<float4*>(ob + static_cast<long long>(q) * C + c) = acc;
  }
}

}  // namespace

// feat [frames, H, W, C], flow [frames, H, W, 2], out [frames, H, W, C];
// all float32, contiguous, 16-byte aligned; C % 4 == 0.
DBSR_EXPORT int dbsr_warp_f32(const float* feat, const float* flow, float* out,
                              int frames, int H, int W, int C, void* stream) {
  if (C % 4 != 0 || frames > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0 || H == 0 || W == 0 || C == 0) return 0;
  const dim3 grid((H * W + kPix - 1) / kPix, frames);
  warp_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      feat, flow, out, H, W, C);
  return static_cast<int>(cudaGetLastError());
}
