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
// tap is out of range). Then all threads walk (pixel, channel group) pairs,
// channel-contiguous: for C % 4 == 0 with 16-byte loads and stores (groups
// of 4 channels, 16 pixels a block, so a warp reads 512 contiguous bytes
// per tap at C = 512), else with 4-byte ones (groups of one channel, 256
// pixels a block: SCA's and the coarse-to-fine pass's 3-channel images,
// where a block's 768 channels are its 3 KB of contiguous output). Products
// and sums use the _rn intrinsics, which nvcc never contracts into FMAs:
// the result is bit-identical to the plain PyTorch version
// (ops/warp.py:warp_feat_plain), which sums the four terms in the same
// order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int kVec>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static constexpr int kPix = 16;
  static __device__ __forceinline__ float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ float4 mul(float4 v, float w) {
    return make_float4(__fmul_rn(v.x, w), __fmul_rn(v.y, w),
                       __fmul_rn(v.z, w), __fmul_rn(v.w, w));
  }
  static __device__ __forceinline__ float4 axpy(float w, float4 v,
                                                float4 acc) {
    return make_float4(__fadd_rn(acc.x, __fmul_rn(v.x, w)),
                       __fadd_rn(acc.y, __fmul_rn(v.y, w)),
                       __fadd_rn(acc.z, __fmul_rn(v.z, w)),
                       __fadd_rn(acc.w, __fmul_rn(v.w, w)));
  }
};
template <>
struct Vec<1> {
  using T = float;
  static constexpr int kPix = kThreads;
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float mul(float v, float w) {
    return __fmul_rn(v, w);
  }
  static __device__ __forceinline__ float axpy(float w, float v, float acc) {
    return __fadd_rn(acc, __fmul_rn(v, w));
  }
};

// kVec channels a load: 4 (16-byte accesses, C % 4 == 0) or 1 (any C)
template <int kVec>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ feat, const float* __restrict__ flow,
            float* __restrict__ out, int H, int W, int C) {
  using V = Vec<kVec>;
  constexpr int kPix = V::kPix;
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

  const int CV = C / kVec;
  const float* fb = feat + frame * P * C;
  float* ob = out + (frame * P + p0) * C;
  for (int i = threadIdx.x; i < npix * CV; i += kThreads) {
    const int q = i / CV;
    const int c = (i - q * CV) * kVec;
    typename V::T acc = V::mul(V::load(fb + s_off[q][0] + c), s_w[q][0]);
#pragma unroll
    for (int t = 1; t < 4; ++t)
      acc = V::axpy(s_w[q][t], V::load(fb + s_off[q][t] + c), acc);
    V::store(ob + static_cast<long long>(q) * C + c, acc);
  }
}

template <int kVec>
void launch(const float* feat, const float* flow, float* out, int frames,
            int H, int W, int C, cudaStream_t stream) {
  constexpr int kPix = Vec<kVec>::kPix;
  const dim3 grid((H * W + kPix - 1) / kPix, frames);
  warp_kernel<kVec><<<grid, kThreads, 0, stream>>>(feat, flow, out, H, W, C);
}

}  // namespace

// feat [frames, H, W, C], flow [frames, H, W, 2], out [frames, H, W, C];
// all float32, contiguous, 16-byte aligned; any C (16-byte accesses where
// C % 4 == 0, 4-byte ones otherwise).
DBSR_EXPORT int dbsr_warp_f32(const float* feat, const float* flow, float* out,
                              int frames, int H, int W, int C, void* stream) {
  if (frames > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0 || H == 0 || W == 0 || C == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 4 == 0)
    launch<4>(feat, flow, out, frames, H, W, C, st);
  else
    launch<1>(feat, flow, out, frames, H, W, C, st);
  return static_cast<int>(cudaGetLastError());
}
