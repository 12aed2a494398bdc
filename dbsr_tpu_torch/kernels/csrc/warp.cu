// Bilinear backward warp of channels-last features, zeros padding:
//   out[b, p, c] = sum over the 4 floor taps q of (p + flow[b, p]) of
//                  w_q * feat[b, q, c],  out-of-range taps weigh 0,
// for float32 features, and for bfloat16 ones (float32 flow) with the
// TPU kernel's bf16 arithmetic: each tap weight rounded to bf16, the
// products and their sum in float32, one rounding of the output.
//
// Replaces the TPU kernel dbsr_tpu/ops/warp_pallas.py:_warp_pallas_impl
// (body _warp_kernel), which built a one-hot [T, P] operator per tile and
// rode the MXU to avoid TPU gathers (in bf16 the operator cast to bf16,
// `_dot`, bf16 x bf16 products summed in float32). The card gathers well,
// so this is a direct gather.
//
// Bound on the H100: memory. The least traffic is one read of feat and flow
// and one write of out; at the encoder's [104, 48, 48, 512] that is
// ~0.98 GB in float32, ~0.29 ms at 3.35 TB/s (bf16: ~0.50 GB, ~0.15 ms).
// Neighbouring pixels share taps, so the re-reads of feat mostly hit L1/L2.
//
// Design: one block per tile of kPix output pixels of one frame. The first
// kPix threads compute each pixel's four tap offsets and weights once, into
// shared memory, with exactly the arithmetic of interp.sample_bilinear /
// warp_pallas._tap_weights (floor taps, clamped index, weight 0 where the
// tap is out of range; in bf16 the weight then rounded to bf16). Then all
// threads walk (pixel, channel group) pairs, channel-contiguous: 16-byte
// loads and stores where the channels allow (float32: groups of 4 channels
// for C % 4 == 0, 16 pixels a block, so a warp reads 512 contiguous bytes
// per tap at C = 512; bf16: groups of 8 for C % 8 == 0, 64 pixels a block),
// else one channel an access (256 pixels a block: SCA's and the
// coarse-to-fine pass's 3-channel images, where a block's 768 channels are
// its contiguous output). Products and sums use the _rn intrinsics, which
// nvcc never contracts into FMAs: the result is bit-identical to the plain
// PyTorch version (ops/warp.py:warp_feat_plain), which sums the four terms
// in the same order (in bf16 the products of two bf16 values are exact in
// float32, and both round the float32 sum once).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// kVec channels an access of element type T, widened to float32
template <typename T, int kVec>
struct Access;
template <>
struct Access<float, 4> {
  static constexpr int kPix = 16;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float weight(float w) { return w; }
};
template <>
struct Access<float, 1> {
  static constexpr int kPix = kThreads;
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    *p = v[0];
  }
  static __device__ __forceinline__ float weight(float w) { return w; }
};
template <>
struct Access<bf16, 8> {
  static constexpr int kPix = 64;
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[8]) {
    load_bf16x8(p, v);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
    store_bf16x8(p, v);
  }
  static __device__ __forceinline__ float weight(float w) {
    return round_bf16(w);
  }
};
template <>
struct Access<bf16, 1> {
  static constexpr int kPix = kThreads;
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[1]) {
    v[0] = load_bf16(p);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[1]) {
    *p = to_bf16(v[0]);
  }
  static __device__ __forceinline__ float weight(float w) {
    return round_bf16(w);
  }
};

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const T* __restrict__ feat, const float* __restrict__ flow,
            T* __restrict__ out, int H, int W, int C) {
  using A = Access<T, kVec>;
  constexpr int kPix = A::kPix;
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
      s_w[threadIdx.x][t] = valid ? A::weight(w[t]) : 0.0f;
    }
  }
  __syncthreads();

  const int CV = C / kVec;
  const T* fb = feat + frame * P * C;
  T* ob = out + (frame * P + p0) * C;
  for (int i = threadIdx.x; i < npix * CV; i += kThreads) {
    const int q = i / CV;
    const int c = (i - q * CV) * kVec;
    float v[kVec], acc[kVec];
    A::load(fb + s_off[q][0] + c, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = __fmul_rn(v[e], s_w[q][0]);
#pragma unroll
    for (int t = 1; t < 4; ++t) {
      A::load(fb + s_off[q][t] + c, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc[e] = __fadd_rn(acc[e], __fmul_rn(v[e], s_w[q][t]));
    }
    A::store(ob + static_cast<long long>(q) * C + c, acc);
  }
}

template <typename T, int kVec>
void launch(const T* feat, const float* flow, T* out, int frames, int H,
            int W, int C, cudaStream_t stream) {
  constexpr int kPix = Access<T, kVec>::kPix;
  const dim3 grid((H * W + kPix - 1) / kPix, frames);
  warp_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(feat, flow, out, H, W,
                                                      C);
}

// the 16-byte path where C is a multiple of kWide, else one channel an access
template <typename T, int kWide>
int warp(const T* feat, const float* flow, T* out, int frames, int H, int W,
         int C, void* stream) {
  if (frames > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0 || H == 0 || W == 0 || C == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % kWide == 0)
    launch<T, kWide>(feat, flow, out, frames, H, W, C, st);
  else
    launch<T, 1>(feat, flow, out, frames, H, W, C, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feat [frames, H, W, C], flow [frames, H, W, 2], out [frames, H, W, C];
// contiguous, 16-byte aligned; any C (16-byte accesses where C % 4 == 0
// in float32, C % 8 == 0 in bf16; one channel an access otherwise). The
// flow is float32 in both.
DBSR_EXPORT int dbsr_warp_f32(const float* feat, const float* flow, float* out,
                              int frames, int H, int W, int C, void* stream) {
  return warp<float, 4>(feat, flow, out, frames, H, W, C, stream);
}

DBSR_EXPORT int dbsr_warp_bf16(const bf16* feat, const float* flow, bf16* out,
                               int frames, int H, int W, int C, void* stream) {
  return warp<bf16, 8>(feat, flow, out, frames, H, W, C, stream);
}
