// Frame-softmax weighted sum of channels-last float32 features:
//   out[b, p, c] = sum_n softmax_n(logits[b, :, p, c]) * feat[b, n, p, c].
//
// Replaces the TPU kernel dbsr_tpu/ops/merge_pallas.py:_merge_fwd_impl
// (body _merge_kernel), which loaded an [N, T, Cb] tile pair into VMEM and
// ran a three-pass softmax there.
//
// Bound on the H100: memory. One read of feat and logits and one write of
// out: at the merge's [8, 14, 48, 48, 512] that is 2*528 MB + 38 MB
// ~ 1.09 GB, ~0.33 ms at 3.35 TB/s. The N*C exps per pixel are far below
// the SFU rate.
//
// Design: one thread per (b, p, 4 channels). It walks the N frames once
// with an online softmax in float32 (running max, running sum of exps,
// running weighted sum, both rescaled when the max rises), so each input
// element is read exactly once, with 16-byte loads that are coalesced
// across the threads of a warp, and only the fused value is written.
//
// bfloat16 (feat and logits in, out; the TPU kernel's bf16 arithmetic:
// max, exps and sums in float32, one rounding of the output): half the
// bytes, ~0.16 ms at that shape. The thread walks the frames twice in the
// Pallas body's order (the max; then s = sum exp(l - m), a = sum exp(l - m)
// f, frame by frame, each product and add rounded on its own; out = a / s),
// 8-byte loads; the second read of the logits is the thread's own recent
// one, from L1/L2. The plain version (ops/merge.py) takes the same steps
// in the same order, so the two agree bit for bit where their expf do.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Online {
  float m = -INFINITY;  // running max of the logits
  float s = 0.0f;       // running sum of exp(l - m)
  float a = 0.0f;       // running sum of exp(l - m) * feat

  __device__ __forceinline__ void add(float l, float f) {
    if (l > m) {
      const float r = expf(m - l);
      s *= r;
      a *= r;
      m = l;
    }
    const float e = expf(l - m);
    s += e;
    a = fmaf(e, f, a);
  }
};

__global__ void __launch_bounds__(kThreads)
merge_kernel(const float4* __restrict__ feat, const float4* __restrict__ logits,
             float4* __restrict__ out, int N, long long PC4, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long b = i / PC4;
  const long long base = b * N * PC4 + (i - b * PC4);
  Online ox, oy, oz, ow;
  for (int n = 0; n < N; ++n) {
    const float4 l = __ldg(logits + base + n * PC4);
    const float4 f = __ldg(feat + base + n * PC4);
    ox.add(l.x, f.x);
    oy.add(l.y, f.y);
    oz.add(l.z, f.z);
    ow.add(l.w, f.w);
  }
  out[i] = make_float4(ox.a / ox.s, oy.a / oy.s, oz.a / oz.s, ow.a / ow.s);
}

__global__ void __launch_bounds__(kThreads)
merge_bf16_kernel(const bf16* __restrict__ feat,
                  const bf16* __restrict__ logits, bf16* __restrict__ out,
                  int N, long long PC4, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long b = i / PC4;
  const long long base = (b * N * PC4 + (i - b * PC4)) * 4;
  const long long step = PC4 * 4;
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int n = 0; n < N; ++n) {
    const float4 l = load_bf16x4(logits + base + n * step);
    m[0] = fmaxf(m[0], l.x);
    m[1] = fmaxf(m[1], l.y);
    m[2] = fmaxf(m[2], l.z);
    m[3] = fmaxf(m[3], l.w);
  }
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int n = 0; n < N; ++n) {
    const float4 l4 = load_bf16x4(logits + base + n * step);
    const float4 f4 = load_bf16x4(feat + base + n * step);
    const float l[4] = {l4.x, l4.y, l4.z, l4.w};
    const float f[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float e = expf(__fsub_rn(l[k], m[k]));
      s[k] = __fadd_rn(s[k], e);
      a[k] = __fadd_rn(a[k], __fmul_rn(e, f[k]));
    }
  }
  store_bf16x4(out + i * 4,
               make_float4(__fdiv_rn(a[0], s[0]), __fdiv_rn(a[1], s[1]),
                           __fdiv_rn(a[2], s[2]), __fdiv_rn(a[3], s[3])));
}

template <typename T, typename Kernel>
int merge(Kernel kernel, const T* feat, const T* logits, T* out, int B, int N,
          int P, int C, void* stream) {
  if (C % 4 != 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long PC4 = static_cast<long long>(P) * (C / 4);
  const long long total = static_cast<long long>(B) * PC4;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(feat, logits, out, N, PC4,
                                                total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feat, logits [B, N, P, C]; out [B, P, C]; float32 or bfloat16 (all three
// the same), contiguous, 16-byte aligned; C % 4 == 0.
DBSR_EXPORT int dbsr_merge_f32(const float* feat, const float* logits,
                               float* out, int B, int N, int P, int C,
                               void* stream) {
  return merge(merge_kernel, reinterpret_cast<const float4*>(feat),
               reinterpret_cast<const float4*>(logits),
               reinterpret_cast<float4*>(out), B, N, P, C, stream);
}

DBSR_EXPORT int dbsr_merge_bf16(const bf16* feat, const bf16* logits,
                                bf16* out, int B, int N, int P, int C,
                                void* stream) {
  return merge(merge_bf16_kernel, feat, logits, out, B, N, P, C, stream);
}
