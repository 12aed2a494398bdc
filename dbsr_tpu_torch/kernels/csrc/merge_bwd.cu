// Backward of the frame-softmax weighted sum (merge.cu), float32,
// channels-last, for the output gradient g [B, P, C]:
//   w_n         = softmax_n(logits[b, :, p, c])
//   fused       = sum_n w_n * feat_n
//   dfeat_n     = w_n * g
//   dlogits_n   = w_n * g * (feat_n - fused)
//
// Replaces the TPU kernel dbsr_tpu/ops/merge_pallas.py:_merge_bwd_impl
// (body _merge_bwd_kernel), which loaded [N, T, Cb] tiles of feat and
// logits into VMEM, recomputed the weights there and wrote both gradients.
//
// Bound on the H100: memory. One read of feat, logits and g and one write
// of dfeat and dlogits: at the training merge's [16, 8, 48, 48, 512] that
// is 2 * 604 MB + 75 MB read and 2 * 604 MB written, ~2.49 GB, ~0.74 ms at
// 3.35 TB/s. The N exps per element (twice) are far below the SFU rate.
//
// Design: one thread per (b, p, 4 channels), 16-byte loads and stores
// coalesced across a warp. Pass 1 walks the N frames with an online softmax
// (running max, running sum of exps, running weighted sum, rescaled when the
// max rises), which gives the max, the normaliser and fused in float32.
// Pass 2 walks the frames again, recomputes w_n = exp(l - max) / sum and
// writes both gradients. Pass 2 re-reads feat and logits (the weights are
// never written to memory); N is a runtime loop bound (8 in training).
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

__device__ __forceinline__ void grads(const Online& o, float l, float f,
                                      float g, float& df, float& dl) {
  const float w = expf(l - o.m) / o.s;
  const float wg = w * g;
  df = wg;
  dl = wg * (f - o.a / o.s);
}

__global__ void __launch_bounds__(kThreads)
merge_bwd_kernel(const float4* __restrict__ feat,
                 const float4* __restrict__ logits,
                 const float4* __restrict__ g, float4* __restrict__ dfeat,
                 float4* __restrict__ dlogits, int N, long long PC4,
                 long long total) {
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
  const float4 gv = __ldg(g + i);
  for (int n = 0; n < N; ++n) {
    const long long j = base + n * PC4;
    const float4 l = __ldg(logits + j);
    const float4 f = __ldg(feat + j);
    float4 df, dl;
    grads(ox, l.x, f.x, gv.x, df.x, dl.x);
    grads(oy, l.y, f.y, gv.y, df.y, dl.y);
    grads(oz, l.z, f.z, gv.z, df.z, dl.z);
    grads(ow, l.w, f.w, gv.w, df.w, dl.w);
    dfeat[j] = df;
    dlogits[j] = dl;
  }
}

}  // namespace

// feat, logits, dfeat, dlogits [B, N, P, C]; g [B, P, C]; float32,
// contiguous, 16-byte aligned; C % 4 == 0.
DBSR_EXPORT int dbsr_merge_bwd_f32(const float* feat, const float* logits,
                                   const float* g, float* dfeat,
                                   float* dlogits, int B, int N, int P, int C,
                                   void* stream) {
  if (C % 4 != 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long PC4 = static_cast<long long>(P) * (C / 4);
  const long long total = static_cast<long long>(B) * PC4;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  merge_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(feat),
      reinterpret_cast<const float4*>(logits),
      reinterpret_cast<const float4*>(g), reinterpret_cast<float4*>(dfeat),
      reinterpret_cast<float4*>(dlogits), N, PC4, total);
  return static_cast<int>(cudaGetLastError());
}
