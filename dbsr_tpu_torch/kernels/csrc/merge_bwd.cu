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
//
// dbsr_merge_bwd_bf16 (bf16 feat, logits, g and both gradients; the TPU
// kernel's bf16 arithmetic: float32 math, one rounding of each output):
// half the bytes, ~1.25 GB, ~0.37 ms at that shape. In dlogits the
// difference f - fused cancels, so a fused computed otherwise than the
// Pallas body's flips bf16 roundings; the thread takes the body's steps in
// its order, frame by frame, each product and add rounded on its own
// (_rn intrinsics, never contracted): the max m; s = sum exp(l - m);
// w = exp(l - m) / s; fused = sum w f; then per frame dfeat = w g and
// dlogits = w g (f - fused). The logits are read three times and feat
// twice, 8-byte loads, the later reads the thread's own recent ones, from
// L1/L2. The plain version (ops/merge.py) takes the same steps in the same
// order, so the two agree bit for bit where their expf do.
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

__global__ void __launch_bounds__(kThreads)
merge_bwd_bf16_kernel(const bf16* __restrict__ feat,
                      const bf16* __restrict__ logits,
                      const bf16* __restrict__ g, bf16* __restrict__ dfeat,
                      bf16* __restrict__ dlogits, int N, long long PC4,
                      long long total) {
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
  for (int n = 0; n < N; ++n) {
    const float4 l4 = load_bf16x4(logits + base + n * step);
    const float l[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      s[k] = __fadd_rn(s[k], expf(__fsub_rn(l[k], m[k])));
  }
  float fused[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int n = 0; n < N; ++n) {
    const float4 l4 = load_bf16x4(logits + base + n * step);
    const float4 f4 = load_bf16x4(feat + base + n * step);
    const float l[4] = {l4.x, l4.y, l4.z, l4.w};
    const float f[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float w = __fdiv_rn(expf(__fsub_rn(l[k], m[k])), s[k]);
      fused[k] = __fadd_rn(fused[k], __fmul_rn(w, f[k]));
    }
  }
  const float4 g4 = load_bf16x4(g + i * 4);
  const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
  for (int n = 0; n < N; ++n) {
    const long long j = base + n * step;
    const float4 l4 = load_bf16x4(logits + j);
    const float4 f4 = load_bf16x4(feat + j);
    const float l[4] = {l4.x, l4.y, l4.z, l4.w};
    const float f[4] = {f4.x, f4.y, f4.z, f4.w};
    float df[4], dl[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float w = __fdiv_rn(expf(__fsub_rn(l[k], m[k])), s[k]);
      df[k] = __fmul_rn(w, gv[k]);
      dl[k] = __fmul_rn(df[k], __fsub_rn(f[k], fused[k]));
    }
    store_bf16x4(dfeat + j, make_float4(df[0], df[1], df[2], df[3]));
    store_bf16x4(dlogits + j, make_float4(dl[0], dl[1], dl[2], dl[3]));
  }
}

template <typename T, typename Kernel>
int merge_bwd(Kernel kernel, const T* feat, const T* logits, const T* g,
              T* dfeat, T* dlogits, int B, int N, int P, int C, void* stream) {
  if (C % 4 != 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long PC4 = static_cast<long long>(P) * (C / 4);
  const long long total = static_cast<long long>(B) * PC4;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(feat, logits, g, dfeat,
                                                dlogits, N, PC4, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feat, logits, dfeat, dlogits [B, N, P, C]; g [B, P, C]; float32 (or
// bfloat16: dbsr_merge_bwd_bf16, all five the same), contiguous, 16-byte
// aligned; C % 4 == 0.
DBSR_EXPORT int dbsr_merge_bwd_f32(const float* feat, const float* logits,
                                   const float* g, float* dfeat,
                                   float* dlogits, int B, int N, int P, int C,
                                   void* stream) {
  return merge_bwd(merge_bwd_kernel, reinterpret_cast<const float4*>(feat),
                   reinterpret_cast<const float4*>(logits),
                   reinterpret_cast<const float4*>(g),
                   reinterpret_cast<float4*>(dfeat),
                   reinterpret_cast<float4*>(dlogits), B, N, P, C, stream);
}

DBSR_EXPORT int dbsr_merge_bwd_bf16(const bf16* feat, const bf16* logits,
                                    const bf16* g, bf16* dfeat,
                                    bf16* dlogits, int B, int N, int P, int C,
                                    void* stream) {
  return merge_bwd(merge_bwd_bf16_kernel, feat, logits, g, dfeat, dlogits, B,
                   N, P, C, stream);
}
