// Backward of the bilinear backward warp (warp.cu), float32, channels-last:
//   out[b, p, c] = sum over the 4 floor taps q of (p + flow[b, p]) of
//                  w_q * feat[b, q, c],  out-of-range taps weigh 0.
//
// Replaces the TPU kernels of dbsr_tpu/ops/warp_pallas.py:_warp_bwd_pallas:
// _dfeat_kernel (the transposed one-hot operator riding the MXU) and
// _dflow_kernel (derivative one-hot operators against the features). The
// card scatters and gathers well, so neither builds an operator matrix.
//
// Tap geometry is warp_pallas._tap_weights': floor taps, weights
// (1-wy)(1-wx), (1-wy)wx, wy(1-wx), wy wx, with d/dx and d/dy of each taken
// through frac = c - floor(c) (the one-sided difference feat[i+1] - feat[i]
// at an integer coordinate, which is what the gather VJP and grid_sample
// give), and weight and derivatives 0 for an out-of-range tap.
//
// dbsr_warp_dfeat_f32 -- d_feat = W^T g. Bound on the H100: memory; the
// least traffic is one read of g and flow and one write of d_feat: at the
// encoder's [112, 48, 48, 512] ~1.06 GB, ~0.32 ms at 3.35 TB/s. Design:
// scatter form. One block per tile of kPix output pixels of one frame; the
// first kPix threads compute each pixel's tap offsets and weights once into
// shared memory; then all threads walk (pixel, 4-channel group) pairs, load
// g with a 16-byte load and atomicAdd w_tap * g into the taps of the zeroed
// output (the wrapper zeroes it on the stream), one 16-byte (float4) atomic
// per tap and 4-channel group. The order of the atomic sums is not fixed,
// so the result matches the plain version to rounding.
//
// dbsr_warp_dflow_f32 -- d_flow[p] = sum_c g[p, c] * sum_tap dw_tap/d(x,y) *
// feat[tap, c]. Bound: memory; one read of g and feat (+ flow), ~1.06 GB at
// the encoder's shape, ~0.32 ms. Design: one warp per output pixel; its
// lanes walk the channels in 4-channel groups (16-byte loads of g and of
// the four taps of feat), accumulate both sums in registers and reduce
// them with shuffles; lane 0 writes the pixel's two values.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 16;

struct Taps {
  long long off[4];  // element offset of each tap in the frame (clamped)
  float w[4];        // tap weight, 0 out of range
  float dx[4];       // d w / d x, 0 out of range
  float dy[4];       // d w / d y, 0 out of range
};

__device__ __forceinline__ Taps tap_geometry(const float* fl, int p, int H,
                                             int W, int C) {
  Taps t;
  const float x = __fadd_rn(static_cast<float>(p % W), fl[0]);
  const float y = __fadd_rn(static_cast<float>(p / W), fl[1]);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float wx = __fsub_rn(x, x0);
  const float wy = __fsub_rn(y, y0);
  const float ax = __fsub_rn(1.0f, wx);
  const float ay = __fsub_rn(1.0f, wy);
  const float w[4] = {__fmul_rn(ay, ax), __fmul_rn(ay, wx), __fmul_rn(wy, ax),
                      __fmul_rn(wy, wx)};
  const float dx[4] = {-ay, ay, -wy, wy};
  const float dy[4] = {-ax, -wx, ax, wx};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float yi = y0 + static_cast<float>(k >> 1);
    const float xi = x0 + static_cast<float>(k & 1);
    const bool valid = yi >= 0.0f && yi < static_cast<float>(H) && xi >= 0.0f &&
                       xi < static_cast<float>(W);
    const int yc = static_cast<int>(fminf(fmaxf(yi, 0.0f), H - 1.0f));
    const int xc = static_cast<int>(fminf(fmaxf(xi, 0.0f), W - 1.0f));
    t.off[k] = (static_cast<long long>(yc) * W + xc) * C;
    t.w[k] = valid ? w[k] : 0.0f;
    t.dx[k] = valid ? dx[k] : 0.0f;
    t.dy[k] = valid ? dy[k] : 0.0f;
  }
  return t;
}

__global__ void __launch_bounds__(kThreads)
dfeat_kernel(const float* __restrict__ flow, const float* __restrict__ g,
             float* __restrict__ dfeat, int H, int W, int C) {
  __shared__ long long s_off[kPix][4];
  __shared__ float s_w[kPix][4];

  const int P = H * W;
  const long long frame = blockIdx.y;
  const int p0 = blockIdx.x * kPix;
  const int npix = min(kPix, P - p0);

  if (threadIdx.x < npix) {
    const int p = p0 + threadIdx.x;
    const Taps t = tap_geometry(flow + (frame * P + p) * 2, p, H, W, C);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s_off[threadIdx.x][k] = t.off[k];
      s_w[threadIdx.x][k] = t.w[k];
    }
  }
  __syncthreads();

  const int C4 = C / 4;
  const float* gb = g + (frame * P + p0) * C;
  float* db = dfeat + frame * P * C;
  for (int i = threadIdx.x; i < npix * C4; i += kThreads) {
    const int q = i / C4;
    const int c = (i - q * C4) * 4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        gb + static_cast<long long>(q) * C + c));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float w = s_w[q][k];
      if (w == 0.0f) continue;  // out of range, or a zero-weight tap
      // sm_90's 16-byte atomicAdd on global memory: one atomic per
      // 4-channel group (d is 16-byte aligned: C % 4 == 0, c % 4 == 0)
      atomicAdd(reinterpret_cast<float4*>(db + s_off[q][k] + c),
                make_float4(__fmul_rn(v.x, w), __fmul_rn(v.y, w),
                            __fmul_rn(v.z, w), __fmul_rn(v.w, w)));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dflow_kernel(const float* __restrict__ feat, const float* __restrict__ flow,
             const float* __restrict__ g, float* __restrict__ dflow, int P,
             int H, int W, int C, long long total) {
  const long long pix = (static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (pix >= total) return;  // whole warps leave together
  const long long frame = pix / P;
  const int p = static_cast<int>(pix - frame * P);
  const Taps t = tap_geometry(flow + pix * 2, p, H, W, C);
  const float* fb = feat + frame * P * C;
  const float* gp = g + pix * C;
  float sx = 0.0f, sy = 0.0f;
  for (int c = lane * 4; c < C; c += 128) {
    const float4 gv = __ldg(reinterpret_cast<const float4*>(gp + c));
    float4 fx = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 fy = fx;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (t.dx[k] == 0.0f && t.dy[k] == 0.0f) continue;
      const float4 v = __ldg(reinterpret_cast<const float4*>(fb + t.off[k] + c));
      fx.x = fmaf(t.dx[k], v.x, fx.x);
      fx.y = fmaf(t.dx[k], v.y, fx.y);
      fx.z = fmaf(t.dx[k], v.z, fx.z);
      fx.w = fmaf(t.dx[k], v.w, fx.w);
      fy.x = fmaf(t.dy[k], v.x, fy.x);
      fy.y = fmaf(t.dy[k], v.y, fy.y);
      fy.z = fmaf(t.dy[k], v.z, fy.z);
      fy.w = fmaf(t.dy[k], v.w, fy.w);
    }
    sx += gv.x * fx.x + gv.y * fx.y + gv.z * fx.z + gv.w * fx.w;
    sy += gv.x * fy.x + gv.y * fy.y + gv.z * fy.z + gv.w * fy.w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sx += __shfl_down_sync(0xffffffffu, sx, o);
    sy += __shfl_down_sync(0xffffffffu, sy, o);
  }
  if (lane == 0) {
    dflow[pix * 2] = sx;
    dflow[pix * 2 + 1] = sy;
  }
}

}  // namespace

// flow [frames, H, W, 2], g and dfeat [frames, H, W, C]; all float32,
// contiguous, 16-byte aligned; C % 4 == 0; dfeat zeroed by the caller.
DBSR_EXPORT int dbsr_warp_dfeat_f32(const float* flow, const float* g,
                                    float* dfeat, int frames, int H, int W,
                                    int C, void* stream) {
  if (C % 4 != 0 || frames > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0 || H == 0 || W == 0 || C == 0) return 0;
  const dim3 grid((H * W + kPix - 1) / kPix, frames);
  dfeat_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      flow, g, dfeat, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

// feat and g [frames, H, W, C], flow and dflow [frames, H, W, 2]; all
// float32, contiguous, 16-byte aligned; C % 4 == 0.
DBSR_EXPORT int dbsr_warp_dflow_f32(const float* feat, const float* flow,
                                    const float* g, float* dflow, int frames,
                                    int H, int W, int C, void* stream) {
  if (C % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(frames) * H * W;
  if (total == 0 || C == 0) return 0;
  const long long blocks = (total * 32 + kThreads - 1) / kThreads;
  dflow_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      feat, flow, g, dflow, H * W, H, W, C, total);
  return static_cast<int>(cudaGetLastError());
}
