// Backward of the 81-channel +-4 local cost volume (correlation.cu), for the
// output gradient g [frames, H, W, 81], channels-last float32:
//   d_first [b, y, x, c] = (1/C) * sum_o g[b, y, x, o]
//                                        * second[b, y+dy_o, x+dx_o, c]
//   d_second[b, v, w, c] = (1/C) * sum_o g[b, v-dy_o, w-dx_o, o]
//                                        * first [b, v-dy_o, w-dx_o, c]
// with o = (dy+4)*9 + (dx+4), dy, dx in [-4, 4]; a term whose read position
// falls outside the plane is zero. Both are gathers: no scatter, no atomics,
// the same result on every run.
//
// Replaces the TPU kernels of dbsr_tpu/ops/correlation.py:
// _correlation_pallas_bwd_impl (bodies _corr_dfirst_kernel and
// _corr_dsecond_kernel), which held a whole padded plane in VMEM and so only
// fit planes <= 16x16. These take any plane size: AlignLite's training calls
// them at 48x48 (C=24), 24x24 (C=48) and 12x12 (C=96).
//
// Bound on the H100: memory. The least traffic of either kernel is one read
// of one operand and of g and one write of the gradient: at AlignLite's
// level 0 with 112 frames, 112*2304*(24+81+24)*4 B ~ 133 MB, ~0.04 ms at
// 3.35 TB/s; its 2*81*C flops per pixel (~1 GFLOP) need ~0.015 ms at the
// 67 TFLOP/s float32 rate.
//
// Design: one block per (frame, kTY x kTX output tile), as the forward. The
// block stages in shared memory, with zeros outside the plane,
//   d_first : g on the tile and `second` on the +-4-halo'd tile;
//   d_second: g (all 81 channels) and `first`, both on the halo'd tile,
// and each thread then sums the 81 terms of (pixel, channel) outputs out of
// shared memory. Consecutive threads take consecutive channels of one pixel:
// the operand reads fall in consecutive banks, the g read is a broadcast,
// and the stores are coalesced. Channels are processed in chunks of at most
// kChunk so that the staged operand stays within a block's shared memory at
// any C; g is staged once. The staged tiles exceed 48 KB (d_second: 62 KB of
// g alone), so the launch opts in to large dynamic shared memory.
#include "common.cuh"

namespace {

constexpr int kR = 4;                    // max displacement
constexpr int kD = 2 * kR + 1;           // 9
constexpr int kOff = kD * kD;            // 81
constexpr int kTY = 4;
constexpr int kTX = 8;
constexpr int kTile = kTY * kTX;         // 32 output pixels
constexpr int kHY = kTY + 2 * kR;        // halo'd tile rows
constexpr int kHX = kTX + 2 * kR;        // halo'd tile cols
constexpr int kHalo = kHY * kHX;         // 192 staged pixels
constexpr int kChunk = 128;              // channels staged at a time
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int chunk_of(int C) {
  return C < kChunk ? C : kChunk;
}

__host__ __device__ constexpr size_t dfirst_smem(int C) {
  return static_cast<size_t>(kTile * kOff + kHalo * chunk_of(C)) * sizeof(float);
}

__host__ __device__ constexpr size_t dsecond_smem(int C) {
  return static_cast<size_t>(kHalo * kOff + kHalo * chunk_of(C)) * sizeof(float);
}

// Stage channels [c0, c0 + cc) of `src` [H, W, C] on the halo'd tile whose
// first pixel is (ty0 - kR, tx0 - kR) into dst [kHalo][cc]; zeros outside.
__device__ __forceinline__ void stage_halo(float* dst, const float* src,
                                           int ty0, int tx0, int H, int W,
                                           int C, int c0, int cc) {
  for (int i = threadIdx.x; i < kHalo * cc; i += kThreads) {
    const int q = i / cc;
    const int c = i - q * cc;
    const int y = ty0 - kR + q / kHX;
    const int x = tx0 - kR + q % kHX;
    dst[i] = (y >= 0 && y < H && x >= 0 && x < W)
        ? src[(static_cast<long long>(y) * W + x) * C + c0 + c] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
correlation_dfirst_kernel(const float* __restrict__ second,
                          const float* __restrict__ g,
                          float* __restrict__ dfirst, int H, int W, int C) {
  extern __shared__ float smem[];
  float* s_g = smem;                     // [kTile][kOff]
  float* s_second = smem + kTile * kOff; // [kHalo][cc]

  const int tiles_x = (W + kTX - 1) / kTX;
  const int ty0 = (blockIdx.x / tiles_x) * kTY;
  const int tx0 = (blockIdx.x % tiles_x) * kTX;
  const long long frame = blockIdx.y;
  const float* sb = second + frame * H * W * C;
  const float* gb = g + frame * H * W * kOff;
  float* ob = dfirst + frame * H * W * C;

  for (int i = threadIdx.x; i < kTile * kOff; i += kThreads) {
    const int q = i / kOff;
    const int o = i - q * kOff;
    const int y = ty0 + q / kTX;
    const int x = tx0 + q % kTX;
    s_g[i] = (y < H && x < W)
        ? gb[(static_cast<long long>(y) * W + x) * kOff + o] : 0.0f;
  }

  const float inv_c = 1.0f / static_cast<float>(C);
  const int chunk = chunk_of(C);
  for (int c0 = 0; c0 < C; c0 += chunk) {
    const int cc = (C - c0 < chunk) ? C - c0 : chunk;
    __syncthreads();  // the previous chunk's readers are done (and s_g is in)
    stage_halo(s_second, sb, ty0, tx0, H, W, C, c0, cc);
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * cc; i += kThreads) {
      const int q = i / cc;
      const int c = i - q * cc;
      const int qy = q / kTX;
      const int qx = q % kTX;
      const int y = ty0 + qy;
      const int x = tx0 + qx;
      if (y >= H || x >= W) continue;
      const float* gq = s_g + q * kOff;
      float acc = 0.0f;
      for (int iy = 0; iy < kD; ++iy) {
        // second[y + dy, x + dx] with dy = iy - kR sits at halo row qy + iy
        const float* row = s_second + ((qy + iy) * kHX + qx) * cc + c;
#pragma unroll
        for (int ix = 0; ix < kD; ++ix)
          acc = fmaf(gq[iy * kD + ix], row[ix * cc], acc);
      }
      ob[(static_cast<long long>(y) * W + x) * C + c0 + c] = acc * inv_c;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
correlation_dsecond_kernel(const float* __restrict__ first,
                           const float* __restrict__ g,
                           float* __restrict__ dsecond, int H, int W, int C) {
  extern __shared__ float smem[];
  float* s_g = smem;                     // [kHalo][kOff]
  float* s_first = smem + kHalo * kOff;  // [kHalo][cc]

  const int tiles_x = (W + kTX - 1) / kTX;
  const int ty0 = (blockIdx.x / tiles_x) * kTY;
  const int tx0 = (blockIdx.x % tiles_x) * kTX;
  const long long frame = blockIdx.y;
  const float* fb = first + frame * H * W * C;
  const float* gb = g + frame * H * W * kOff;
  float* ob = dsecond + frame * H * W * C;

  stage_halo(s_g, gb, ty0, tx0, H, W, kOff, 0, kOff);

  const float inv_c = 1.0f / static_cast<float>(C);
  const int chunk = chunk_of(C);
  for (int c0 = 0; c0 < C; c0 += chunk) {
    const int cc = (C - c0 < chunk) ? C - c0 : chunk;
    __syncthreads();
    stage_halo(s_first, fb, ty0, tx0, H, W, C, c0, cc);
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * cc; i += kThreads) {
      const int q = i / cc;
      const int c = i - q * cc;
      const int qy = q / kTX;
      const int qx = q % kTX;
      const int v = ty0 + qy;
      const int w = tx0 + qx;
      if (v >= H || w >= W) continue;
      float acc = 0.0f;
      for (int iy = 0; iy < kD; ++iy) {
        // the read position (v - dy, w - dx), dy = iy - kR, dx = ix - kR, is
        // halo pixel (qy + 2 kR - iy, qx + 2 kR - ix); outside the plane both
        // staged tiles hold zeros
        const int p0 = (qy + 2 * kR - iy) * kHX + qx + 2 * kR;
#pragma unroll
        for (int ix = 0; ix < kD; ++ix) {
          const int p = p0 - ix;
          acc = fmaf(s_g[p * kOff + iy * kD + ix], s_first[p * cc + c], acc);
        }
      }
      ob[(static_cast<long long>(v) * W + w) * C + c0 + c] = acc * inv_c;
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const float* operand, const float* g,
           float* out, int frames, int H, int W, int C, void* stream) {
  if (C <= 0 || smem > kMaxSmem || frames > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0 || H == 0 || W == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = ((H + kTY - 1) / kTY) * ((W + kTX - 1) / kTX);
  const dim3 grid(tiles, frames);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      operand, g, out, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// second, dfirst [frames, H, W, C]; g [frames, H, W, 81]; float32, contiguous.
DBSR_EXPORT int dbsr_correlation_dfirst_f32(const float* second, const float* g,
                                            float* dfirst, int frames, int H,
                                            int W, int C, void* stream) {
  return launch(correlation_dfirst_kernel, dfirst_smem(C), second, g, dfirst,
                frames, H, W, C, stream);
}

// first, dsecond [frames, H, W, C]; g [frames, H, W, 81]; float32, contiguous.
DBSR_EXPORT int dbsr_correlation_dsecond_f32(const float* first, const float* g,
                                             float* dsecond, int frames, int H,
                                             int W, int C, void* stream) {
  return launch(correlation_dsecond_kernel, dsecond_smem(C), first, g, dsecond,
                frames, H, W, C, stream);
}
