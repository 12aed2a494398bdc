// 81-channel +-4 local cost volume of channels-last float32 features:
//   out[b, y, x, (dy+4)*9 + (dx+4)] =
//       (1/C) * sum_c first[b, y, x, c] * second[b, y+dy, x+dx, c],
// zero padding outside `second`.
//
// Replaces the TPU kernel dbsr_tpu/ops/correlation.py:
// _correlation_pallas_fwd_impl (body _corr_kernel), which held a whole
// padded plane in VMEM and so only fit planes <= 16x16. This kernel takes
// any plane size: AlignLite calls it at 48x48 (C=24), 24x24 (C=48) and
// 12x12 (C=96).
//
// Bound on the H100: memory. The least traffic is one read of both inputs
// and one write of the 81-channel output: at AlignLite's level 0 with
// B*(N-1) = 104 frames, 104*2304*(24+24+81)*4 B ~ 124 MB, ~0.04 ms at
// 3.35 TB/s. The 2*81*C flops per pixel (~0.93 GFLOP at level 0) need
// ~0.014 ms at the 67 TFLOP/s float32 rate.
//
// Design: one block per (frame, kTY x kTX output tile). The block stages the
// tile of `first` and the +-4-halo'd tile of `second` (zeros outside the
// plane) in shared memory, one padded row of C+1 floats per pixel so that
// neighbouring pixels fall in different banks. Each thread then computes
// (pixel, displacement) outputs as a C-long dot product out of shared
// memory; consecutive threads take consecutive displacements of one pixel,
// so the stores of the 81 channels are coalesced.
#include "common.cuh"

namespace {

constexpr int kR = 4;                    // max displacement
constexpr int kD = 2 * kR + 1;           // 9
constexpr int kOff = kD * kD;            // 81
constexpr int kTY = 4;
constexpr int kTX = 8;
constexpr int kHY = kTY + 2 * kR;        // halo'd tile rows
constexpr int kHX = kTX + 2 * kR;        // halo'd tile cols
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr size_t smem_bytes(int C) {
  return static_cast<size_t>(kTY * kTX + kHY * kHX) * (C + 1) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
correlation_kernel(const float* __restrict__ first,
                   const float* __restrict__ second, float* __restrict__ out,
                   int H, int W, int C) {
  extern __shared__ float smem[];
  const int Cp = C + 1;
  float* s_first = smem;                    // [kTY*kTX][Cp]
  float* s_second = smem + kTY * kTX * Cp;  // [kHY*kHX][Cp]

  const int tiles_x = (W + kTX - 1) / kTX;
  const int ty0 = (blockIdx.x / tiles_x) * kTY;
  const int tx0 = (blockIdx.x % tiles_x) * kTX;
  const long long frame = blockIdx.y;
  const float* fb = first + frame * H * W * C;
  const float* sb = second + frame * H * W * C;

  for (int i = threadIdx.x; i < kTY * kTX * C; i += kThreads) {
    const int q = i / C;
    const int c = i - q * C;
    const int y = ty0 + q / kTX;
    const int x = tx0 + q % kTX;
    s_first[q * Cp + c] =
        (y < H && x < W) ? fb[(static_cast<long long>(y) * W + x) * C + c] : 0.0f;
  }
  for (int i = threadIdx.x; i < kHY * kHX * C; i += kThreads) {
    const int q = i / C;
    const int c = i - q * C;
    const int y = ty0 - kR + q / kHX;
    const int x = tx0 - kR + q % kHX;
    s_second[q * Cp + c] = (y >= 0 && y < H && x >= 0 && x < W)
        ? sb[(static_cast<long long>(y) * W + x) * C + c] : 0.0f;
  }
  __syncthreads();

  const float fc = static_cast<float>(C);
  for (int i = threadIdx.x; i < kTY * kTX * kOff; i += kThreads) {
    const int q = i / kOff;
    const int o = i - q * kOff;
    const int qy = q / kTX;
    const int qx = q % kTX;
    const int y = ty0 + qy;
    const int x = tx0 + qx;
    if (y >= H || x >= W) continue;
    const int dy = o / kD;  // displacement + kR
    const int dx = o % kD;
    const float* a = s_first + q * Cp;
    const float* s = s_second + ((qy + dy) * kHX + qx + dx) * Cp;
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) acc = fmaf(a[c], s[c], acc);
    out[((frame * H + y) * W + x) * kOff + o] = acc / fc;
  }
}

}  // namespace

// first, second [frames, H, W, C]; out [frames, H, W, 81]; float32,
// contiguous. C is limited by shared memory: (224 * (C + 1) * 4) B <= 227 KB.
DBSR_EXPORT int dbsr_correlation_f32(const float* first, const float* second,
                                     float* out, int frames, int H, int W,
                                     int C, void* stream) {
  const size_t smem = smem_bytes(C);
  if (C <= 0 || smem > kMaxSmem || frames > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0 || H == 0 || W == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        correlation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = ((H + kTY - 1) / kTY) * ((W + kTX - 1) / kTX);
  const dim3 grid(tiles, frames);
  correlation_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      first, second, out, H, W, C);
  return static_cast<int>(cudaGetLastError());
}
