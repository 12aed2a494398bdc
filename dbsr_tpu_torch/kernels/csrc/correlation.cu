// 81-channel +-4 local cost volume of channels-last features:
//   out[b, y, x, (dy+4)*9 + (dx+4)] =
//       (1/C) * sum_c first[b, y, x, c] * second[b, y+dy, x+dx, c],
// zero padding outside `second`; float32, or bfloat16 in and out with the
// sums, the 1/C and the division in float32 and one rounding of each
// output (the TPU kernel's bf16 arithmetic).
//
// Replaces the TPU kernel dbsr_tpu/ops/correlation.py:
// _correlation_pallas_fwd_impl (body _corr_kernel), which held a whole
// padded plane in VMEM and so only fit planes <= 16x16. This kernel takes
// any plane and any C >= 1: AlignLite calls it at 48x48 (C=24), 24x24
// (C=48) and 12x12 (C=96); PWC-Net's pyramid goes up to 196 channels.
//
// Bound on the H100: memory. The least traffic is one read of both inputs
// and one write of the 81-channel output: at AlignLite's level 0 with
// B*(N-1) = 104 frames, 104*2304*(24+24+81)*4 B ~ 124 MB, ~0.037 ms at
// 3.35 TB/s. The 81*C multiply-adds per pixel (~0.47 G at level 0) need
// ~0.014 ms at the 67 TFLOP/s float32 rate.
//
// Design: register tiling. One block per (frame, TY x TX output tile) and
// 9*TY*TX/4 threads: thread (dy, 4-pixel group, row) keeps 4 adjacent
// pixels of one row x the 9 dx of one dy, 36 sums, in registers. Per 4
// channels it reads the 4 pixels of `first` and the 12 pixels of `second`
// they share as 16-byte shared loads: 16 LDS.128 per 144 FMAs (one
// output a thread would take a shared-load pair per FMA). A quarter
// warp's 8 threads read 8 rows at odd float4 row strides: no bank
// conflicts. Each sum runs over the channels in order, by fmaf.
// - Tiles: 8x12 (halo'd 16x20) where the plane is larger than 12x12: 12
//   divides AlignLite's 48 and 24, so no column of a block idles; else one
//   12x12 tile (AlignLite's level 2, whole). The halo's re-reads come from
//   L2.
// - Channels are staged 8 at a time by cp.async, double-buffered: the
//   next chunk's copies fly while the current one is summed; zero-filled
//   outside the plane and past C (16-byte copies when C % 4 == 0, else
//   4-byte ones), so any C >= 1 runs in the same stages. Each thread's
//   copies (shared-memory slot, source pixel) are worked out once.
// - Output: each sum divided by C as IEEE division rounds it (see the
//   epilogue), staged in shared memory displacement-major (row stride odd,
//   columns swizzled by row: a warp's stores fall on 32 banks); each tile
//   row's pixels' 81 values, contiguous in `out`, go out as coalesced
//   stores.
// - bf16: the same stages hold float32, widened from bf16 on the way in:
//   each thread's copies are 8-byte loads into registers (4 channels; 2-byte
//   loads when C % 4 != 0), issued for the next chunk before the current
//   one is summed and stored to shared memory after it. The products of
//   two bf16 values are exact in float32, so every fmaf is one rounded add
//   and each sum is the plain version's channel loop bit for bit
//   (ops/correlation.py:correlation_plain); outputs round to bf16 once.
// - At most 47 KB of static shared memory: no opt-in attribute.
// Single pass, no atomics: deterministic.
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kR = 4;             // max displacement
constexpr int kD = 2 * kR + 1;    // 9
constexpr int kOff = kD * kD;     // 81
constexpr int kK = 4;             // adjacent output pixels of a thread
constexpr int kCK = 8;            // channels per staged chunk
constexpr int kG4 = kCK / 4;      // 4-channel groups per chunk

template <int TY, int NG>
struct Tile {
  static constexpr int kTX = NG * kK;
  static constexpr int kHY = TY + 2 * kR;  // halo'd tile of `second`
  static constexpr int kHX = kTX + 2 * kR;
  static constexpr int kRowF = kTX + 1;    // row strides in float4s, odd
  static constexpr int kRowS = kHX + 1;
  static constexpr int kFirst = kG4 * TY * kRowF;   // float4s of a stage
  static constexpr int kStage = kFirst + kG4 * kHY * kRowS;
  static constexpr int kOutRow = TY * kTX + 1;      // odd
  static constexpr int kSmem4 = 2 * kStage > (kOff * kOutRow + 3) / 4
                                    ? 2 * kStage
                                    : (kOff * kOutRow + 3) / 4;  // float4s
  static constexpr int kThreads = kD * TY * NG;
  // cp.async copies of a stage: the tile of `first`, then the halo'd tile
  // of `second`, kG4 per pixel; thread t makes t, t + kThreads, ..
  static constexpr int kNF = kG4 * TY * kTX;
  static constexpr int kCopies = kNF + kG4 * kHY * kHX;
  static constexpr int kSlots = (kCopies + kThreads - 1) / kThreads;
  static_assert(kThreads % kG4 == 0, "a thread's copies share one c4");
};

template <int TY, int NG, bool kVec, typename E>
__global__ void __launch_bounds__(Tile<TY, NG>::kThreads)
correlation_kernel(const E* __restrict__ first,
                   const E* __restrict__ second, E* __restrict__ out,
                   int H, int W, int C, int tiles_x, int tiles) {
  using T = Tile<TY, NG>;
  constexpr bool kF32 = std::is_same<E, float>::value;
  // two stages of [kG4][TY][kRowF] (`first`) + [kG4][kHY][kRowS]
  // (`second`) float4s; once the sums are done, the outputs [81][kOutRow]
  __shared__ float4 smem[T::kSmem4];
  float* s_out = reinterpret_cast<float*>(smem);

  const int tile = blockIdx.x % tiles;
  const long long frame = blockIdx.x / tiles;
  const int ty0 = (tile / tiles_x) * TY;
  const int tx0 = (tile % tiles_x) * T::kTX;
  const long long plane = static_cast<long long>(H) * W;
  const E* fb = first + frame * plane * C;
  const E* sb = second + frame * plane * C;

  // this thread's copies, the same in every stage but for the channels:
  // the float4 in a stage (-1: none), and the source pixel in the frame
  // (-1 outside the plane)
  const int c4 = threadIdx.x % kG4;
  int dst[T::kSlots], pix[T::kSlots];
#pragma unroll
  for (int n = 0; n < T::kSlots; ++n) {
    const int i = threadIdx.x + n * T::kThreads;
    const bool is_first = i < T::kNF;
    const int p = (is_first ? i : i - T::kNF) / kG4;
    const int py = is_first ? p / T::kTX : p / T::kHX;
    const int px = is_first ? p - py * T::kTX : p - py * T::kHX;
    const int y = is_first ? ty0 + py : ty0 - kR + py;
    const int x = is_first ? tx0 + px : tx0 - kR + px;
    dst[n] = i >= T::kCopies ? -1
             : is_first ? (c4 * TY + py) * T::kRowF + px
                        : T::kFirst + (c4 * T::kHY + py) * T::kRowS + px;
    pix[n] = y >= 0 && y < H && x >= 0 && x < W ? y * W + x : -1;
  }
  // float32: copy channels c0.. of the tiles into stage buffer buf
  auto stage = [&](int buf, int c0) {
    float4* st = smem + buf * T::kStage;
    const int c = c0 + c4 * 4;
#pragma unroll
    for (int n = 0; n < T::kSlots; ++n) {
      if (dst[n] < 0) continue;
      const E* base = dst[n] < T::kFirst ? fb : sb;
      const E* src = base + static_cast<long long>(pix[n]) * C + c;
      float* d = reinterpret_cast<float*>(st + dst[n]);
      if constexpr (kVec) {
        const bool ok = pix[n] >= 0 && c < C;  // C % 4 == 0: all or none
        cp_async<16>(d, ok ? src : base, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = pix[n] >= 0 && c + e < C;
          cp_async<4>(d + e, ok ? src + e : base, ok ? 4 : 0);
        }
      }
    }
  };
  // bf16: the copies of channels c0.. into registers (zeros outside the
  // plane and past C), then widened into stage buffer buf
  float4 pre[T::kSlots];
  auto fetch = [&](int c0) {
    const int c = c0 + c4 * 4;
#pragma unroll
    for (int n = 0; n < T::kSlots; ++n) {
      pre[n] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (dst[n] < 0 || pix[n] < 0) continue;
      const E* src = (dst[n] < T::kFirst ? fb : sb)
                     + static_cast<long long>(pix[n]) * C + c;
      if constexpr (!kF32) {
        if constexpr (kVec) {
          if (c < C) pre[n] = load_bf16x4(src);
        } else {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = c + e < C ? load_bf16(src + e)
                                                       : 0.0f;
          pre[n] = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  };
  auto put = [&](int buf) {
    float4* st = smem + buf * T::kStage;
#pragma unroll
    for (int n = 0; n < T::kSlots; ++n)
      if (dst[n] >= 0) st[dst[n]] = pre[n];
  };

  const int r = threadIdx.x % TY;                  // output row in the tile
  const int gx = (threadIdx.x / TY) % NG * kK;     // first output column
  const int dyi = threadIdx.x / (TY * NG);         // dy + kR

  float acc[kK][kD];
#pragma unroll
  for (int i = 0; i < kK; ++i)
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[i][d] = 0.0f;

  const int chunks = (C + kCK - 1) / kCK;
  if constexpr (kF32) {
    stage(0, 0);
    cp_async_commit();
  } else {
    fetch(0);
    put(0);
  }
  for (int k = 0; k < chunks; ++k) {
    const int buf = k & 1;
    const bool more = k + 1 < chunks;
    if constexpr (kF32) {
      if (more) {
        stage(buf ^ 1, (k + 1) * kCK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else if (more) {
      fetch((k + 1) * kCK);  // in flight while this chunk is summed
    }
    __syncthreads();
    const float4* st = smem + buf * T::kStage;
#pragma unroll
    for (int j4 = 0; j4 < kG4; ++j4) {
      const float4* fr = st + (j4 * TY + r) * T::kRowF + gx;
      const float4* sr =
          st + T::kFirst + (j4 * T::kHY + r + dyi) * T::kRowS + gx;
      float4 a[kK];
#pragma unroll
      for (int i = 0; i < kK; ++i) a[i] = fr[i];
#pragma unroll
      for (int j = 0; j < kK + 2 * kR; ++j) {
        const float4 b = sr[j];
#pragma unroll
        for (int i = 0; i < kK; ++i) {
          const int d = j - i;  // dx + kR
          if (d >= 0 && d < kD) {
            float s = acc[i][d];
            s = fmaf(a[i].x, b.x, s);
            s = fmaf(a[i].y, b.y, s);
            s = fmaf(a[i].z, b.z, s);
            s = fmaf(a[i].w, b.w, s);
            acc[i][d] = s;
          }
        }
      }
    }
    if constexpr (!kF32) {
      if (more) put(buf ^ 1);  // read last in the chunk before this one
    }
    __syncthreads();
  }

  // Each sum divided by C as IEEE division rounds it, without 36 calls of
  // the division routine: q = sum * RN(1/C), then one fma-exact correction
  // q + (sum - q C) RN(1/C) (Markstein: correctly rounded when the
  // reciprocal is). Staged displacement-major, columns swizzled within
  // their 4-group by the row, so that a warp's 32 stores hit 32 banks.
  const float fc = static_cast<float>(C);
  const float inv = 1.0f / fc;
  const int swz = (r >> 1) & 3;
#pragma unroll
  for (int i = 0; i < kK; ++i)
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      const float q = acc[i][d] * inv;
      s_out[(dyi * kD + d) * T::kOutRow + r * T::kTX + ((gx + i) ^ swz)] =
          fmaf(fmaf(-q, fc, acc[i][d]), inv, q);
    }
  __syncthreads();

  // each tile row's pixels' 81 values, contiguous in `out`: element e of
  // the row is (pixel e / 81, displacement e % 81), carried from one
  // element of the thread to its next without a division
  constexpr int kStepP = T::kThreads / kOff;
  constexpr int kStepO = T::kThreads % kOff;
  const int ny = min(TY, H - ty0);
  const int n = min(T::kTX, W - tx0) * kOff;
  for (int row = 0; row < ny; ++row) {
    E* dst_row = out + ((frame * H + ty0 + row) * W + tx0) * kOff;
    const float* src = s_out + row * T::kTX;
    const int swr = (row >> 1) & 3;
    int px = threadIdx.x / kOff;
    int o = threadIdx.x - px * kOff;
    for (int e = threadIdx.x; e < n; e += T::kThreads) {
      const float v = src[o * T::kOutRow + (px ^ swr)];
      if constexpr (kF32)
        dst_row[e] = v;
      else
        dst_row[e] = to_bf16(v);
      px += kStepP;
      o += kStepO;
      if (o >= kOff) {
        o -= kOff;
        ++px;
      }
    }
  }
}

template <int TY, int NG, typename E>
int launch(const E* first, const E* second, E* out, int frames, int H, int W,
           int C, cudaStream_t stream) {
  using T = Tile<TY, NG>;
  const int tiles_x = (W + T::kTX - 1) / T::kTX;
  const long long tiles = static_cast<long long>((H + TY - 1) / TY) * tiles_x;
  const long long blocks = tiles * frames;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (C % 4 == 0)
    correlation_kernel<TY, NG, true, E><<<static_cast<unsigned>(blocks),
                                          T::kThreads, 0, stream>>>(
        first, second, out, H, W, C, tiles_x, static_cast<int>(tiles));
  else
    correlation_kernel<TY, NG, false, E><<<static_cast<unsigned>(blocks),
                                           T::kThreads, 0, stream>>>(
        first, second, out, H, W, C, tiles_x, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int correlation(const E* first, const E* second, E* out, int frames, int H,
                int W, int C, void* stream) {
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0 || H == 0 || W == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H <= 12 && W <= 12)  // the whole plane in one 12x12 tile
    return launch<12, 3>(first, second, out, frames, H, W, C, st);
  return launch<8, 3>(first, second, out, frames, H, W, C, st);
}

}  // namespace

// first, second [frames, H, W, C]; out [frames, H, W, 81]; float32 or
// bfloat16 (all three the same), contiguous, 16-byte aligned. Any C >= 1
// and any plane.
DBSR_EXPORT int dbsr_correlation_f32(const float* first, const float* second,
                                     float* out, int frames, int H, int W,
                                     int C, void* stream) {
  return correlation(first, second, out, frames, H, W, C, stream);
}

DBSR_EXPORT int dbsr_correlation_bf16(const bf16* first, const bf16* second,
                                      bf16* out, int frames, int H, int W,
                                      int C, void* stream) {
  return correlation(first, second, out, frames, H, W, C, stream);
}
