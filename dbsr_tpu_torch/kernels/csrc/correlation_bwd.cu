// Backward of the 81-channel +-4 local cost volume (correlation.cu), for the
// output gradient g [frames, H, W, 81], channels-last float32:
//   d_first [b, y, x, c] = (1/C) * sum_o g[b, y, x, o]
//                                        * second[b, y+dy_o, x+dx_o, c]
//   d_second[b, v, w, c] = (1/C) * sum_o g[b, v-dy_o, w-dx_o, o]
//                                        * first [b, v-dy_o, w-dx_o, c]
// with o = (dy+4)*9 + (dx+4), dy, dx in [-4, 4]; a term whose read position
// falls outside the plane is zero.
//
// Replaces the TPU kernels of dbsr_tpu/ops/correlation.py:
// _correlation_pallas_bwd_impl (bodies _corr_dfirst_kernel and
// _corr_dsecond_kernel), which held a whole padded plane in VMEM and so only
// fit planes <= 16x16. This kernel takes any plane and any C >= 1:
// AlignLite's training calls it at 48x48 (C=24), 24x24 (C=48) and 12x12
// (C=96), 112 frames each.
//
// Bound on the H100: memory. The least traffic of either gradient is one
// read of its operand and of g and one write of the gradient: at level 0,
// 112*2304*(24+81+24)*4 B ~ 133 MB, ~0.040 ms at 3.35 TB/s (0.014 and 0.005
// at levels 1 and 2); the 2*81*C flops per pixel (~1 GFLOP at level 0) need
// ~0.015 ms at the 67 TFLOP/s float32 rate.
//
// The shifted gradient. With G'[v, w, o] = g[v-dy_o, w-dx_o, o] (zero where
// that read falls outside the plane),
//   d_second[v, w, c] = (1/C) * sum_o G'[v, w, o] * first[v-dy_o, w-dx_o, c],
// which is d_first's sum with the operand's displacement mirrored. So one
// body serves both (kShifted): d_first reads g on the output tile and the
// operand at row r+dy, column tap j = i+dx+4; d_second stages G' on the
// output tile and reads the operand at row r-dy, tap j = i-dx+4. The map
// (pixel, o) -> (pixel + d_o, o) is one-to-one, so G' costs no more shared
// memory than g on the tile: [tile pixels][81], an odd row stride.
//
// Design: register tiling, one block per (frame, 8x12 output tile, channel
// split). Thread (pixel group, channel group) keeps 4 adjacent output pixels
// of one tile row x 4 consecutive channels, 16 sums, in registers. For each
// dy it reads the operand's 12 halo pixels of its row as 16-byte shared
// loads and the 36 g (or G') values of its 4 pixels: 48 shared loads per 144
// FMAs, where one output a thread took a pair of 4-byte loads per FMA.
// - The threads of one pixel group are consecutive, one per channel group:
//   their g reads are broadcasts. The operand is staged [halo row][halo
//   column][channel group] float4s, the row stride padded to equal the
//   number of groups mod 8, so that 8 consecutive threads' 16-byte loads
//   fall on 8 distinct bank quads.
// - Channels go in chunks of ncg 4-channel groups, ncg <= 8 picked to pad C
//   the least (24 -> 6, 48 -> 6, 96 -> 8); a block has 24 * ncg threads.
//   Where frames x tiles alone are too few blocks for the card (the 12x12
//   and 24x24 levels), the chunks are split across blocks (grid y), each
//   staging g / G' anew from L2. A block with more than one chunk stages
//   the next by cp.async while it sums the current one (double-buffered);
//   zero-filled outside the plane and past C, 16-byte copies when
//   C % 4 == 0, else 4-byte ones.
// - g / G' is staged once per block by cp.async copies that fly with the
//   first chunk's: g's tile rows are contiguous (16-byte copies where
//   W % 4 == 0). G' is filled by walking g's halo rows: each thread takes
//   one (source column, dx) pair whose output column lies in the tile, and
//   for every (tile row, dy) copies that source pixel's value to output
//   pixel p + d_o; a warp's lanes read runs of 9 contiguous values (one dy
//   of consecutive source pixels). A walk over every (tile row, dy, source
//   column, dx) with the pairs outside the tile masked off was much slower:
//   the fill's index arithmetic, not its bytes, set its cost.
// - Each sum runs over ascending o by fmaf and ends with x RN(1/C), as the
//   plain versions do; outputs go out channels-last, each thread's 4
//   channels as one 16-byte store where C % 4 == 0. Single pass, no atomics:
//   the same bits on every call.
// - Shared memory: 31 KB of g / G' and 32-40 KB per stage (C = 24-96: one
//   stage, 63-72 KB); above 48 KB the launch opts in.
//
// bfloat16 (dbsr_correlation_dfirst_bf16, _dsecond_bf16: bf16 operand, g and
// gradient; the Pallas bodies' arithmetic at bf16, float32 sums, 1/C once,
// one rounding of the output): half the bytes. The operand's stages hold
// bf16, 8 bytes a 4-channel group, copied by 8-byte cp.async where C % 4 ==
// 0 (else by plain loads and stores, zeros past C), and are widened to
// float32 as the sums read them; g / G' is widened as it is staged (plain
// loads: a bf16 g row is not 4-byte aligned in general) into the same
// float32 [tile pixels][81]. The sums are the float32 ones: bf16 x bf16
// products are exact in float32, so each fmaf rounds once, as the plain
// versions' adds in ascending o (ops/correlation.py) do, and the two agree
// bit for bit.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kR = 4;                      // max displacement
constexpr int kD = 2 * kR + 1;             // 9
constexpr int kOff = kD * kD;              // 81
constexpr int kK = 4;                      // adjacent output pixels a thread
constexpr int kTY = 8;                     // output tile rows
constexpr int kNG = 3;                     // 4-pixel groups per tile row
constexpr int kTX = kNG * kK;              // 12 output tile columns
constexpr int kTile = kTY * kTX;           // 96 output pixels
constexpr int kPG = kTY * kNG;             // 24 pixel groups
constexpr int kHY = kTY + 2 * kR;          // 16 halo'd rows
constexpr int kHX = kTX + 2 * kR;          // 20 halo'd columns
constexpr int kHalo = kHY * kHX;           // 320 staged pixels
constexpr int kMaxCG = 8;                  // 4-channel groups of a chunk
constexpr int kMaxThreads = kPG * kMaxCG;  // 192
// blocks a launch aims for before it splits the channels: 8 per SM of the
// H100's 132
constexpr long long kTargetBlocks = 8 * 132;
constexpr size_t kGBytes = static_cast<size_t>(kTile) * kOff * sizeof(float);
constexpr size_t kMaxSmem = 227 * 1024;

// 4-channel groups per chunk for C4 = ceil(C / 4) groups: all of them up to
// kMaxCG, else the count in [4, kMaxCG] that pads C4 the least (the larger
// on a tie)
int groups_of(int c4) {
  if (c4 <= kMaxCG) return c4;
  int best = kMaxCG;
  int best_padded = INT_MAX;
  for (int n = kMaxCG; n >= 4; --n) {
    const int padded = (c4 + n - 1) / n * n;
    if (padded < best_padded) {
      best = n;
      best_padded = padded;
    }
  }
  return best;
}

// 4-channel groups per staged halo row: kHX * ncg, padded to equal ncg
// mod 8
int row_stride(int ncg) {
  return kHX * ncg + ((ncg - kHX * ncg) % 8 + 8) % 8;
}

// A staged 4-channel group of element type T (float4; 4 bf16 in a uint2)
// and its channels as float32.
template <typename T>
struct Group;
template <>
struct Group<float> {
  using Unit = float4;
  static __device__ __forceinline__ float4 widen(float4 u) { return u; }
  static __device__ __forceinline__ float load(const float* p) {
    return *p;
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};
template <>
struct Group<bf16> {
  using Unit = uint2;
  static __device__ __forceinline__ float4 widen(uint2 u) {
    return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                       bf16_hi(u.y));
  }
  static __device__ __forceinline__ float load(const bf16* p) {
    return load_bf16(p);
  }
  static __device__ __forceinline__ void store(bf16* p, float v) {
    *p = to_bf16(v);
  }
};

template <typename T, bool kShifted, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
correlation_bwd_kernel(const T* __restrict__ operand,
                       const T* __restrict__ g, T* __restrict__ out,
                       int H, int W, int C, int ncg, int rs, int chunks,
                       int tiles_x, int tiles) {
  using Unit = typename Group<T>::Unit;
  constexpr bool kF32 = sizeof(T) == 4;
  // stages of [kHY][rs] 4-channel groups (the operand's halo'd tile,
  // channel groups innermost), then g (d_first) or G' (d_second) on the
  // tile, float32 [kTile][81]
  extern __shared__ float4 smem_raw[];
  Unit* smem = reinterpret_cast<Unit*>(smem_raw);
  const int stage4 = kHY * rs;
  const int splits = static_cast<int>(gridDim.y);
  const int per = (chunks - static_cast<int>(blockIdx.y) + splits - 1)
                  / splits;  // chunks blockIdx.y, + splits, ..
  float* s_g = reinterpret_cast<float*>(smem + (per > 1 ? 2 : 1) * stage4);

  const int tile = blockIdx.x % tiles;
  const long long frame = blockIdx.x / tiles;
  const int ty0 = (tile / tiles_x) * kTY;
  const int tx0 = (tile % tiles_x) * kTX;
  const long long plane = static_cast<long long>(H) * W;
  const T* ob = operand + frame * plane * C;
  const T* gb = g + frame * plane * kOff;
  T* db = out + frame * plane * C;

  const int nthreads = kPG * ncg;
  const int cg = threadIdx.x % ncg;   // channel group
  const int pg = threadIdx.x / ncg;   // pixel group
  const int r = pg % kTY;             // output row in the tile
  const int gx = pg / kTY * kK;       // first output column in the tile

  // cp.async channels of chunk k of the halo'd tile into stage buf; this
  // thread copies group cg of pixels pg, pg + kPG, ..
  auto stage = [&](int buf, int k) {
    Unit* st = smem + buf * stage4;
    const int c = (k * ncg + cg) * 4;
    for (int p = pg; p < kHalo; p += kPG) {
      const int hy = p / kHX;
      const int hx = p - hy * kHX;
      const int y = ty0 - kR + hy;
      const int x = tx0 - kR + hx;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      const T* src =
          ob + (in ? static_cast<long long>(y) * W + x : 0) * C + c;
      T* d = reinterpret_cast<T*>(st + hy * rs + hx * ncg + cg);
      if constexpr (kVec) {
        const bool ok = in && c < C;  // C % 4 == 0: all or none
        constexpr int kBytes = sizeof(Unit);
        cp_async<kBytes>(d, ok ? src : ob, ok ? kBytes : 0);
      } else if constexpr (kF32) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = in && c + e < C;
          cp_async<4>(d + e, ok ? src + e : ob, ok ? 4 : 0);
        }
      } else {  // no 2-byte cp.async: plain loads and stores
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[e] = in && c + e < C ? src[e] : to_bf16(0.0f);
      }
    }
  };

  // g on the tile (d_first): each tile row's 12 pixels' values, contiguous
  // in g, by 16-byte copies where W % 4 == 0 (then every row starts on 16
  // bytes), else 4-byte ones; zeros past the plane
  auto stage_g = [&]() {
    if constexpr (!kShifted) {
      constexpr int kRow = kTX * kOff;
      const int nx = min(kTX, W - tx0) * kOff;  // a row's values in the plane
      const int ny = min(kTY, H - ty0);
      const T* g0 = gb + (static_cast<long long>(ty0) * W + tx0) * kOff;
      const long long g_row = static_cast<long long>(W) * kOff;
      if constexpr (!kF32) {  // widened as staged
        for (int i = threadIdx.x; i < kTile * kOff; i += nthreads) {
          const int tr = i / kRow;
          const int e = i - tr * kRow;
          s_g[i] = tr < ny && e < nx ? Group<T>::load(g0 + tr * g_row + e)
                                     : 0.0f;
        }
      } else if (W % 4 == 0) {
        for (int i = threadIdx.x * 4; i < kTile * kOff; i += nthreads * 4) {
          const int tr = i / kRow;
          const int e = i - tr * kRow;
          const int n = tr < ny ? max(0, min(4, nx - e)) : 0;
          cp_async<16>(s_g + i, n ? g0 + tr * g_row + e : gb, 4 * n);
        }
      } else {
        for (int i = threadIdx.x; i < kTile * kOff; i += nthreads) {
          const int tr = i / kRow;
          const int e = i - tr * kRow;
          const bool in = tr < ny && e < nx;
          cp_async<4>(s_g + i, in ? g0 + tr * g_row + e : gb, in ? 4 : 0);
        }
      }
    } else {
      // G' (d_second), by walking g's halo rows: source column hx's 9
      // values of one dy, contiguous in g, go to output columns hx + dx - 4
      // (tc); the (hx, dx) pairs with tc in the tile, 108, ordered by hx
      // then dx, are spread over the threads, and each thread walks its
      // pair's source and output rows for every (tile row, dy)
      for (int q = threadIdx.x; q < kTX * kD; q += nthreads) {
        int hx = 0;
        int rest = q;
        int lo = 2 * kR;  // source column hx's pairs: dx + kR in [lo, hi]
        for (;;) {
          lo = max(0, 2 * kR - hx);
          const int n = min(kD - 1, kTX - 1 + 2 * kR - hx) - lo + 1;
          if (rest < n) break;
          rest -= n;
          ++hx;
        }
        const int dxi = lo + rest;          // dx + kR
        const int tc = hx + dxi - 2 * kR;   // output column w = source + dx
        const int x = tx0 + hx - kR;
        const bool x_in = x >= 0 && x < W;
        const T* gx0 = gb + (x_in ? x * kOff + dxi : 0);
        float* sq = s_g + tc * kOff + dxi;
        for (int tr = 0; tr < kTY; ++tr) {
#pragma unroll
          for (int dyi = 0; dyi < kD; ++dyi) {  // dy + kR
            const int y = ty0 + tr + kR - dyi;
            const bool in = x_in && y >= 0 && y < H;
            const T* src =
                in ? gx0 + static_cast<long long>(y) * W * kOff + dyi * kD
                   : gb;
            float* dst = sq + tr * kTX * kOff + dyi * kD;
            if constexpr (kF32)
              cp_async<4>(dst, src, in ? 4 : 0);
            else
              *dst = in ? Group<T>::load(src) : 0.0f;
          }
        }
      }
    }
  };

  const float inv = 1.0f / static_cast<float>(C);
  const float* gq = s_g + (r * kTX + gx) * kOff;  // this thread's 4 pixels
  stage(0, blockIdx.y);
  stage_g();
  cp_async_commit();
  for (int n = 0; n < per; ++n) {
    const int k = static_cast<int>(blockIdx.y) + n * splits;
    const int buf = n & 1;
    if (n + 1 < per) {
      stage(buf ^ 1, k + splits);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float acc[kK][4];
#pragma unroll
    for (int i = 0; i < kK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    const Unit* st = smem + buf * stage4;
    for (int iy = 0; iy < kD; ++iy) {
      // d_first: second's row r + dy, halo row r + iy; d_second: first's
      // row r - dy, halo row r + 2 kR - iy
      const int hy = kShifted ? r + 2 * kR - iy : r + iy;
      const Unit* orow = st + hy * rs + gx * ncg + cg;
      const float* gr = gq + iy * kD;
#pragma unroll
      for (int jj = 0; jj < kK + 2 * kR; ++jj) {
        // d_second walks the taps backwards: each sum still takes
        // ascending dx, so ascending o
        const int j = kShifted ? kK + 2 * kR - 1 - jj : jj;
        const float4 b = Group<T>::widen(orow[j * ncg]);
#pragma unroll
        for (int i = 0; i < kK; ++i) {
          const int dxi = kShifted ? i - j + 2 * kR : j - i;  // dx + kR
          if (dxi >= 0 && dxi < kD) {
            const float gv = gr[i * kOff + dxi];
            acc[i][0] = fmaf(gv, b.x, acc[i][0]);
            acc[i][1] = fmaf(gv, b.y, acc[i][1]);
            acc[i][2] = fmaf(gv, b.z, acc[i][2]);
            acc[i][3] = fmaf(gv, b.w, acc[i][3]);
          }
        }
      }
    }

    const int c = (k * ncg + cg) * 4;
    const int y = ty0 + r;
    if (y < H && c < C) {
#pragma unroll
      for (int i = 0; i < kK; ++i) {
        const int x = tx0 + gx + i;
        if (x >= W) break;
        T* d = db + (static_cast<long long>(y) * W + x) * C + c;
        const float4 v = make_float4(acc[i][0] * inv, acc[i][1] * inv,
                                     acc[i][2] * inv, acc[i][3] * inv);
        if constexpr (kVec && kF32) {
          *reinterpret_cast<float4*>(d) = v;
        } else if constexpr (kVec) {
          store_bf16x4(reinterpret_cast<bf16*>(d), v);
        } else {
          const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < C) Group<T>::store(d + e, e4[e]);
        }
      }
    }
    __syncthreads();  // stage buf is read before it is staged again
  }
}

template <typename T, bool kShifted, bool kVec>
int launch_kernel(const T* operand, const T* g, T* out, int H,
                  int W, int C, int ncg, int chunks, int tiles_x, int tiles,
                  long long blocks, cudaStream_t stream) {
  // split the chunks across blocks until the launch has kTargetBlocks
  const long long want = (kTargetBlocks + blocks - 1) / blocks;
  const int splits = static_cast<int>(want < chunks ? want : chunks);
  const int per = (chunks + splits - 1) / splits;
  const int rs = row_stride(ncg);
  const size_t smem = (per > 1 ? 2 : 1) * kHY * rs
                     * sizeof(typename Group<T>::Unit) + kGBytes;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = correlation_bwd_kernel<T, kShifted, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(blocks), splits);
  kernel<<<grid, kPG * ncg, smem, stream>>>(operand, g, out, H, W, C, ncg,
                                             rs, chunks, tiles_x, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <bool kShifted, typename T>
int launch(const T* operand, const T* g, T* out, int frames,
           int H, int W, int C, void* stream) {
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0 || H == 0 || W == 0) return 0;
  const int c4 = (C + 3) / 4;
  const int ncg = groups_of(c4);
  const int chunks = (c4 + ncg - 1) / ncg;
  const int tiles_x = (W + kTX - 1) / kTX;
  const long long tiles =
      static_cast<long long>((H + kTY - 1) / kTY) * tiles_x;
  const long long blocks = tiles * frames;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 4 == 0)
    return launch_kernel<T, kShifted, true>(operand, g, out, H, W, C, ncg,
                                            chunks, tiles_x,
                                            static_cast<int>(tiles), blocks,
                                            st);
  return launch_kernel<T, kShifted, false>(operand, g, out, H, W, C, ncg,
                                           chunks, tiles_x,
                                           static_cast<int>(tiles), blocks,
                                           st);
}

}  // namespace

// second, dfirst [frames, H, W, C]; g [frames, H, W, 81]; float32,
// contiguous, 16-byte aligned.
DBSR_EXPORT int dbsr_correlation_dfirst_f32(const float* second, const float* g,
                                            float* dfirst, int frames, int H,
                                            int W, int C, void* stream) {
  return launch<false>(second, g, dfirst, frames, H, W, C, stream);
}

// first, dsecond [frames, H, W, C]; g [frames, H, W, 81]; float32,
// contiguous, 16-byte aligned.
DBSR_EXPORT int dbsr_correlation_dsecond_f32(const float* first, const float* g,
                                             float* dsecond, int frames, int H,
                                             int W, int C, void* stream) {
  return launch<true>(first, g, dsecond, frames, H, W, C, stream);
}

// the same in bfloat16 (second or first, g and the gradient all bf16)
DBSR_EXPORT int dbsr_correlation_dfirst_bf16(const bf16* second,
                                             const bf16* g, bf16* dfirst,
                                             int frames, int H, int W, int C,
                                             void* stream) {
  return launch<false>(second, g, dfirst, frames, H, W, C, stream);
}

DBSR_EXPORT int dbsr_correlation_dsecond_bf16(const bf16* first,
                                              const bf16* g, bf16* dsecond,
                                              int frames, int H, int W, int C,
                                              void* stream) {
  return launch<true>(first, g, dsecond, frames, H, W, C, stream);
}
