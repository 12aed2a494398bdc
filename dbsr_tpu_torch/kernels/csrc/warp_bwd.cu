// Backward of the bilinear backward warp (warp.cu), channels-last, float32
// or bfloat16 features and gradients (the flow float32):
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
// dbsr_warp_dfeat_f32 -- d_feat = W^T g, i.e. d_feat[q] = sum over the
// (source p, tap) pairs whose nonzero-weight tap lands on q of w * g[p].
// Bound on the H100: memory; the least traffic is one read of g and flow
// and one write of d_feat: at the encoder's [112, 48, 48, 512] ~1.06 GB,
// ~0.32 ms at 3.35 TB/s. Design: a gather, deterministic like the JAX
// kernel's W^T tile @ g, with no atomics on the output and no zero fill.
// Flows are unbounded, so the transposed taps are built per call as a CSR
// per frame, in scratch the wrapper allocates (~10 words per pixel, ~1% of
// the bound's traffic at the encoder's shape): by one 1024-thread block per
// frame in shared memory where a frame's CSR fits (up to ~5800 pixels;
// then copied out), the steps parted by __syncthreads; for larger planes
// in the scratch, each step a grid over all frames' pixels (a zero fill of
// the counts, then four kernels: one block a frame for the scan), since a
// block a frame left all but 12 SMs idle at SCA's 12 x 448^2. The steps:
//   1. count: each source pixel adds 1 (an integer atomic, so the counts do
//      not depend on the order) to the count of each target its
//      nonzero-weight taps land on;
//   2. scan: the counts become each target's bucket start (an exclusive
//      scan) and are zeroed for step 3;
//   3. fill: each source pixel takes a slot in each of its targets'
//      buckets (an integer atomic: the order within a bucket is not fixed)
//      and writes (source, weight) there;
//   4. sort: each target's bucket by source (insertion sort: a bucket
//      holds ~4 entries for a smooth flow; a heapsort above 32, for a
//      pile-up of many sources on one target, slow but right);
//   5. gather, a second kernel: a block takes a 4x8 tile of targets x a
//      slab of G x V 4-channel groups (G up to 8, V up to 2); each thread
//      walks its target's bucket in ascending source order, sums
//      w * g[p, c:c+4] for its V groups (G apart, so that neighbouring
//      threads load neighbouring 16 bytes) in float4 registers, and writes
//      each once. Neighbouring targets of a tile share sources, which the
//      L1 then serves; one frame of g (4.7 MB at the encoder's shape) stays
//      in the 50 MB L2. The sums' order is fixed by the CSR, so the output
//      is bit-identical from call to call. For C % 4 != 0 (SCA's warp of
//      the 3-channel prediction) the same gather walks single channels
//      with 4-byte loads: a block is the 4x8 tile x G channels (G the
//      least power of two >= C, at most 8; threads past C idle), in the
//      same order, so also bit-identical from call to call.
//
// dbsr_warp_dflow_f32 -- d_flow[p] = sum_c g[p, c] * sum_tap dw_tap/d(x,y) *
// feat[tap, c]. Bound: memory; one read of g and feat (+ flow) and one write
// of d_flow, ~1.06 GB at the encoder's [112, 48, 48, 512], ~0.32 ms at 3.35
// TB/s; ~50 MB, ~0.016 ms, at AlignLite's [112, 48, 48, 24]. A pixel's work
// is C / kVec channel groups of one access each (kVec: 16 bytes where C
// divides it, 4 float32 or 8 bf16 channels; bf16 with C % 8 != 0 but C % 4
// == 0 8 bytes, 4 channels; else one channel), so at small C one pixel
// cannot fill a warp: a warp a pixel spent its time on tap geometry and a
// 32-lane reduction, not on bytes. Design: a warp takes 32 / L pixels,
// neighbours along a row (they share taps, so the L1 serves much of feat),
// L the least power of two >= the groups, at most 32 (C = 24: 4 pixels a
// warp in float32, 8 in bf16); the L lanes of a pixel's segment compute its
// tap geometry once, skip the taps out of range (uniformly in the
// segment), and walk its groups L apart, one a step (g's access and the
// four taps', five loads in flight; g's first is issued before the
// geometry). The bytes in flight come from occupancy: ten loads a step
// (two groups) took 80-122 registers a thread and ran 13-29% slower at C =
// 512 than one warp a pixel, so the kernel keeps each access as loaded and
// widens one channel at a time (a bf16 access in 4 registers, not 8) and
// holds the geometry as four weights and four tap rows (40-64 registers).
// Each lane sums, channel by channel in ascending order, g * (the taps'
// derivative weights * feat, summed in tap order) into float32 sums by
// fmaf; the segment then adds its lanes' sums in a butterfly of log2(L)
// __shfl_xor_sync steps (none at L = 1), a fixed order, so the output is
// the same bits from call to call; no atomics. The segment's first lane
// writes the pixel's two values as one float2.
//
// The bf16 entries (dbsr_warp_dfeat_bf16, dbsr_warp_dflow_bf16) replace the
// same two TPU kernels at bf16, whose `_dot` casts the one-hot operator to
// bf16 and sums bf16 x bf16 products in float32. They are the float32
// bodies with bf16 loads widened to float32 in registers (d_feat as they
// arrive, d_flow a channel at a time as its sums take it; 16-byte loads of
// 8 channels where C % 8 == 0, d_flow also 8-byte loads of 4 where C % 4 ==
// 0, one channel an access otherwise): d_feat rounds
// each tap weight to bf16 before its product (exact in float32), sums in
// the CSR's ascending source order and rounds each output once; d_flow
// rounds each derivative weight to bf16 before it meets feat and writes
// float32. Half the bytes of float32: at the encoder's shape ~0.53 GB,
// ~0.16 ms at 3.35 TB/s for either. The plain versions (ops/warp.py) sum
// in the same order, so d_feat agrees with them bit for bit.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBuildThreads = 1024;
// the shared memory a block may opt in to, less the build's static 128 B
constexpr long long kMaxSmem = 227 * 1024 - 128;
constexpr int kTileY = 4;  // gather: a block's targets, 4 rows x 8 columns
constexpr int kTileX = 8;
constexpr int kTargets = kTileY * kTileX;

struct Taps {
  int q[4];     // flat pixel index of each tap in the frame (clamped)
  float w[4];   // tap weight, 0 out of range
  float dx[4];  // d w / d x, 0 out of range
  float dy[4];  // d w / d y, 0 out of range
};

__device__ __forceinline__ Taps tap_geometry(const float* fl, int p, int H,
                                             int W) {
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
    t.q[k] = yc * W + xc;
    t.w[k] = valid ? w[k] : 0.0f;
    t.dx[k] = valid ? dx[k] : 0.0f;
    t.dy[k] = valid ? dy[k] : 0.0f;
  }
  return t;
}

// The CSR of one call in the wrapper's int32 scratch: per frame, the
// targets' counts [P] and their bucket starts [P + 1] (start[P] = the
// frame's entries), then, 16-byte aligned, the entries [4 P] of (source,
// weight bits): csr_words words in all (ops/warp.py:_dfeat_scratch_words
// computes the same).
struct Csr {
  int* count;
  int* start;
  int2* entries;
};

inline long long csr_heads(long long frames, long long P) {
  return (frames * (2 * P + 1) + 3) / 4 * 4;
}

inline long long csr_words(long long frames, long long P) {
  return csr_heads(frames, P) + frames * 8 * P;
}

inline Csr csr_layout(int* scratch, long long frames, long long P) {
  return Csr{scratch, scratch + frames * P,
             reinterpret_cast<int2*>(scratch + csr_heads(frames, P))};
}

// A bucket sorted by source (a source's four taps land on four different
// targets, so the sources of a bucket are distinct): insertion sort up to
// kInsertionMax entries, else heapsort, so that a pile-up of many sources
// on one target costs n log n
constexpr int kInsertionMax = 32;

__device__ __forceinline__ void sift_down(int2* e, int root, int n) {
  const int2 v = e[root];
  int child;
  while ((child = 2 * root + 1) < n) {
    if (child + 1 < n && e[child + 1].x > e[child].x) ++child;
    if (e[child].x <= v.x) break;
    e[root] = e[child];
    root = child;
  }
  e[root] = v;
}

__device__ void sort_bucket(int2* e, int n) {
  if (n <= kInsertionMax) {
    for (int a = 1; a < n; ++a) {
      const int2 v = e[a];
      int b = a - 1;
      while (b >= 0 && e[b].x > v.x) {
        e[b + 1] = e[b];
        --b;
      }
      e[b + 1] = v;
    }
    return;
  }
  for (int root = n / 2 - 1; root >= 0; --root) sift_down(e, root, n);
  for (int end = n - 1; end > 0; --end) {
    const int2 top = e[0];
    e[0] = e[end];
    e[end] = top;
    sift_down(e, 0, end);
  }
}

// Bytes of shared memory that hold a frame's whole CSR in the build.
inline long long build_smem_bytes(long long P) {
  return (2 * P + 2) * 4 + 4 * P * 8;
}

// Step 1 for source pixel p of a frame: +1 to the count of each target its
// nonzero-weight taps land on.
__device__ __forceinline__ void count_taps(const float* fl, int p, int H,
                                           int W, int* c) {
  const Taps t = tap_geometry(fl + 2 * p, p, H, W);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (t.w[k] != 0.0f) atomicAdd(c + t.q[k], 1);
}

// Step 3 for source pixel p: (p, weight) into a slot of each of its
// targets' buckets (starts s, cursors c).
__device__ __forceinline__ void fill_taps(const float* fl, int p, int H,
                                          int W, const int* s, int* c,
                                          int2* e) {
  const Taps t = tap_geometry(fl + 2 * p, p, H, W);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (t.w[k] == 0.0f) continue;
    const int q = t.q[k];
    e[s[q] + atomicAdd(c + q, 1)] = make_int2(p, __float_as_int(t.w[k]));
  }
}

// Step 2 by one block of kBuildThreads: s[0..P) = the exclusive scan of
// c[0..P), s[P] = the total, c zeroed (the fill's cursors). Each thread
// scans a run of `per` counts, then the block's prefix over the runs.
__device__ void block_scan(int* c, int* s, int P, int* s_warp) {
  const int tid = threadIdx.x;
  const int per = (P + kBuildThreads - 1) / kBuildThreads;
  const int lo = min(P, tid * per);
  const int hi = min(P, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += c[i];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int v = sum;  // inclusive scan over the warp's threads
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {  // inclusive scan over the warps' totals
    int w = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int run = v - sum + (warp ? s_warp[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    s[i] = run;
    run += c[i];
    c[i] = 0;
  }
  if (tid == kBuildThreads - 1) s[P] = run;  // the frame's total
}

// Steps 1-4 where a frame's CSR fits in shared memory (P up to ~5800): one
// block per frame builds the counts, starts and entries there, the steps
// parted by __syncthreads, then copies the starts and entries out.
__global__ void __launch_bounds__(kBuildThreads)
dfeat_build_kernel(const float* __restrict__ flow, int* __restrict__ start,
                   int2* __restrict__ entries, int H, int W) {
  __shared__ int s_warp[kBuildThreads / 32];
  extern __shared__ int2 s_csr[];  // entries [4P], count [P], start [P + 1]
  const int P = H * W;
  const long long frame = blockIdx.x;
  const float* fl = flow + frame * P * 2;
  int* c = reinterpret_cast<int*>(s_csr + 4 * P);
  int* s = c + P;
  int2* e = s_csr;
  const int tid = threadIdx.x;

  for (int q = tid; q < P; q += kBuildThreads) c[q] = 0;
  __syncthreads();
  for (int p = tid; p < P; p += kBuildThreads) count_taps(fl, p, H, W, c);
  __syncthreads();
  block_scan(c, s, P, s_warp);
  __syncthreads();
  for (int p = tid; p < P; p += kBuildThreads)
    fill_taps(fl, p, H, W, s, c, e);
  __syncthreads();
  for (int q = tid; q < P; q += kBuildThreads)
    sort_bucket(e + s[q], s[q + 1] - s[q]);
  __syncthreads();
  int* gs = start + frame * (P + 1);
  int2* ge = entries + frame * 4 * P;
  for (int q = tid; q <= P; q += kBuildThreads) gs[q] = s[q];
  for (int i = tid; i < s[P]; i += kBuildThreads) ge[i] = e[i];
}

// Steps 1-4 for larger planes (SCA's 448^2 x 12 in fine-tuning), in the
// scratch, each step one grid over every frame's pixels (one thread a
// pixel; the scan a block a frame), so that the whole card builds.
__global__ void __launch_bounds__(kThreads)
csr_count_kernel(const float* __restrict__ flow, int* __restrict__ count,
                 int H, int W, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= total) return;
  const int P = H * W;
  const long long frame = i / P;
  count_taps(flow + frame * P * 2, static_cast<int>(i - frame * P), H, W,
             count + frame * P);
}

__global__ void __launch_bounds__(kBuildThreads)
csr_scan_kernel(int* __restrict__ count, int* __restrict__ start, int P) {
  __shared__ int s_warp[kBuildThreads / 32];
  const long long frame = blockIdx.x;
  block_scan(count + frame * P, start + frame * (P + 1), P, s_warp);
}

__global__ void __launch_bounds__(kThreads)
csr_fill_kernel(const float* __restrict__ flow, int* __restrict__ count,
                const int* __restrict__ start, int2* __restrict__ entries,
                int H, int W, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= total) return;
  const int P = H * W;
  const long long frame = i / P;
  fill_taps(flow + frame * P * 2, static_cast<int>(i - frame * P), H, W,
            start + frame * (P + 1), count + frame * P,
            entries + frame * 4 * P);
}

__global__ void __launch_bounds__(kThreads)
csr_sort_kernel(const int* __restrict__ start, int2* __restrict__ entries,
                int P, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= total) return;
  const long long frame = i / P;
  const int q = static_cast<int>(i - frame * P);
  const int* s = start + frame * (P + 1);
  sort_bucket(entries + frame * 4 * P + s[q], s[q + 1] - s[q]);
}

// Loads of kVec channels of element type T widened to float32, stores
// rounded to T, and the tap weight as a T operand holds it.
template <typename T, int kVec>
struct Io;
template <>
struct Io<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Io<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    *p = v[0];
  }
};
template <>
struct Io<bf16, 8> {
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[8]) {
    load_bf16x8(p, v);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
    store_bf16x8(p, v);
  }
};
template <>
struct Io<bf16, 1> {
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[1]) {
    v[0] = load_bf16(p);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[1]) {
    *p = to_bf16(v[0]);
  }
};

__device__ __forceinline__ float operand(float w, const float*) { return w; }
__device__ __forceinline__ float operand(float w, const bf16*) {
  return round_bf16(w);
}

// the channels of one 16-byte access of T
template <typename T>
constexpr int kWide = 16 / static_cast<int>(sizeof(T));

// 5. d_feat[q, c:c+kVec] = sum over q's bucket, in ascending source order,
// of w * g[p, c:c+kVec] (kVec = kWide<T>: 4 float32 or 8 bf16 channels, one
// 16-byte access); a block is a 4x8 tile of targets x a slab of G x V
// channel groups, thread (target, j) the groups j, j + G, .. of the slab
template <typename T, int G, int V>
__global__ void __launch_bounds__(kTargets * G)
dfeat_gather_kernel(const T* __restrict__ g, const int* __restrict__ start,
                    const int2* __restrict__ entries, T* __restrict__ dfeat,
                    int H, int W, int C, int tiles_x, int tiles, int slabs) {
  constexpr int kVec = kWide<T>;
  using A = Io<T, kVec>;
  const int P = H * W;
  long long bid = blockIdx.x;
  const int slab = static_cast<int>(bid % slabs);
  bid /= slabs;
  const int tile = static_cast<int>(bid % tiles);
  const long long frame = bid / tiles;
  const int lt = threadIdx.x / G;
  const int y = (tile / tiles_x) * kTileY + lt / kTileX;
  const int x = (tile % tiles_x) * kTileX + lt % kTileX;
  if (y >= H || x >= W) return;
  const int q = y * W + x;
  const int c = (slab * G * V + static_cast<int>(threadIdx.x) % G) * kVec;
  const int* s = start + frame * (P + 1);
  const int2* e = entries + frame * 4 * P;
  const T* gb = g + frame * P * C + c;
  float acc[V][kVec];
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[v][i] = 0.0f;
  const int hi = s[q + 1];
#pragma unroll 2
  for (int k = s[q]; k < hi; ++k) {
    const int2 ent = __ldg(e + k);
    const float w = operand(__int_as_float(ent.y), g);
    const T* gp = gb + static_cast<long long>(ent.x) * C;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float val[kVec];
      A::load(gp + v * G * kVec, val);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[v][i] = fmaf(w, val[i], acc[v][i]);
    }
  }
  T* out = dfeat + (frame * P + q) * C + c;
#pragma unroll
  for (int v = 0; v < V; ++v) A::store(out + v * G * kVec, acc[v]);
}

// 5, for any C: d_feat[q, c] as above, one channel a thread; a block is a
// 4x8 tile of targets x a slab of G channels, thread (target, j) channel
// slab * G + j, idle past C
template <typename T, int G>
__global__ void __launch_bounds__(kTargets * G)
dfeat_gather_scalar_kernel(const T* __restrict__ g,
                           const int* __restrict__ start,
                           const int2* __restrict__ entries,
                           T* __restrict__ dfeat, int H, int W, int C,
                           int tiles_x, int tiles, int slabs) {
  using A = Io<T, 1>;
  const int P = H * W;
  long long bid = blockIdx.x;
  const int slab = static_cast<int>(bid % slabs);
  bid /= slabs;
  const int tile = static_cast<int>(bid % tiles);
  const long long frame = bid / tiles;
  const int lt = threadIdx.x / G;
  const int y = (tile / tiles_x) * kTileY + lt / kTileX;
  const int x = (tile % tiles_x) * kTileX + lt % kTileX;
  const int c = slab * G + static_cast<int>(threadIdx.x) % G;
  if (y >= H || x >= W || c >= C) return;
  const int q = y * W + x;
  const int* s = start + frame * (P + 1);
  const int2* e = entries + frame * 4 * P;
  const T* gb = g + frame * P * C + c;
  float acc[1] = {0.0f};
  const int hi = s[q + 1];
#pragma unroll 4
  for (int k = s[q]; k < hi; ++k) {
    const int2 ent = __ldg(e + k);
    float val[1];
    A::load(gb + static_cast<long long>(ent.x) * C, val);
    acc[0] = fmaf(operand(__int_as_float(ent.y), g), val[0], acc[0]);
  }
  A::store(dfeat + (frame * P + q) * C + c, acc);
}

template <typename T, int G>
void launch_gather_scalar(const T* g, const Csr& csr, T* dfeat, int frames,
                          int H, int W, int C, cudaStream_t stream) {
  const int tiles_x = (W + kTileX - 1) / kTileX;
  const int tiles = ((H + kTileY - 1) / kTileY) * tiles_x;
  const int slabs = (C + G - 1) / G;
  const long long blocks = static_cast<long long>(frames) * tiles * slabs;
  dfeat_gather_scalar_kernel<T, G><<<static_cast<unsigned>(blocks),
                                     kTargets * G, 0, stream>>>(
      g, csr.start, csr.entries, dfeat, H, W, C, tiles_x, tiles, slabs);
}

template <typename T, int G, int V>
void launch_gather(const T* g, const Csr& csr, T* dfeat, int frames, int H,
                   int W, int C, cudaStream_t stream) {
  const int tiles_x = (W + kTileX - 1) / kTileX;
  const int tiles = ((H + kTileY - 1) / kTileY) * tiles_x;
  const int slabs = C / kWide<T> / (G * V);
  const long long blocks = static_cast<long long>(frames) * tiles * slabs;
  dfeat_gather_kernel<T, G, V><<<static_cast<unsigned>(blocks), kTargets * G,
                                 0, stream>>>(g, csr.start, csr.entries, dfeat,
                                              H, W, C, tiles_x, tiles, slabs);
}

// G: the widest of 8, 4, 2, 1 16-byte groups that divides C / kWide; V: 2
// slabs of G a thread where they divide it too (two 16-byte loads in
// flight per entry; 4 was slower at the encoder's C = 512 in float32)
template <typename T, int G>
void launch_gather_v(const T* g, const Csr& csr, T* dfeat, int frames, int H,
                     int W, int C, cudaStream_t stream) {
  if ((C / kWide<T>) % (2 * G) == 0)
    launch_gather<T, G, 2>(g, csr, dfeat, frames, H, W, C, stream);
  else
    launch_gather<T, G, 1>(g, csr, dfeat, frames, H, W, C, stream);
}

// d_flow's accesses of kVec channels of T, held as loaded and widened to
// float32 a channel at a time where the sums take it (a bf16 access in
// half the registers of its float32 values)
template <typename T, int kVec>
struct Raw;
template <>
struct Raw<float, 4> {
  using type = float4;
  static __device__ __forceinline__ type load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float at(const type& r, int i) {
    return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
  }
};
template <>
struct Raw<float, 1> {
  using type = float;
  static __device__ __forceinline__ type load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float at(const type& r, int) { return r; }
};
template <>
struct Raw<bf16, 8> {
  using type = uint4;
  static __device__ __forceinline__ type load(const bf16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ float at(const type& r, int i) {
    const uint32_t w = i < 2 ? r.x : i < 4 ? r.y : i < 6 ? r.z : r.w;
    return i & 1 ? bf16_hi(w) : bf16_lo(w);
  }
};
template <>
struct Raw<bf16, 4> {
  using type = uint2;
  static __device__ __forceinline__ type load(const bf16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ float at(const type& r, int i) {
    const uint32_t w = i < 2 ? r.x : r.y;
    return i & 1 ? bf16_hi(w) : bf16_lo(w);
  }
};
template <>
struct Raw<bf16, 1> {
  using type = unsigned short;
  static __device__ __forceinline__ type load(const bf16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ float at(const type& r, int) {
    return __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
};

// d_flow: 32 / L pixels a warp, neighbours along a row; lane sub of a
// pixel's L-lane segment takes its channel groups sub, sub + L, .. (kVec
// channels each, one access of g and of each tap a group); the segment's
// sums meet in a butterfly. The geometry is tap_geometry's, held in fewer
// registers: the derivative weights of taps 00, 01, 10, 11 are, along x,
// -ay, ay, -wy, wy and, along y, -ax, -wx, ax, wx (ax = 1 - wx, ay = 1 -
// wy), each rounded as a T operand, a tap taken where it is in range and
// one of its two weights is nonzero
template <typename T, int kVec, int L>
__global__ void __launch_bounds__(kThreads)
dflow_kernel(const T* __restrict__ feat, const float* __restrict__ flow,
             const T* __restrict__ g, float* __restrict__ dflow, int P,
             int H, int W, int C, long long total) {
  using R = Raw<T, kVec>;
  constexpr int kPixels = 32 / L;
  const long long first = (static_cast<long long>(blockIdx.x) * kThreads +
                           threadIdx.x) / 32 * kPixels;
  if (first >= total) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int sub = lane % L;
  const long long pix = first + lane / L;
  const int groups = pix < total ? C / kVec : 0;
  float sx = 0.0f, sy = 0.0f;
  if (sub < groups) {
    const T* gp = g + pix * C;
    typename R::type gr = R::load(gp + sub * kVec);  // in flight meanwhile
    const long long frame = pix / P;
    const int p = static_cast<int>(pix - frame * P);
    const float x = __fadd_rn(static_cast<float>(p % W), flow[pix * 2]);
    const float y = __fadd_rn(static_cast<float>(p / W), flow[pix * 2 + 1]);
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float wx = __fsub_rn(x, x0);
    const float wy = __fsub_rn(y, y0);
    const float ax = operand(__fsub_rn(1.0f, wx), feat);
    const float ay = operand(__fsub_rn(1.0f, wy), feat);
    const float bx = operand(wx, feat);
    const float by = operand(wy, feat);
    const float dx[4] = {-ay, ay, -by, by};
    const float dy[4] = {-ax, -bx, ax, bx};
    int q[4];
    bool use[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float yi = y0 + static_cast<float>(k >> 1);
      const float xi = x0 + static_cast<float>(k & 1);
      use[k] = yi >= 0.0f && yi < static_cast<float>(H) && xi >= 0.0f &&
               xi < static_cast<float>(W) && (dx[k] != 0.0f || dy[k] != 0.0f);
      q[k] = use[k] ? static_cast<int>(yi) * W + static_cast<int>(xi) : 0;
    }
    const T* fb = feat + frame * P * C;
    for (int j = sub; j < groups; j += L) {
      if (j != sub) gr = R::load(gp + j * kVec);
      typename R::type vr[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (use[k])
          vr[k] = R::load(fb + static_cast<long long>(q[k]) * C + j * kVec);
      // per channel, in ascending order: the taps' derivative weights times
      // feat summed in tap order, then g times that added to the sums
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        float fx = 0.0f, fy = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!use[k]) continue;
          const float v = R::at(vr[k], i);
          fx = fmaf(dx[k], v, fx);
          fy = fmaf(dy[k], v, fy);
        }
        const float gv = R::at(gr, i);
        sx = fmaf(gv, fx, sx);
        sy = fmaf(gv, fy, sy);
      }
    }
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {  // within the segment: lane ^ o
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
    sy += __shfl_xor_sync(0xffffffffu, sy, o);
  }
  if (sub == 0 && pix < total)
    *reinterpret_cast<float2*>(dflow + pix * 2) = make_float2(sx, sy);
}

template <typename T>
int run_dfeat(const float* flow, const T* g, T* dfeat, int* scratch,
              int frames, int H, int W, int C, int scratch_words,
              cudaStream_t st) {
  const long long P = static_cast<long long>(H) * W;
  if (P > INT_MAX / 4
      || csr_words(frames, P) > static_cast<long long>(scratch_words))
    return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0 || P == 0 || C == 0) return 0;
  const Csr csr = csr_layout(scratch, frames, P);
  const long long smem = build_smem_bytes(P);
  if (smem <= kMaxSmem) {
    const cudaError_t err = cudaFuncSetAttribute(  // on the current device
        dfeat_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dfeat_build_kernel<<<frames, kBuildThreads, smem, st>>>(
        flow, csr.start, csr.entries, H, W);
  } else {
    const long long total = static_cast<long long>(frames) * P;
    const unsigned blocks =
        static_cast<unsigned>((total + kThreads - 1) / kThreads);
    const cudaError_t err = cudaMemsetAsync(
        csr.count, 0, static_cast<size_t>(total) * sizeof(int), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    csr_count_kernel<<<blocks, kThreads, 0, st>>>(flow, csr.count, H, W,
                                                  total);
    csr_scan_kernel<<<frames, kBuildThreads, 0, st>>>(
        csr.count, csr.start, static_cast<int>(P));
    csr_fill_kernel<<<blocks, kThreads, 0, st>>>(
        flow, csr.count, csr.start, csr.entries, H, W, total);
    csr_sort_kernel<<<blocks, kThreads, 0, st>>>(
        csr.start, csr.entries, static_cast<int>(P), total);
  }
  const int cw = C / kWide<T>;
  if (C % kWide<T> != 0) {
    if (C == 1)
      launch_gather_scalar<T, 1>(g, csr, dfeat, frames, H, W, C, st);
    else if (C == 2)
      launch_gather_scalar<T, 2>(g, csr, dfeat, frames, H, W, C, st);
    else if (C <= 4)
      launch_gather_scalar<T, 4>(g, csr, dfeat, frames, H, W, C, st);
    else
      launch_gather_scalar<T, 8>(g, csr, dfeat, frames, H, W, C, st);
  } else if (cw % 8 == 0)
    launch_gather_v<T, 8>(g, csr, dfeat, frames, H, W, C, st);
  else if (cw % 4 == 0)
    launch_gather_v<T, 4>(g, csr, dfeat, frames, H, W, C, st);
  else if (cw % 2 == 0)
    launch_gather_v<T, 2>(g, csr, dfeat, frames, H, W, C, st);
  else
    launch_gather_v<T, 1>(g, csr, dfeat, frames, H, W, C, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVec, int L>
void launch_dflow(const T* feat, const float* flow, const T* g, float* dflow,
                  long long total, int H, int W, int C, cudaStream_t st) {
  const long long warps = (total + 32 / L - 1) / (32 / L);
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  dflow_kernel<T, kVec, L><<<static_cast<unsigned>(blocks), kThreads, 0,
                             st>>>(feat, flow, g, dflow, H * W, H, W, C,
                                   total);
}

// L: the least power of two >= the channel groups, at most 32
template <typename T, int kVec>
void launch_dflow_l(const T* feat, const float* flow, const T* g,
                    float* dflow, long long total, int H, int W, int C,
                    cudaStream_t st) {
  const int groups = C / kVec;
  if (groups > 16)
    launch_dflow<T, kVec, 32>(feat, flow, g, dflow, total, H, W, C, st);
  else if (groups > 8)
    launch_dflow<T, kVec, 16>(feat, flow, g, dflow, total, H, W, C, st);
  else if (groups > 4)
    launch_dflow<T, kVec, 8>(feat, flow, g, dflow, total, H, W, C, st);
  else if (groups > 2)
    launch_dflow<T, kVec, 4>(feat, flow, g, dflow, total, H, W, C, st);
  else if (groups > 1)
    launch_dflow<T, kVec, 2>(feat, flow, g, dflow, total, H, W, C, st);
  else
    launch_dflow<T, kVec, 1>(feat, flow, g, dflow, total, H, W, C, st);
}

// 16 bytes an access where C divides it (4 float32 or 8 bf16 channels),
// else 8 bytes of bf16 where C % 4 == 0, else one channel
template <typename T>
int run_dflow(const T* feat, const float* flow, const T* g, float* dflow,
              int frames, int H, int W, int C, cudaStream_t st) {
  const long long total = static_cast<long long>(frames) * H * W;
  if (total == 0 || C == 0) return 0;
  if (C % kWide<T> == 0)
    launch_dflow_l<T, kWide<T>>(feat, flow, g, dflow, total, H, W, C, st);
  else if (sizeof(T) == 2 && C % 4 == 0)
    launch_dflow_l<T, 4>(feat, flow, g, dflow, total, H, W, C, st);
  else
    launch_dflow_l<T, 1>(feat, flow, g, dflow, total, H, W, C, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// flow [frames, H, W, 2] float32, g and dfeat [frames, H, W, C] float32
// (or bfloat16: dbsr_warp_dfeat_bf16); contiguous, 16-byte aligned; any C
// (16-byte accesses where C % 4 == 0 in float32, C % 8 == 0 in bf16; one
// channel an access otherwise); scratch int32, 16-byte aligned, of at
// least scratch_words words (the CSR; csr_words). dfeat needs no initial
// value: every element is written once.
DBSR_EXPORT int dbsr_warp_dfeat_f32(const float* flow, const float* g,
                                    float* dfeat, int* scratch, int frames,
                                    int H, int W, int C, int scratch_words,
                                    void* stream) {
  return run_dfeat(flow, g, dfeat, scratch, frames, H, W, C, scratch_words,
                   static_cast<cudaStream_t>(stream));
}

DBSR_EXPORT int dbsr_warp_dfeat_bf16(const float* flow, const bf16* g,
                                     bf16* dfeat, int* scratch, int frames,
                                     int H, int W, int C, int scratch_words,
                                     void* stream) {
  return run_dfeat(flow, g, dfeat, scratch, frames, H, W, C, scratch_words,
                   static_cast<cudaStream_t>(stream));
}

// feat and g [frames, H, W, C] float32 (or bfloat16: dbsr_warp_dflow_bf16),
// flow and dflow [frames, H, W, 2] float32; contiguous, 16-byte aligned;
// any C (16-byte accesses where C % 4 == 0 in float32, C % 8 == 0 in bf16;
// 8-byte ones of bf16 where C % 4 == 0; one channel an access otherwise).
DBSR_EXPORT int dbsr_warp_dflow_f32(const float* feat, const float* flow,
                                    const float* g, float* dflow, int frames,
                                    int H, int W, int C, void* stream) {
  return run_dflow(feat, flow, g, dflow, frames, H, W, C,
                   static_cast<cudaStream_t>(stream));
}

DBSR_EXPORT int dbsr_warp_dflow_bf16(const bf16* feat, const float* flow,
                                     const bf16* g, float* dflow, int frames,
                                     int H, int W, int C, void* stream) {
  return run_dflow(feat, flow, g, dflow, frames, H, W, C,
                   static_cast<cudaStream_t>(stream));
}
