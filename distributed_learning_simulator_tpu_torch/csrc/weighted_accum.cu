// weighted_accum: out[i] = sum_c w[c] * x[c, i], f32 accumulation.
//
// Replaces: distributed_learning_simulator_tpu/ops/pallas_kernels.py
//   weighted_accum (:197-222) with its body _weighted_accum_kernel (:185),
//   the FedAvg aggregation epilogue's [C, N] x [C] contraction.
//
// Bound on the H100: bytes.  The kernel reads C*N input elements once and
// writes N f32 outputs once; its 2*C*N flops are far below the card's
// ridge.  What keeps it from that bound is latency and occupancy: a load
// from L2 or HBM takes hundreds of cycles, so every SM needs many 16-byte
// loads in flight, from threads few enough registers keep resident, and
// at small N the work must still spread over the 132 SMs.  The launch
// shape (the plan) is chosen in ops/weighted_accum.py::plan; the entry
// below only checks that it can run it.  Each variant issues the loads of
// a chunk of U rows before their FMAs and sums in a fixed order, so equal
// inputs give equal bits; every grid is a block a tile of column items:
//   * split (many rows, few columns: the graph sessions' [50, 9,231]): a
//     warp's lanes form row groups of 2-32 lanes, each group walks its own
//     run of at most 8 rows (one chunk), and the groups' sums meet by
//     butterfly shuffles in the warp (no shared memory, no atomics); the
//     narrow column tile a warp keeps gives 145 blocks at the graph shape.
//   * stream (the ViT, DenseNet-40, vote and subset chunks): one thread
//     walks all rows of its V items, U rows a chunk: from L2, 1 vector of
//     4 rows (f32) or 2 vectors of 1 row (bf16) in 128-thread blocks, few
//     registers a thread, so the blocks of an L2-sized chunk all fit the
//     SMs at once; from device memory, 4 vectors of 2 rows.
//   * scalar (a row stride or base that is not 16-byte aligned): the
//     stream variant with one element a load.
// The ragged end (N not a multiple of the vector width W) is one more
// column item.  Where the row stride pads past it (the sessions pad rows
// to 64 elements) it is read whole from the padding and only its valid
// lanes are stored; else the thread that holds it (or items past the end)
// takes a path with a test a load, lane by lane, and walks its rows once.
// bf16 rows are read as bf16 and widened in registers, so no caller
// materialises an f32 copy of the stacked rows.
//
// C interface (ctypes): returns cudaErrorInvalidValue for a plan it cannot
// run, else cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 0, kStream = 1, kScalar = 2;
// blocks of at most 256 threads
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) { return __uint_as_float(static_cast<uint32_t>(v) << 16); }
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// W consecutive values of a row: one 16-byte load (4 f32 or 8 bf16
// values) or, at W = 1, one element, kept as loaded (Raw) until the FMAs
// widen it to f32, so a chunk of loads in flight costs 4 registers each.
template <typename T, int W> struct Vec;
template <typename T> struct Vec<T, 1> {
  using Raw = T;
  __device__ __forceinline__ static Raw load(const T* p) { return __ldg(p); }
  __device__ __forceinline__ static Raw load_part(const T* p, int64_t valid) { return valid > 0 ? __ldg(p) : T(0); }
  __device__ __forceinline__ static void unpack(Raw r, float* out) { out[0] = widen(r); }
};
template <> struct Vec<float, 4> {
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ __forceinline__ static Raw load_part(const float* p, int64_t valid) {
    return make_float4(valid > 0 ? __ldg(p) : 0.f, valid > 1 ? __ldg(p + 1) : 0.f, valid > 2 ? __ldg(p + 2) : 0.f,
                       valid > 3 ? __ldg(p + 3) : 0.f);
  }
  __device__ __forceinline__ static void unpack(Raw q, float* out) {
    out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
  }
};
template <> struct Vec<uint16_t, 8> {
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const uint16_t* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ static Raw load_part(const uint16_t* p, int64_t valid) {
    uint32_t h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = valid > e ? __ldg(p + e) : 0u;
    return make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16, h[6] | h[7] << 16);
  }
  __device__ __forceinline__ static void unpack(Raw q, float* out) {
    out[0] = bf16_lo(q.x); out[1] = bf16_hi(q.x);
    out[2] = bf16_lo(q.y); out[3] = bf16_hi(q.y);
    out[4] = bf16_lo(q.z); out[5] = bf16_hi(q.z);
    out[6] = bf16_lo(q.w); out[7] = bf16_hi(q.w);
  }
};

// x: [c, n] rows at stride ld.  A warp's 32 lanes form 32 / lanes row
// groups of `lanes` lanes (kSplit; else one group of all rows); group g
// sums rows [g * rows, (g + 1) * rows).  Lane l of a group owns column
// items ct + j * cols of each tile (ct = its warp's lanes before it plus
// l, cols = warps * lanes, j < V), W values an item.  A thread whose items
// are all whole loads walks its rows U at a time with no test on the way;
// the thread that holds the ragged end of rows without padding, or items
// past the end, walks them once with a test a load.  kSplit: the groups'
// sums meet by butterfly shuffles (each lane adds the same pairs, so
// every lane holds the same bits), and group 0 stores.
template <typename T, int W, int V, int U, bool kSplit>
__global__ void __launch_bounds__(kMaxThreads) weighted_accum_kernel(
    const T* __restrict__ x, const float* __restrict__ w, float* __restrict__ out, int c, int n, int64_t ld,
    int lanes, int rows, int padded) {
  using Raw = typename Vec<T, W>::Raw;
  const int lane32 = threadIdx.x % 32;
  const int group = kSplit ? lane32 / lanes : 0;
  const int cols = kSplit ? blockDim.x / 32 * lanes : blockDim.x;
  const int ct = kSplit ? threadIdx.x / 32 * lanes + lane32 % lanes : threadIdx.x;
  const int64_t row0 = kSplit ? static_cast<int64_t>(group) * rows : 0;
  const int64_t left = c - row0;  // rows from the group's first on
  const int nrows = kSplit ? static_cast<int>(left < 0 ? 0 : left < rows ? left : rows) : c;
  const T* first = x + row0 * ld;
  const float* wg = w + row0;
  const int items = (n + W - 1) / W;
  const int whole = n / W;                    // items with all W values valid
  const int loaded = padded ? items : whole;  // items read as one load
  const int per_tile = cols * V;
  for (int tile = blockIdx.x; tile < (items + per_tile - 1) / per_tile; tile += gridDim.x) {
    const int item0 = tile * per_tile + ct;  // item j: item0 + j * cols
    float acc[V][W];
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int e = 0; e < W; ++e) acc[j][e] = 0.f;
    if (item0 + (V - 1) * cols < loaded) {
      const T* col = first + static_cast<int64_t>(item0) * W;
      for (int k0 = 0; k0 < nrows; k0 += U) {
        float wk[U];
        Raw raw[U][V];
#pragma unroll
        for (int u = 0; u < U; ++u) {  // every load of the chunk before its FMAs
          if (k0 + u < nrows) {
            wk[u] = __ldg(wg + k0 + u);
#pragma unroll
            for (int j = 0; j < V; ++j) raw[u][j] = Vec<T, W>::load(col + (k0 + u) * ld + j * cols * W);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (k0 + u < nrows) {
#pragma unroll
            for (int j = 0; j < V; ++j) {
              float v[W];
              Vec<T, W>::unpack(raw[u][j], v);
#pragma unroll
              for (int e = 0; e < W; ++e) acc[j][e] = fmaf(wk[u], v[e], acc[j][e]);
            }
          }
        }
      }
    } else {
      for (int k = 0; k < nrows; ++k) {
        const float wk = __ldg(wg + k);
        const T* row = first + k * ld;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int item = item0 + j * cols;
          float v[W];
          Vec<T, W>::unpack(item < loaded ? Vec<T, W>::load(row + static_cast<int64_t>(item) * W)
                                          : Vec<T, W>::load_part(row + static_cast<int64_t>(item) * W, n - item * W),
                            v);
#pragma unroll
          for (int e = 0; e < W; ++e) acc[j][e] = fmaf(wk, v[e], acc[j][e]);
        }
      }
    }
    if constexpr (kSplit) {
      for (int offset = lanes; offset < 32; offset *= 2) {
#pragma unroll
        for (int j = 0; j < V; ++j)
#pragma unroll
          for (int e = 0; e < W; ++e) acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], offset);
      }
      if (group > 0) continue;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int item = item0 + j * cols;
      if (item < whole) {
        if constexpr (W % 4 == 0) {
          float4* dst = reinterpret_cast<float4*>(out + static_cast<int64_t>(item) * W);
#pragma unroll
          for (int q = 0; q < W / 4; ++q)
            dst[q] = make_float4(acc[j][4 * q], acc[j][4 * q + 1], acc[j][4 * q + 2], acc[j][4 * q + 3]);
        } else {
          out[item] = acc[j][0];
        }
      } else if (item < items) {
#pragma unroll
        for (int e = 0; e < W; ++e)
          if (item * W + e < n) out[item * W + e] = acc[j][e];
      }
    }
  }
}

template <typename T, int W, int V, int U, bool kSplit>
int launch_kernel(const void* x, const float* w, float* out, int64_t c, int64_t n, int64_t ld, int64_t blocks,
                  int threads, int lanes, int rows, int padded, cudaStream_t stream) {
  weighted_accum_kernel<T, W, V, U, kSplit><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(x), w, out, static_cast<int>(c), static_cast<int>(n), ld, lanes, rows, padded);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int variant, const void* x, const float* w, float* out, int64_t c, int64_t n, int64_t ld,
           int64_t extent, int64_t blocks, int threads, int lanes, int rows, int vectors, int unroll, int padded,
           cudaStream_t s) {
  constexpr int W = 16 / sizeof(T);
  const bool vector = variant != kScalar;
  const int width = vector ? W : 1;
  const int64_t items = (n + width - 1) / width;
  const int64_t groups = lanes >= 1 ? 32 / lanes : 0;
  // a plan that does not cover the rows, does not fit a block, or loads
  // what the layout cannot give is refused before any work (item and
  // value indices are 32-bit: n below 2^31 - 2^10)
  const bool shape_ok = c >= 1 && c <= INT32_MAX && n >= 1 && n <= INT32_MAX - 1024 && ld >= 0 && threads >= 32 &&
                        threads <= kMaxThreads && threads % 32 == 0 && lanes >= 1 && lanes <= 32 && 32 % lanes == 0 &&
                        rows >= 1 && groups * rows >= c && vectors >= 1 && (c - 1) * ld + n <= extent;
  // at most a block a tile: no block starts past the last tile
  const int64_t per_tile = shape_ok ? static_cast<int64_t>(threads) / 32 * lanes * vectors : 1;
  const bool grid_ok = blocks >= 1 && blocks <= (items + per_tile - 1) / per_tile;
  const bool layout_ok = !vector || (reinterpret_cast<uintptr_t>(x) % 16 == 0 && ld % W == 0);
  const bool padded_ok = !padded || (vector && ld >= items * W && (c - 1) * ld + items * W <= extent);
  // split: row groups within a warp, one item a lane; stream and scalar:
  // one group walks every row
  const bool variant_ok = variant == kSplit ? vectors == 1 : lanes == 32 && rows == c;
  if (!shape_ok || !grid_ok || !layout_ok || !padded_ok || !variant_ok) return static_cast<int>(cudaErrorInvalidValue);
  const int code = vectors * 16 + unroll;  // (vectors, rows unrolled) as built
#define WA_LAUNCH(W_, V_, U_, SPLIT_) \
  launch_kernel<T, W_, V_, U_, SPLIT_>(x, w, out, c, n, ld, blocks, threads, lanes, rows, padded, s)
  const int refused = static_cast<int>(cudaErrorInvalidValue);
  if (variant == kScalar) return code == 4 * 16 + 2 ? WA_LAUNCH(1, 4, 2, false) : refused;
  if (variant == kSplit) return code == 1 * 16 + 8 ? WA_LAUNCH(W, 1, 8, true) : refused;
  switch (code) {
    case 1 * 16 + 4: return WA_LAUNCH(W, 1, 4, false);
    case 2 * 16 + 1: return WA_LAUNCH(W, 2, 1, false);
    case 4 * 16 + 2: return WA_LAUNCH(W, 4, 2, false);
    default: return refused;
  }
#undef WA_LAUNCH
}

// No work: its time on a grid is the floor of any kernel on that grid
// (chip_smoke.py times it beside the split variant).
__global__ void weighted_accum_empty_kernel() {}

}  // namespace

extern "C" {

// dtype: 0 = float32 rows, 1 = bfloat16 rows.  x is [c, n] with row stride
// ld elements, `extent` elements readable from x; w is [c] f32; out is [n]
// f32.  variant: 0 split, 1 stream, 2 scalar; blocks, threads, lanes, rows,
// vectors, unroll and padded: the plan of ops/weighted_accum.py::plan.  All
// pointers are device pointers; the launch is asynchronous on `stream`.
int weighted_accum(int dtype, const void* x, const float* w, float* out, int64_t c, int64_t n, int64_t ld,
                   int64_t extent, int variant, int64_t blocks, int threads, int lanes, int rows, int vectors,
                   int unroll, int padded, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant < kSplit || variant > kScalar) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(variant, x, w, out, c, n, ld, extent, blocks, threads, lanes, rows, vectors, unroll, padded, s);
  if (dtype == 1)
    return launch<uint16_t>(variant, x, w, out, c, n, ld, extent, blocks, threads, lanes, rows, vectors, unroll,
                            padded, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The empty kernel on `blocks` x `threads`, for timing the launch floor.
int weighted_accum_empty(int64_t blocks, int threads, void* stream) {
  if (blocks < 1 || blocks > INT32_MAX || threads < 1 || threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  weighted_accum_empty_kernel<<<static_cast<unsigned>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
