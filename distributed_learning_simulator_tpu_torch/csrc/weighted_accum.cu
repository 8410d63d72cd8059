// weighted_accum: out[i] = sum_c w[c] * x[c, i], f32 accumulation.
//
// Replaces: distributed_learning_simulator_tpu/ops/pallas_kernels.py
//   weighted_accum (:197-222) with its body _weighted_accum_kernel (:185),
//   the FedAvg aggregation epilogue's [C, N] x [C] contraction.
//
// Bound on the H100: memory.  The kernel reads C*N input elements once and
// writes N f32 outputs once; it does 2*C*N flops, far below the card's
// ridge.  So the design only has to stream bytes at full rate:
//   * each thread owns one 16-byte vector of a row (4 f32 or 8 bf16
//     values) and loops over the C rows itself, accumulating in f32
//     registers: no [C, N] temporary, no cross-block reduction;
//   * bf16 rows are read as bf16 and widened in registers, so the caller
//     never materialises an f32 copy of the stacked client parameters;
//   * a grid-stride loop keeps every SM busy for any N; the ragged tail
//     (N not a multiple of the vector width) and rows whose stride is not
//     16-byte aligned take the scalar path.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ float load_scalar(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_scalar(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

// One 16-byte vector widened to f32: 4 values for f32 rows, 8 for bf16.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kWidth = 4;
  __device__ __forceinline__ static void load(const float* row, int64_t v, float* out) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(row) + v);
    out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
  }
};
template <> struct Vec<uint16_t> {
  static constexpr int kWidth = 8;
  __device__ __forceinline__ static void load(const uint16_t* row, int64_t v, float* out) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(row) + v);
    out[0] = bf16_lo(q.x); out[1] = bf16_hi(q.x);
    out[2] = bf16_lo(q.y); out[3] = bf16_hi(q.y);
    out[4] = bf16_lo(q.z); out[5] = bf16_hi(q.z);
    out[6] = bf16_lo(q.w); out[7] = bf16_hi(q.w);
  }
};

template <typename T>
__global__ void weighted_accum_kernel(const T* __restrict__ x, const float* __restrict__ w,
                                      float* __restrict__ out, int64_t c, int64_t n,
                                      int64_t ld, int vectorised) {
  constexpr int W = Vec<T>::kWidth;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vectorised) {
    const int64_t nvec = n / W;
    for (int64_t v = tid; v < nvec; v += stride) {
      float acc[W];
#pragma unroll
      for (int j = 0; j < W; ++j) acc[j] = 0.f;
      for (int64_t k = 0; k < c; ++k) {
        const float wk = __ldg(w + k);
        float vals[W];
        Vec<T>::load(x + k * ld, v, vals);
#pragma unroll
        for (int j = 0; j < W; ++j) acc[j] = fmaf(wk, vals[j], acc[j]);
      }
      float4* dst = reinterpret_cast<float4*>(out) + v * (W / 4);
#pragma unroll
      for (int j = 0; j < W / 4; ++j)
        dst[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
    done = nvec * W;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    float acc = 0.f;
    for (int64_t k = 0; k < c; ++k) acc = fmaf(__ldg(w + k), load_scalar(x + k * ld + i), acc);
    out[i] = acc;
  }
}

template <typename T>
int launch(const void* x, const float* w, float* out, int64_t c, int64_t n, int64_t ld,
           cudaStream_t stream) {
  constexpr int W = Vec<T>::kWidth;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (ld % W == 0);
  const int threads = 256;
  const int64_t items = aligned ? (n + W - 1) / W : n;
  int64_t blocks = (items + threads - 1) / threads;
  const int64_t cap = 132 * 16;  // 16 resident blocks of 256 threads per SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  weighted_accum_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(x), w, out, c, n, ld, aligned ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32 rows, 1 = bfloat16 rows.  x is [c, n] with row stride
// ld elements; w is [c] f32; out is [n] f32.  All pointers are device
// pointers; the launch is asynchronous on `stream`.
int weighted_accum(int dtype, const void* x, const float* w, float* out, int64_t c,
                   int64_t n, int64_t ld, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, c, n, ld, s);
  if (dtype == 1) return launch<uint16_t>(x, w, out, c, n, ld, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
