// short_attention: softmax(Q K^T * Dh^-0.5) V read straight from the packed
// [B, S, 3*H*Dh] projection (Q | K | V, heads side by side), written straight
// into the [B, S, H*Dh] layout the output projection consumes, plus its
// backward into d(qkv) in the same packed layout.
//
// Replaces: distributed_learning_simulator_tpu/ops/short_attention.py
//   _call (:210-250) with _fwd_kernel (:134), reached through _short_fwd
//   (:266), and with _bwd_kernel (:159), reached through _short_bwd (:283).
//
// What bounds it on the H100.  At the slice's shape (B = 128, S = 64, H = 6,
// Dh = 64) one call moves ~19 MB (bf16) and does ~0.8 GFLOP: with the
// tensor cores it would be bound by bytes, at 3.35 TB/s.  These kernels are
// the simple, correct first version: they do the products on the f32 FMA
// units (67 TFLOP/s peak), which makes them bound by operations instead.
// wgmma, TMA and a pipelined K/V ring are later work.
//
// Design (not the TPU's): the TPU kernel holds one batch group's whole S x S
// score matrix in VMEM and stacks 128 // S batch elements into one MXU
// product.  Above S ~ 200 an f32 S x S tile no longer fits one block's
// 227 KB of shared memory, so here
//   * one block of 256 threads owns one (batch, head, 64-row tile); heads
//     are column slices of the packed rows, loaded into shared memory as f32
//     (bf16 products are exact in f32), so no head split/transpose ever
//     reaches device memory;
//   * the forward walks 64-row key tiles twice: the first pass builds the
//     per-row max and sum (online), giving the row log-sum-exp, which is
//     saved for the backward; the second forms the normalised probabilities
//     p = exp(s - lse), rounds them to the input dtype (as the TPU kernel
//     casts p before P.V) and accumulates P.V in f32 registers;
//   * the backward is FlashAttention-2 shaped: dq_kernel walks the key tiles
//     for one query tile (first pass: delta = rowsum(dP * P), the TPU
//     kernel's correction term, written out for the second kernel; second
//     pass: dS = P * (dP - delta) * scale rounded to the input dtype, then
//     dQ += dS K), and dkv_kernel walks the query tiles for one key tile
//     (dV += P^T dO with P rounded to the input dtype, dK += dS^T Q);
//   * each thread owns a 4 x 4 micro-tile of a 64 x 64 score tile (rows
//     ty + 16 i, columns tx + 16 j), so row reductions are shuffles within
//     16 lanes; shared rows are padded by one float so both operands of
//     every product are read without bank conflicts.
//
// Masking follows the TPU kernel: keys with kv_mask <= 0 score -1e30 (the
// TPU's _NEG_INF); keys past S do not exist here (the TPU pads them and
// masks them with -1e30, which gives the same result whenever a row has at
// least one real key).  Rows past S are neither read nor written.
//
// C interface (ctypes): every entry returns cudaGetLastError() after its
// launches; all pointers are device pointers; launches are asynchronous on
// `stream`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // rows per query tile and per key tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPLd = kTile + 1;
constexpr float kMasked = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// the value the TPU kernel sees after `.astype(input dtype)`
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// rows [row0, row0 + 64) of a row-major matrix, columns [col0, col0 + DH),
// into a [64][DH + 1] f32 tile; rows past S read as 0
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int64_t row_stride,
                                          int row0, int S, int col0) {
  for (int idx = threadIdx.x; idx < kTile * DH; idx += kThreads) {
    const int r = idx / DH, c = idx % DH, row = row0 + r;
    dst[r * (DH + 1) + c] =
        row < S ? to_f32<T>(base[static_cast<int64_t>(row) * row_stride + col0 + c]) : 0.f;
  }
}

// s[i][j] = A[ty + 16 i] . B[tx + 16 j]  (both [64][DH + 1] tiles)
template <int DH>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, float s[4][4], int ty,
                                         int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (DH + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// acc[i][j] += sum_k P[ty + 16 i][k] * X[k][tx + 16 j]   (P is [64][65])
template <int DH>
__device__ __forceinline__ void acc_px(const float* P, const float* X, float acc[4][DH / 16],
                                       int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * kPLd + k];
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      const float x = X[k * (DH + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
    }
  }
}

// acc[i][j] += sum_q P[q][ty + 16 i] * X[q][tx + 16 j]   (P^T X)
template <int DH>
__device__ __forceinline__ void acc_ptx(const float* P, const float* X, float acc[4][DH / 16],
                                        int ty, int tx) {
#pragma unroll 4
  for (int q = 0; q < kTile; ++q) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[q * kPLd + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      const float x = X[q * (DH + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
    }
  }
}

// scale, then mask: keys past S -> -inf (absent), kv_mask <= 0 -> -1e30
__device__ __forceinline__ void mask_scores(float s[4][4], int k0, int tx, int S,
                                            const float* mrow, float scale) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + tx + 16 * j;
    const bool present = key < S;
    const bool masked = present && mrow != nullptr && !(mrow[key] > 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[i][j] = !present ? -INFINITY : (masked ? kMasked : s[i][j] * scale);
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ mask, T* __restrict__ out,
               float* __restrict__ lse, int S, int H, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * (DH + 1);
  float* Vs = Ks + kTile * (DH + 1);
  float* Ps = Vs + kTile * (DH + 1);
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kTile;
  const int D = H * DH;
  const int64_t ld = 3 * static_cast<int64_t>(D);
  const T* base = qkv + static_cast<int64_t>(b) * S * ld;
  const float* mrow = mask ? mask + static_cast<int64_t>(b) * S : nullptr;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ntiles = (S + kTile - 1) / kTile;

  load_tile<T, DH>(Qs, base, ld, q0, S, h * DH);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    load_tile<T, DH>(Ks, base, ld, kt * kTile, S, D + h * DH);
    __syncthreads();
    float s[4][4];
    tile_dot<DH>(Qs, Ks, s, ty, tx);
    mask_scores(s, kt * kTile, tx, S, mrow, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], row_max16(mt));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum16(sum);
      m[i] = m_new;
    }
  }
  float row_lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_lse[i] = m[i] + logf(l[i]);
    const int q = q0 + ty + 16 * i;
    if (tx == 0 && q < S) lse[(static_cast<int64_t>(b) * H + h) * S + q] = row_lse[i];
  }

  float o[4][DH / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) o[i][j] = 0.f;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    load_tile<T, DH>(Ks, base, ld, kt * kTile, S, D + h * DH);
    load_tile<T, DH>(Vs, base, ld, kt * kTile, S, 2 * D + h * DH);
    __syncthreads();
    float s[4][4];
    tile_dot<DH>(Qs, Ks, s, ty, tx);
    mask_scores(s, kt * kTile, tx, S, mrow, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * kPLd + tx + 16 * j] = round_to<T>(expf(s[i][j] - row_lse[i]));
    __syncthreads();
    acc_px<DH>(Ps, Vs, o, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= S) continue;
    T* dst = out + (static_cast<int64_t>(b) * S + q) * D + h * DH;
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) dst[tx + 16 * j] = from_f32<T>(o[i][j]);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
              const T* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, T* __restrict__ dqkv, int S, int H, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * (DH + 1);
  float* Ks = dOs + kTile * (DH + 1);
  float* Vs = Ks + kTile * (DH + 1);
  float* dSs = Vs + kTile * (DH + 1);
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kTile;
  const int D = H * DH;
  const int64_t ld = 3 * static_cast<int64_t>(D);
  const T* base = qkv + static_cast<int64_t>(b) * S * ld;
  const T* dbase = dout + static_cast<int64_t>(b) * S * D;
  const float* mrow = mask ? mask + static_cast<int64_t>(b) * S : nullptr;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * S;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ntiles = (S + kTile - 1) / kTile;

  load_tile<T, DH>(Qs, base, ld, q0, S, h * DH);
  load_tile<T, DH>(dOs, dbase, D, q0, S, h * DH);
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    row_lse[i] = q < S ? lse[stat0 + q] : 0.f;
    row_delta[i] = 0.f;
  }
  // pass 1: delta = rowsum(dP * P)
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    load_tile<T, DH>(Ks, base, ld, kt * kTile, S, D + h * DH);
    load_tile<T, DH>(Vs, base, ld, kt * kTile, S, 2 * D + h * DH);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<DH>(Qs, Ks, s, ty, tx);
    mask_scores(s, kt * kTile, tx, S, mrow, scale);
    tile_dot<DH>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) row_delta[i] = fmaf(expf(s[i][j] - row_lse[i]), dp[i][j], row_delta[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_delta[i] = row_sum16(row_delta[i]);
    const int q = q0 + ty + 16 * i;
    if (tx == 0 && q < S) delta[stat0 + q] = row_delta[i];
  }
  // pass 2: dQ += dS K
  float dq[4][DH / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) dq[i][j] = 0.f;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    load_tile<T, DH>(Ks, base, ld, kt * kTile, S, D + h * DH);
    load_tile<T, DH>(Vs, base, ld, kt * kTile, S, 2 * D + h * DH);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<DH>(Qs, Ks, s, ty, tx);
    mask_scores(s, kt * kTile, tx, S, mrow, scale);
    tile_dot<DH>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - row_lse[i]);
        dSs[(ty + 16 * i) * kPLd + tx + 16 * j] = round_to<T>(p * (dp[i][j] - row_delta[i]) * scale);
      }
    __syncthreads();
    acc_px<DH>(dSs, Ks, dq, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= S) continue;
    T* dst = dqkv + (static_cast<int64_t>(b) * S + q) * ld + h * DH;
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) dst[tx + 16 * j] = from_f32<T>(dq[i][j]);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dqkv, int S, int H, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * (DH + 1);
  float* Qs = Vs + kTile * (DH + 1);
  float* dOs = Qs + kTile * (DH + 1);
  float* Ps = dOs + kTile * (DH + 1);
  float* dSs = Ps + kTile * kPLd;
  float* lse_s = dSs + kTile * kPLd;
  float* delta_s = lse_s + kTile;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kTile;
  const int D = H * DH;
  const int64_t ld = 3 * static_cast<int64_t>(D);
  const T* base = qkv + static_cast<int64_t>(b) * S * ld;
  const T* dbase = dout + static_cast<int64_t>(b) * S * D;
  const float* mrow = mask ? mask + static_cast<int64_t>(b) * S : nullptr;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * S;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ntiles = (S + kTile - 1) / kTile;

  load_tile<T, DH>(Ks, base, ld, k0, S, D + h * DH);
  load_tile<T, DH>(Vs, base, ld, k0, S, 2 * D + h * DH);
  float dk[4][DH / 16], dv[4][DH / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) { dk[i][j] = 0.f; dv[i][j] = 0.f; }
  for (int qt = 0; qt < ntiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, DH>(Qs, base, ld, q0, S, h * DH);
    load_tile<T, DH>(dOs, dbase, D, q0, S, h * DH);
    if (threadIdx.x < kTile) {
      const int q = q0 + threadIdx.x;
      lse_s[threadIdx.x] = q < S ? lse[stat0 + q] : 0.f;
      delta_s[threadIdx.x] = q < S ? delta[stat0 + q] : 0.f;
    }
    __syncthreads();
    // rows are queries ty + 16 i, columns are this block's keys tx + 16 j
    float s[4][4], dp[4][4];
    tile_dot<DH>(Qs, Ks, s, ty, tx);
    mask_scores(s, k0, tx, S, mrow, scale);
    tile_dot<DH>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const bool row_present = q0 + r < S;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = row_present ? expf(s[i][j] - lse_s[r]) : 0.f;
        Ps[r * kPLd + tx + 16 * j] = round_to<T>(p);
        dSs[r * kPLd + tx + 16 * j] = round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);
      }
    }
    __syncthreads();
    acc_ptx<DH>(Ps, dOs, dv, ty, tx);
    acc_ptx<DH>(dSs, Qs, dk, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= S) continue;
    T* dst = dqkv + (static_cast<int64_t>(b) * S + key) * ld + h * DH;
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      dst[D + tx + 16 * j] = from_f32<T>(dk[i][j]);
      dst[2 * D + tx + 16 * j] = from_f32<T>(dv[i][j]);
    }
  }
}

constexpr size_t tile_bytes(int dh) { return sizeof(float) * kTile * (dh + 1); }
constexpr size_t p_bytes() { return sizeof(float) * kTile * kPLd; }
// Dh^-0.5 rounded once from double, as the TPU kernel's `dh**-0.5` is
inline float softmax_scale(int dh) { return static_cast<float>(1.0 / sqrt(double(dh))); }

template <typename T, int DH>
int fwd(const void* qkv, const float* mask, void* out, float* lse, int B, int S, int H,
        cudaStream_t stream) {
  const size_t bytes = 3 * tile_bytes(DH) + p_bytes();
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  fwd_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<T*>(out), lse, S, H, softmax_scale(DH));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int bwd(const void* qkv, const float* mask, const void* dout, const float* lse, float* delta,
        void* dqkv, int B, int S, int H, cudaStream_t stream) {
  const size_t dq_bytes = 4 * tile_bytes(DH) + p_bytes();
  const size_t dkv_bytes = 4 * tile_bytes(DH) + 2 * p_bytes() + 2 * sizeof(float) * kTile;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  const float scale = softmax_scale(DH);
  dq_kernel<T, DH><<<grid, kThreads, dq_bytes, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dqkv), S, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<T, DH><<<grid, kThreads, dkv_bytes, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dqkv), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  qkv [B, S, 3*H*Dh]; mask [B, S] f32 or
// null; out [B, S, H*Dh]; lse [B, H, S] f32.
int short_attention_fwd(int dtype, const void* qkv, const float* mask, void* out, float* lse,
                        int B, int S, int H, int Dh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 64) return fwd<float, 64>(qkv, mask, out, lse, B, S, H, s);
  if (dtype == 0 && Dh == 128) return fwd<float, 128>(qkv, mask, out, lse, B, S, H, s);
  if (dtype == 1 && Dh == 64) return fwd<__nv_bfloat16, 64>(qkv, mask, out, lse, B, S, H, s);
  if (dtype == 1 && Dh == 128) return fwd<__nv_bfloat16, 128>(qkv, mask, out, lse, B, S, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dout [B, S, H*Dh]; lse [B, H, S] from the forward; delta [B, H, S] f32
// scratch; dqkv [B, S, 3*H*Dh] (every element written).
int short_attention_bwd(int dtype, const void* qkv, const float* mask, const void* dout,
                        const float* lse, float* delta, void* dqkv, int B, int S, int H, int Dh,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 64)
    return bwd<float, 64>(qkv, mask, dout, lse, delta, dqkv, B, S, H, s);
  if (dtype == 0 && Dh == 128)
    return bwd<float, 128>(qkv, mask, dout, lse, delta, dqkv, B, S, H, s);
  if (dtype == 1 && Dh == 64)
    return bwd<__nv_bfloat16, 64>(qkv, mask, dout, lse, delta, dqkv, B, S, H, s);
  if (dtype == 1 && Dh == 128)
    return bwd<__nv_bfloat16, 128>(qkv, mask, dout, lse, delta, dqkv, B, S, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
