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
// Dh = 64) one forward moves 25.4 MB (bf16) and does 0.8 GFLOP: with the
// tensor cores it is bound by bytes, at 3.35 TB/s.  Two forward routes
// compute the same function; the caller picks one from dtype, Dh and
// layout (ops/short_attention.py::fwd_route) and the entry refuses a route
// it cannot take:
//   * wgmma (route 1): bf16 at Dh 64 (the ViT and fed_obd_sq paths):
//     short_fwd_wgmma_kernel, at the end of the kernels below, with TMA
//     loads and wgmma products (its own note says how);
//   * FMA (route 0): f32 (whose products must stay exact f32), Dh 128 and
//     rows the tensor maps cannot describe: fwd_kernel, the first version,
//     with the products on the f32 FMA units (67 TFLOP/s peak), which makes
//     it bound by operations instead.
// The backward has two routes likewise (ops/short_attention.py::bwd_route):
//   * wgmma (route 1): bf16 at Dh 64 and S <= 64 (the ViT and fed_obd_sq
//     paths): short_bwd_wgmma_kernel, after the forward's, in one launch;
//   * FMA (route 0): every other case the forward takes (f32, Dh 128,
//     64 < S <= 1024): dq_kernel and dkv_kernel, the first version.
//
// Design of the FMA kernels (not the TPU's): the TPU kernel holds one batch
// group's whole S x S score matrix in VMEM and stacks 128 // S batch
// elements into one MXU product.  Above S ~ 200 an f32 S x S tile no longer
// fits one block's 227 KB of shared memory, so here
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ----------------------------------------------------------------------------
// Hopper forward: short_fwd_wgmma_kernel, K4 at bf16 and Dh 64 (the ViT and
// fed_obd_sq paths: S = 64), the same function and roundings as fwd_kernel.
//
// What bounds it on the H100: bytes.  At the ViT-small shape (qkv
// [128, 64, 1152] bf16, 6 heads) a call moves 25.4 MB against 0.81 GFLOP,
// 7.6 us at 3.35 TB/s against 0.8 us of tensor-core time, so the design
// keeps many bytes in flight and stores whole 16-byte pieces; the products
// are minor.  fwd_kernel (the route of f32 and Dh 128) widens every bf16
// element to f32 in shared memory with a 2-byte load, computes Q.K^T twice
// and holds 66.6 KB of f32 tiles a block.
//
// Design:
//   * a block owns one batch element, a 64-row query tile and a pair of
//     heads, one consumer warpgroup a head.  One warp fills each stage:
//     lane 0 brings the heads' tiles by TMA straight from the packed rows
//     (three 4-d tensor maps over the [B, S, 3, H, Dh] view, rows past S
//     zero-filled) while all 32 lanes write the tile's key states
//     (present and unmasked, masked, or past S) and an all-present-and-
//     unmasked flag, arriving on the stage's full barrier with them;
//   * S <= 64 (PASSES 1): a single pass.  The first warp of warpgroup 0
//     fills the one stage (Q, K and V) and then consumes.  S = Q.K^T on
//     wgmma from two K-major descriptors; the exact row maximum, sum and
//     lse from the accumulator in registers (quad shuffles);
//     p = exp(s - lse) rounded to bf16 straight into A fragments;
//     O = P.V on wgmma with V as the MN-major B operand.  256 threads and
//     about 50 KB a block: three blocks an SM (at most 85 registers a
//     thread), so the ViT-small call (384 blocks) is one wave of loads;
//   * 64 < S <= 1024 (PASSES 2): the two passes the function needs over
//     64-key tiles through a 2-stage mbarrier ring filled by a producer
//     warp of its own (pass 1: K tiles, online maximum and sum; pass 2:
//     K and V tiles, p and P.V);
//   * the epilogue writes O as bf16 into the warpgroup's own Q tile (free
//     once its last score product has completed) in the tile's 128-byte
//     swizzle, then stores whole rows with 16-byte stores into
//     [B, S, H*Dh]; lse [B, H, S] f32 as before.
constexpr int kSwHeads = 2;  // heads a block owns, a consumer warpgroup each
// threads of a block: the consumers, and for two passes a producer warp
__host__ __device__ constexpr int sw_threads(int passes) { return 128 * kSwHeads + (passes == 1 ? 0 : 32); }
constexpr int kSwRow = 128;              // bytes of a 64-wide bf16 row
constexpr int kSwTile = kTile * kSwRow;  // a 64-row Q, K or V tile
constexpr int kSwStages = 2;             // the ring of the two-pass walk

// byte offsets from the 1024-aligned base of a block's shared memory with
// `nst` stages: the heads' Q tiles, then per stage the heads' K tiles and
// V tiles, the key states (a byte a key), the all-valid flags, the barriers
__host__ __device__ constexpr int sw_stage(int s) { return kSwHeads * kSwTile + s * 2 * kSwHeads * kSwTile; }
__host__ __device__ constexpr int sw_codes(int nst) { return sw_stage(nst); }
__host__ __device__ constexpr int sw_flags(int nst) { return sw_codes(nst) + nst * kTile; }
__host__ __device__ constexpr int sw_bars(int nst) { return sw_flags(nst) + 8 * nst; }
constexpr size_t sw_smem_bytes(int nst) { return sw_bars(nst) + (2 * nst + 1) * sizeof(uint64_t) + 1024; }

// key states of one 64-key tile
constexpr uint32_t kKeyAbsent = 0, kKeyMasked = 1, kKeyValid = 2;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S = Q . K^T of one 64-key tile as one group (m64n64, 4 k16 steps)
__device__ __forceinline__ void sw_scores(float (&s)[32], uint64_t dq, const unsigned char* Kt) {
  const uint64_t dk = hopper::desc_k_major<kSwRow>(Kt);
  hopper::wgmma_fence();
  hopper::wgmma_ss_init(s, dq, dk);
#pragma unroll
  for (int ks = 1; ks < 4; ++ks) hopper::wgmma_ss_acc(s, hopper::desc_add(dq, 32 * ks), hopper::desc_add(dk, 32 * ks));
  hopper::wgmma_commit();
}

// scale, then mask, this thread's scores of one tile (accumulator layout,
// hopper.cuh: s[4j + 2h + e] is row lo + 8h, key 8j + 2t + e): keys past S
// -> -inf (absent), kv_mask <= 0 -> -1e30
__device__ __forceinline__ void sw_mask(float (&s)[32], const uint8_t* code, bool all_valid, float scale, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t c = all_valid ? kKeyValid : code[8 * j + 2 * t + e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& x = s[4 * j + 2 * h + e];
        x = c == kKeyValid ? x * scale : (c == kKeyMasked ? kMasked : -INFINITY);
      }
    }
}

// p = exp(s - lse) rounded to bf16 into the A fragments of P.V (hopper.cuh)
__device__ __forceinline__ void sw_probs(const float (&s)[32], uint32_t (&pa)[4][4], float lse_lo, float lse_hi) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float l = r % 2 ? lse_hi : lse_lo;  // s[8k + 2r + e] is row lo + 8 (r % 2)
      pa[k][r] = hopper::pack_bf16x2(expf(s[8 * k + 2 * r] - l), expf(s[8 * k + 2 * r + 1] - l));
    }
}

// o += P . V as one group, V MN-major
__device__ __forceinline__ void sw_pv(float (&o)[32], const uint32_t (&pa)[4][4], const unsigned char* Vt) {
  const uint64_t dv = hopper::desc_mn_major<kSwRow>(Vt);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) hopper::wgmma_rs(o, pa[k], hopper::desc_add(dv, k * 16 * kSwRow));
  hopper::wgmma_commit();
}

// the states of keys k0 + 2 lane and + 1 (present and unmasked, masked, or
// past S) into codes[2 lane], codes[2 lane + 1]; returns (to the whole warp)
// whether all 64 keys of the tile are present and unmasked
__device__ __forceinline__ bool sw_key_codes(uint8_t* codes, const float* mrow, int k0, int S, int lane) {
  uint32_t word = 0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = k0 + 2 * lane + e;
    const uint32_t c = key >= S ? kKeyAbsent : (mrow != nullptr && !(mrow[key] > 0.f) ? kKeyMasked : kKeyValid);
    word |= c << (8 * e);
  }
  reinterpret_cast<uint16_t*>(codes)[lane] = static_cast<uint16_t>(word);
  return __all_sync(0xffffffffu, word == (kKeyValid | kKeyValid << 8));
}

// a bf16 pair into columns 8 j + 2 t and + 1 of row r of a 64 x 64 tile
// in its 128-byte swizzle: 16-byte chunk j of row r sits at chunk
// j ^ (r % 8), so the writes of a warp fall in distinct banks
__device__ __forceinline__ void sw_put(unsigned char* tile, int r, int j, int t, uint32_t pair) {
  *reinterpret_cast<uint32_t*>(tile + r * kSwRow + ((j ^ (r & 7)) << 4) + 4 * t) = pair;
}

// a warpgroup's accumulator (rows r_lo and r_lo + 8 of this thread) as
// bf16 into a 64 x 64 tile
__device__ __forceinline__ void sw_put_acc(unsigned char* tile, const float (&d)[32], int r_lo, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < 8; ++j) sw_put(tile, r_lo + 8 * hh, j, t, hopper::pack_bf16x2(d[4 * j + 2 * hh], d[4 * j + 2 * hh + 1]));
}

// rows [0, rows) of a staged 64 x 64 bf16 tile out to dst (rows `ld`
// elements apart) with 16-byte stores, by the warpgroup's 128 threads
__device__ __forceinline__ void sw_store_rows(__nv_bfloat16* dst, int64_t ld, const unsigned char* tile, int rows,
                                              int tid) {
  for (int i = tid; i < kTile * 8; i += 128) {
    const int r = i / 8, c = i % 8;
    if (r < rows)
      *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = *reinterpret_cast<const uint4*>(tile + r * kSwRow + ((c ^ (r & 7)) << 4));
  }
}

// the named barrier of consumer warpgroup wg (IDs 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  if (wg == 0)
    hopper::named_barrier<1, 128>();
  else
    hopper::named_barrier<2, 128>();
}

template <int PASSES>
__global__ void __launch_bounds__(sw_threads(PASSES), PASSES == 1 ? 3 : 1)
    short_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ mask,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S, int H, float scale) {
  constexpr int nst = PASSES == 1 ? 1 : kSwStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                         ~uintptr_t(1023));
  uint8_t* codes = base + sw_codes(nst);
  int* flags = reinterpret_cast<int*>(base + sw_flags(nst));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + sw_bars(nst));
  uint64_t* empty = full + nst;
  uint64_t* qbar = empty + nst;
  const int q0 = blockIdx.x * kTile, h0 = blockIdx.y * kSwHeads, b = blockIdx.z;
  const int heads = min(kSwHeads, H - h0);  // 1 in the last block of an odd H
  const int nk = (S + kTile - 1) / kTile;   // 1 when PASSES == 1
  const int wg = threadIdx.x / 128;  // kSwHeads: the producer warp
  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], 128 * kSwHeads);
    }
    if constexpr (PASSES == 2) hopper::mbar_init(qbar, 1);  // one pass: Q rides with the stage
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // one warp fills stage `stage` with key tile kt: the keys' states and
  // flag, then (lane 0) the heads' K tiles, V tiles `with_v` and Q tiles
  // `with_q`, all on the stage's full barrier
  const int lane = threadIdx.x % 32;
  const float* mrow = mask ? mask + static_cast<int64_t>(b) * S : nullptr;
  const CUtensorMap *map_q = &tm_q, *map_k = &tm_k, *map_v = &tm_v;
  auto fill = [&](int stage, int kt, bool with_v, bool with_q) {
    const bool all = sw_key_codes(codes + stage * kTile, mrow, kt * kTile, S, lane);
    unsigned char* st = base + sw_stage(stage);
    if (lane == 0) {
      flags[stage] = all;
      hopper::mbar_arrive_expect_tx(&full[stage], heads * (1 + with_v + with_q) * kSwTile);
      for (int w = 0; w < heads; ++w) {
        if (with_q) hopper::tma_load_4d(base + w * kSwTile, map_q, &full[stage], 0, h0 + w, q0, b);
        hopper::tma_load_4d(st + w * kSwTile, map_k, &full[stage], 0, h0 + w, kt * kTile, b);
        if (with_v)
          hopper::tma_load_4d(st + (kSwHeads + w) * kSwTile, map_v, &full[stage], 0, h0 + w, kt * kTile, b);
      }
    } else {
      hopper::mbar_arrive(&full[stage]);
    }
  };

  if constexpr (PASSES == 1) {
    if (threadIdx.x < 32) fill(0, 0, true, true);
  } else if (wg == kSwHeads) {
    // the producer: Q once, then pass 1's K tiles, then pass 2's K and V
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(qbar, heads * kSwTile);
      for (int w = 0; w < heads; ++w) hopper::tma_load_4d(base + w * kSwTile, map_q, qbar, 0, h0 + w, q0, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < 2 * nk; ++it) {
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      fill(stage, it < nk ? it : it - nk, it >= nk, false);
      if (++stage == nst) { stage = 0; phase ^= 1; }
    }
    return;
  }

  // consumers: warpgroup wg takes head h0 + wg, if the block has it
  if (wg >= heads) {
    if constexpr (PASSES == 2) {  // release each stage of the walk with the other warpgroup
      for (int it = 0, stage = 0, phase = 0; it < 2 * nk; ++it) {
        hopper::mbar_wait(&full[stage], phase);
        hopper::mbar_arrive(&empty[stage]);
        if (++stage == nst) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }
  const int h = h0 + wg, tid = threadIdx.x % 128, t = tid % 4;
  const int r_lo = tid / 32 * 16 + tid % 32 / 4;  // this thread's rows of the tile: r_lo and r_lo + 8
  unsigned char* Qs = base + wg * kSwTile;
  const uint64_t dq = hopper::desc_k_major<kSwRow>(Qs);
  float s[32], o[32], lse_lo, lse_hi;
  uint32_t pa[4][4];
  if constexpr (PASSES == 1) {
    const unsigned char* st = base + sw_stage(0);
    hopper::mbar_wait(&full[0], 0);
    sw_scores(s, dq, st + wg * kSwTile);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    sw_mask(s, codes, flags[0] != 0, scale, t);
    // the exact row maximum and sum of the one tile
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        m_lo = fmaxf(m_lo, s[4 * j + e]);
        m_hi = fmaxf(m_hi, s[4 * j + 2 + e]);
      }
    m_lo = quad_max(m_lo);
    m_hi = quad_max(m_hi);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l_lo += expf(s[4 * j + e] - m_lo);
        l_hi += expf(s[4 * j + 2 + e] - m_hi);
      }
    lse_lo = m_lo + logf(quad_sum(l_lo));
    lse_hi = m_hi + logf(quad_sum(l_hi));
    sw_probs(s, pa, lse_lo, lse_hi);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    sw_pv(o, pa, st + (kSwHeads + wg) * kSwTile);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(pa);
  } else {
    int stage = 0;
    uint32_t phase = 0;
    hopper::mbar_wait(qbar, 0);
    // pass 1: online row maximum and sum (partial sums per thread against
    // the quad's common maximum)
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      hopper::mbar_wait(&full[stage], phase);
      sw_scores(s, dq, base + sw_stage(stage) + wg * kSwTile);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      sw_mask(s, codes + stage * kTile, flags[stage] != 0, scale, t);
      hopper::mbar_arrive(&empty[stage]);
      if (++stage == nst) { stage = 0; phase ^= 1; }
      float t_lo = m_lo, t_hi = m_hi;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          t_lo = fmaxf(t_lo, s[4 * j + e]);
          t_hi = fmaxf(t_hi, s[4 * j + 2 + e]);
        }
      t_lo = quad_max(t_lo);
      t_hi = quad_max(t_hi);
      l_lo *= expf(m_lo - t_lo);
      l_hi *= expf(m_hi - t_hi);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          l_lo += expf(s[4 * j + e] - t_lo);
          l_hi += expf(s[4 * j + 2 + e] - t_hi);
        }
      m_lo = t_lo;
      m_hi = t_hi;
    }
    lse_lo = m_lo + logf(quad_sum(l_lo));
    lse_hi = m_hi + logf(quad_sum(l_hi));
    // pass 2: p = exp(s - lse) rounded, o += P V
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      hopper::mbar_wait(&full[stage], phase);
      const unsigned char* st = base + sw_stage(stage);
      sw_scores(s, dq, st + wg * kSwTile);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      sw_mask(s, codes + stage * kTile, flags[stage] != 0, scale, t);
      sw_probs(s, pa, lse_lo, lse_hi);
      sw_pv(o, pa, st + (kSwHeads + wg) * kSwTile);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      hopper::mbar_arrive(&empty[stage]);
      if (++stage == nst) { stage = 0; phase ^= 1; }
    }
  }

  // O as bf16 into this warpgroup's Q tile (each warp's scores read only
  // its own 16 rows of Q), then whole rows out with 16-byte stores
  sw_put_acc(Qs, o, r_lo, t);
  wg_sync(wg);
  const int64_t D = static_cast<int64_t>(H) * 64;
  sw_store_rows(out + (static_cast<int64_t>(b) * S + q0) * D + h * 64, D, Qs, S - q0, tid);
  if (t == 0) {
    const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * S;
    if (q0 + r_lo < S) lse[stat0 + q0 + r_lo] = lse_lo;
    if (q0 + r_lo + 8 < S) lse[stat0 + q0 + r_lo + 8] = lse_hi;
  }
}

// ----------------------------------------------------------------------------
// Hopper backward: short_bwd_wgmma_kernel, K5 at bf16, Dh 64 and S <= 64
// (the ViT and fed_obd_sq paths), the same function and roundings as
// dq_kernel + dkv_kernel:
//   p = exp(s * scale - lse) in f32, delta = rowsum(dP * p) with that p,
//   dS = bf16(p (dP - delta) scale), dV = bf16(p)^T dO, dQ = dS K,
//   dK = dS^T Q.
//
// What bounds it on the H100: bytes.  At the ViT-small shape (qkv
// [128, 64, 1152], dO [128, 64, 384] bf16, 6 heads) a call reads qkv, dO
// and lse and writes dqkv, 44.2 MB against 2.0 GFLOP: 13.2 us at
// 3.35 TB/s against 2.0 us of tensor-core time.  dq_kernel and dkv_kernel
// widen every element to f32 with 2-byte loads, form the scores and dP
// three times over (dq_kernel's two passes, dkv_kernel's one) on the f32
// FMA units, and hand delta from one launch to the next through device
// memory.
//
// Design: K4's one-pass block (one batch element and two heads, a
// consumer warpgroup each, 256 threads; two blocks an SM, since p and dP
// live together take more than the 80 registers a third block allows, so
// the ViT-small and vit_base calls, 384 blocks each, take 1.5 waves).
// The first warp writes the keys' states and brings Q, K, V and dO of
// both heads by TMA (a fourth tensor map over dO viewed as [B, S, H, 64])
// onto one barrier.  Each warpgroup, in one launch and with no scratch in
// device memory:
//   1. S = Q K^T and dP = dO V^T on wgmma as one group, rows = queries;
//   2. p from the accumulator and the row's lse; delta by quad shuffles;
//      bf16(p) into the head's V tile (spent once dP is done); dS rounded
//      to bf16 into A fragments;
//   3. dQ = dS K on wgmma (K the MN-major B operand, as V in the
//      forward's P.V), then bf16(dS) into the K tile (spent);
//   4. dV = P^T dO, then dK = dS^T Q, on wgmma with both operands
//      MN-major from shared memory: the tiles hold P and dS with queries
//      as rows, and queries are the reduction axis of both products; one
//      accumulator at a time beside dQ's bf16 values;
//   5. dQ and dV staged in the spent dO and V tiles once dV is done, dK
//      in the Q tile, then whole rows out with 16-byte stores into the
//      packed dqkv.
// wgmma reads B (and an MN-major A) across all four warps' rows, so every
// reuse of a tile waits at the warpgroup's named barrier, and tiles
// written by threads are fenced to the async proxy before wgmma reads
// them.  Query rows past S read as TMA's zero fill and get p = 0; keys
// past S score -inf, masked keys -1e30, as in the forward.
constexpr int kBwdTiles = 4;  // Q, K, V, dO
// byte offsets from the 1024-aligned base: tile i (0 Q, 1 K, 2 V, 3 dO) of
// the block's head w, then the keys' states, the all-valid flag and the
// barrier
__host__ __device__ constexpr int bwd_tile(int i, int w) { return (i * kSwHeads + w) * kSwTile; }
constexpr int kBwdCodes = kBwdTiles * kSwHeads * kSwTile;
constexpr int kBwdFlag = kBwdCodes + kTile;
constexpr int kBwdBar = kBwdFlag + 8;
constexpr size_t kBwdSmemBytes = kBwdBar + sizeof(uint64_t) + 1024;

__global__ void __launch_bounds__(sw_threads(1), 2)
    short_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ mask, const float* __restrict__ lse,
                           __nv_bfloat16* __restrict__ dqkv, int S, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                         ~uintptr_t(1023));
  uint8_t* codes = base + kBwdCodes;
  int* flag = reinterpret_cast<int*>(base + kBwdFlag);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kBwdBar);
  const int h0 = blockIdx.y * kSwHeads, b = blockIdx.z;
  const int heads = min(kSwHeads, H - h0);  // 1 in the last block of an odd H
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    hopper::mbar_init(full, 32);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // the first warp fills the block's one stage
    const int lane = threadIdx.x;
    const bool all = sw_key_codes(codes, mask ? mask + static_cast<int64_t>(b) * S : nullptr, 0, S, lane);
    if (lane == 0) {
      *flag = all;
      hopper::mbar_arrive_expect_tx(full, heads * kBwdTiles * kSwTile);
      for (int w = 0; w < heads; ++w) {
        hopper::tma_load_4d(base + bwd_tile(0, w), &tm_q, full, 0, h0 + w, 0, b);
        hopper::tma_load_4d(base + bwd_tile(1, w), &tm_k, full, 0, h0 + w, 0, b);
        hopper::tma_load_4d(base + bwd_tile(2, w), &tm_v, full, 0, h0 + w, 0, b);
        hopper::tma_load_4d(base + bwd_tile(3, w), &tm_do, full, 0, h0 + w, 0, b);
      }
    } else {
      hopper::mbar_arrive(full);
    }
  }
  if (wg >= heads) return;

  // warpgroup wg takes head h0 + wg; this thread's rows r_lo and r_lo + 8
  const int h = h0 + wg, tid = threadIdx.x % 128, t = tid % 4;
  const int r_lo = tid / 32 * 16 + tid % 32 / 4;
  unsigned char* Qs = base + bwd_tile(0, wg);
  unsigned char* Ks = base + bwd_tile(1, wg);
  unsigned char* Vs = base + bwd_tile(2, wg);
  unsigned char* dOs = base + bwd_tile(3, wg);
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * S;
  // a row past S takes lse = +inf, so its p = exp(s - lse) is 0
  const float lse_lo = r_lo < S ? lse[stat0 + r_lo] : INFINITY;
  const float lse_hi = r_lo + 8 < S ? lse[stat0 + r_lo + 8] : INFINITY;
  float s[32], dp[32], acc[32];
  uint32_t da[4][4];
  hopper::mbar_wait(full, 0);

  // 1. S = Q K^T and dP = dO V^T, one group
  {
    const uint64_t q_a = hopper::desc_k_major<kSwRow>(Qs), k_b = hopper::desc_k_major<kSwRow>(Ks);
    const uint64_t do_a = hopper::desc_k_major<kSwRow>(dOs), v_b = hopper::desc_k_major<kSwRow>(Vs);
    hopper::wgmma_fence();
    hopper::wgmma_ss_init(s, q_a, k_b);
#pragma unroll
    for (int ks = 1; ks < 4; ++ks) hopper::wgmma_ss_acc(s, hopper::desc_add(q_a, 32 * ks), hopper::desc_add(k_b, 32 * ks));
    hopper::wgmma_ss_init(dp, do_a, v_b);
#pragma unroll
    for (int ks = 1; ks < 4; ++ks) hopper::wgmma_ss_acc(dp, hopper::desc_add(do_a, 32 * ks), hopper::desc_add(v_b, 32 * ks));
    hopper::wgmma_commit();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
  hopper::fence_regs(dp);

  // 2. p = exp(s - lse), delta = rowsum(dP p)
  sw_mask(s, codes, *flag != 0, scale, t);
  float d_lo = 0.f, d_hi = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float& p_lo = s[4 * j + e];
      float& p_hi = s[4 * j + 2 + e];
      p_lo = expf(p_lo - lse_lo);
      p_hi = expf(p_hi - lse_hi);
      d_lo = fmaf(p_lo, dp[4 * j + e], d_lo);
      d_hi = fmaf(p_hi, dp[4 * j + 2 + e], d_hi);
    }
  d_lo = quad_sum(d_lo);
  d_hi = quad_sum(d_hi);
  wg_sync(wg);  // every warp's dP has read V
  sw_put_acc(Vs, s, r_lo, t);  // bf16(p), queries as rows
  // dS = bf16(p (dP - delta) scale) into the A fragments of dS K
  // (s[4j + 2h + e] is row r_lo + 8h: h = i / 2 % 2)
#pragma unroll
  for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - ((i & 2) ? d_hi : d_lo)) * scale;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) da[k][r] = hopper::pack_bf16x2(dp[8 * k + 2 * r], dp[8 * k + 2 * r + 1]);

  // 3. dQ = dS K, K MN-major; then bf16(dS) into the spent K tile
  // (da[k][r] is row r_lo + 8 (r % 2), columns 16 k + 8 (r / 2) + 2 t)
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  sw_pv(acc, da, Ks);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  hopper::fence_regs(da);
  uint32_t dq[16];  // dQ as bf16 pairs: dq[2j + h] is row r_lo + 8h, columns 8j + 2t, + 1
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) dq[2 * j + hh] = hopper::pack_bf16x2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  wg_sync(wg);  // every warp's dQ has read K
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) sw_put(Ks, r_lo + 8 * (r % 2), 2 * k + r / 2, t, da[k][r]);
  hopper::fence_proxy_async();
  wg_sync(wg);  // P and dS are in place for wgmma

  // 4. dV = P^T dO (A: the P tile, B: dO, both MN-major, 16 queries a step)
  const uint64_t p_a = hopper::desc_mn_major<kSwRow>(Vs), do_b = hopper::desc_mn_major<kSwRow>(dOs);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k)
    hopper::wgmma_ss_mn(acc, hopper::desc_add(p_a, k * 16 * kSwRow), hopper::desc_add(do_b, k * 16 * kSwRow));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  wg_sync(wg);  // every warp's dV has read P and dO
  // dV into the V tile, dQ into the dO tile
  sw_put_acc(Vs, acc, r_lo, t);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) sw_put(dOs, r_lo + 8 * hh, j, t, dq[2 * j + hh]);
  // dK = dS^T Q (A: the dS tile, B: Q, both MN-major)
  const uint64_t ds_a = hopper::desc_mn_major<kSwRow>(Ks), q_b = hopper::desc_mn_major<kSwRow>(Qs);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k)
    hopper::wgmma_ss_mn(acc, hopper::desc_add(ds_a, k * 16 * kSwRow), hopper::desc_add(q_b, k * 16 * kSwRow));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  wg_sync(wg);  // every warp's dK has read dS and Q
  // 5. dK into the Q tile, then the three tiles out as whole rows
  sw_put_acc(Qs, acc, r_lo, t);
  wg_sync(wg);
  const int64_t D = static_cast<int64_t>(H) * 64, ld = 3 * D;
  __nv_bfloat16* row0 = dqkv + static_cast<int64_t>(b) * S * ld + h * 64;
  sw_store_rows(row0, ld, dOs, S, tid);
  sw_store_rows(row0 + D, ld, Qs, S, tid);
  sw_store_rows(row0 + 2 * D, ld, Vs, S, tid);
}

constexpr size_t tile_bytes(int dh) { return sizeof(float) * kTile * (dh + 1); }
constexpr size_t p_bytes() { return sizeof(float) * kTile * kPLd; }
// Dh^-0.5 rounded once from double, as the TPU kernel's `dh**-0.5` is
inline float softmax_scale(int dh) { return static_cast<float>(1.0 / sqrt(double(dh))); }

template <typename T, int DH>
int fwd(const void* qkv, const float* mask, void* out, float* lse, int B, int S, int H,
        cudaStream_t stream) {
  const size_t bytes = 3 * tile_bytes(DH) + p_bytes();
  const cudaError_t err = hopper::allow_smem(reinterpret_cast<const void*>(fwd_kernel<T, DH>), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  fwd_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<T*>(out), lse, S, H, softmax_scale(DH));
  return static_cast<int>(cudaGetLastError());
}

// the Hopper forward (bf16, Dh 64): three tensor maps over the packed
// [B, S, 3, H, 64] view, then one pass (S <= 64) or two
int fwd_wgmma(const void* qkv, const float* mask, void* out, float* lse, int B, int S, int H,
              cudaStream_t stream) {
  if (!hopper::aligned16(qkv) || !hopper::aligned16(out)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const long long row = 3LL * H * 64;
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = hopper::make_map(&maps[i], static_cast<const __nv_bfloat16*>(qkv) + i * H * 64,
                                             hopper::Strides{64, row, row * S}, B, S, H, 64, kTile);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int passes = S <= kTile ? 1 : 2;
  const void* kernel = passes == 1 ? reinterpret_cast<const void*>(short_fwd_wgmma_kernel<1>)
                                   : reinterpret_cast<const void*>(short_fwd_wgmma_kernel<2>);
  const size_t bytes = sw_smem_bytes(passes == 1 ? 1 : kSwStages);
  const cudaError_t err = hopper::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTile - 1) / kTile, (H + kSwHeads - 1) / kSwHeads, B);
  auto* out_bf16 = static_cast<__nv_bfloat16*>(out);
  if (passes == 1)
    short_fwd_wgmma_kernel<1><<<grid, sw_threads(1), bytes, stream>>>(maps[0], maps[1], maps[2], mask, out_bf16, lse,
                                                                   S, H, softmax_scale(64));
  else
    short_fwd_wgmma_kernel<2><<<grid, sw_threads(2), bytes, stream>>>(maps[0], maps[1], maps[2], mask, out_bf16, lse,
                                                                   S, H, softmax_scale(64));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int bwd(const void* qkv, const float* mask, const void* dout, const float* lse, float* delta,
        void* dqkv, int B, int S, int H, cudaStream_t stream) {
  const size_t dq_bytes = 4 * tile_bytes(DH) + p_bytes();
  const size_t dkv_bytes = 4 * tile_bytes(DH) + 2 * p_bytes() + 2 * sizeof(float) * kTile;
  cudaError_t err = hopper::allow_smem(reinterpret_cast<const void*>(dq_kernel<T, DH>), dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = hopper::allow_smem(reinterpret_cast<const void*>(dkv_kernel<T, DH>), dkv_bytes);
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

// the Hopper backward (bf16, Dh 64, S <= 64): four tensor maps, Q, K and V
// over the packed [B, S, 3, H, 64] view and dO over [B, S, H, 64]; no
// delta scratch
int bwd_wgmma(const void* qkv, const float* mask, const void* dout, const float* lse, void* dqkv, int B, int S,
              int H, cudaStream_t stream) {
  if (S > kTile || !hopper::aligned16(qkv) || !hopper::aligned16(dout) || !hopper::aligned16(dqkv))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const long long row = 3LL * H * 64, drow = static_cast<long long>(H) * 64;
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 3 && err == cudaSuccess; ++i)
    err = hopper::make_map(&maps[i], static_cast<const __nv_bfloat16*>(qkv) + i * H * 64,
                           hopper::Strides{64, row, row * S}, B, S, H, 64, kTile);
  if (err == cudaSuccess)
    err = hopper::make_map(&maps[3], dout, hopper::Strides{64, drow, drow * S}, B, S, H, 64, kTile);
  if (err == cudaSuccess) err = hopper::allow_smem(reinterpret_cast<const void*>(short_bwd_wgmma_kernel), kBwdSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(1, (H + kSwHeads - 1) / kSwHeads, B);
  short_bwd_wgmma_kernel<<<grid, sw_threads(1), kBwdSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], mask, lse, static_cast<__nv_bfloat16*>(dqkv), S, H, softmax_scale(64));
  return static_cast<int>(cudaGetLastError());
}

// the routes of the forward and the backward, chosen by the caller from
// dtype, Dh, S and layout (ops/short_attention.py::fwd_route, bwd_route):
// 0 the FMA kernels, 1 the Hopper kernels (bf16 at Dh 64 on 16-byte-aligned
// rows; the backward at S <= 64)
constexpr int kRouteFma = 0, kRouteWgmma = 1;

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; route as above (cudaErrorInvalidValue
// for one the dtype, Dh or layout cannot take).  qkv [B, S, 3*H*Dh]; mask
// [B, S] f32 or null; out [B, S, H*Dh]; lse [B, H, S] f32.
int short_attention_fwd(int dtype, int route, const void* qkv, const float* mask, void* out, float* lse,
                        int B, int S, int H, int Dh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteWgmma)
    return dtype == 1 && Dh == 64 ? fwd_wgmma(qkv, mask, out, lse, B, S, H, s)
                                  : static_cast<int>(cudaErrorInvalidValue);
  if (route != kRouteFma) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && Dh == 64) return fwd<float, 64>(qkv, mask, out, lse, B, S, H, s);
  if (dtype == 0 && Dh == 128) return fwd<float, 128>(qkv, mask, out, lse, B, S, H, s);
  if (dtype == 1 && Dh == 64) return fwd<__nv_bfloat16, 64>(qkv, mask, out, lse, B, S, H, s);
  if (dtype == 1 && Dh == 128) return fwd<__nv_bfloat16, 128>(qkv, mask, out, lse, B, S, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// route as the forward's; dout [B, S, H*Dh]; lse [B, H, S] from the
// forward; delta [B, H, S] f32 scratch of the FMA route (the wgmma route
// takes none); dqkv [B, S, 3*H*Dh] (every element written).
int short_attention_bwd(int dtype, int route, const void* qkv, const float* mask, const void* dout,
                        const float* lse, float* delta, void* dqkv, int B, int S, int H, int Dh,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteWgmma)
    return dtype == 1 && Dh == 64 ? bwd_wgmma(qkv, mask, dout, lse, dqkv, B, S, H, s)
                                  : static_cast<int>(cudaErrorInvalidValue);
  if (route != kRouteFma || delta == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
