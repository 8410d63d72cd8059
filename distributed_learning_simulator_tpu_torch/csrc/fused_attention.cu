// fused_attention: exact long-sequence attention softmax(Q K^T * scale) V over
// [B, T, H, Dh] views (q, k, v may be strided slices of one packed
// [B, T, 3, H, Dh] projection), with a key-padding mask and a causal flag, and
// its backward as two kernels (dq; dk and dv).
//
// Replaces: distributed_learning_simulator_tpu/ops/fused_attention.py
//   K6  _fwd (:168, pallas_call :173, body _fwd_kernel :148)
//   K7  _bwd dq (:271, body _dq_kernel :196)
//   K8  _bwd dkv (:281, body _dkv_kernel :222)
//   K9  _fwd_stream (:425, body _fwd_stream_kernel :307)
//   K10 _bwd_stream dq (:470, body _dq_stream_kernel :349)
//   K11 _bwd_stream dkv (:490, body _dkv_stream_kernel :384)
// The TPU's two tiers (one-level, streaming) compute one function and differ
// only in how much of K/V fits VMEM; a block here never holds more than one
// tile of each operand, so one kernel serves both.
//
// What bounds it on the H100.  At the main path's shape (B = 8, H = 8,
// T = 8192, Dh = 64, bf16) the forward needs 2 products of 2*T*T*Dh flop per
// (batch, head), 1.10e12 flop, against 0.3 GB of operands: bound by
// operations (1.11 ms at 989 TFLOP/s on the tensor cores); dq needs 3
// products, dkv 4.  The forward's max pass makes it compute 3 products, so
// its own ceiling is 1.5 x that bound.  Four routes compute the same
// function; the caller picks one from the layout (ops/fused_attention.py::
// kernel_route) and an entry refuses a route the layout cannot take:
//   * wgmma (route 2): bf16 at Dh 32 or 64 where TMA can describe q, k, v
//     (and dout): 16-byte-aligned bases, nested strides whose byte sizes
//     are multiples of 16.  The long-context and causal-LM main paths.
//     fwd_wgmma_kernel (K6/K9), dkv_wgmma_kernel (K8/K11) and
//     dq_wgmma_kernel (K7/K10), below the mma.sync kernels: products on
//     wgmma from shared-memory descriptors, tiles brought by TMA into a
//     ring of stages with full/empty mbarriers, one producer warp and two
//     consumer warpgroups of 64 rows each, the block owning 128 query rows
//     (forward, dq) or 128 keys (dk/dv);
//   * mma.sync (route 1): bf16 at Dh <= 64 on any other layout (a ragged Dh
//     such as 20, a misaligned stride):
//     fwd_mma_kernel, dq_mma_kernel and dkv_mma_kernel, mma.sync.m16n8k16
//     on 64-row tiles loaded by all threads between barriers;
//   * 3xTF32 (route 3): f32 at Dh 32 or 64 on the layouts of route 2:
//     fwd_tf32x3_kernel (K9/K6), dkv_tf32x3_kernel (K11/K8) and
//     dq_tf32x3_kernel (K10/K7), after the dq wgmma kernel: each f32
//     product as three tf32 products on wgmma, f32 accuracy (their note
//     below);
//   * FMA (route 0): every other f32 call (a ragged Dh, Dh 128, a layout
//     TMA cannot describe) and bf16 at Dh 128 (whose tensor-core
//     accumulators would spill): fwd_kernel, dq_kernel and dkv_kernel on
//     the f32 FMA units (67 TFLOP/s peak) with 4 x 4 register tiles per
//     thread, as K4/K5 do.
//
// Design (not the TPU's), every route:
//   * one block per (row tile, head, batch); the walk over the other axis is
//     a loop inside the block (the TPU carries it across grid steps in VMEM
//     scratch);
//   * columns past the true Dh and rows past T read as 0, so no padded copy
//     of q/k/v exists in memory;
//   * the forward (route 3's aside) makes two passes over the key tiles:
//     the first finds each row's maximum score, the second forms
//     p = exp(s - m) against that global maximum, sums it unrounded into l,
//     rounds p to the input dtype before P.V and divides by l at the end.
//     That is the one-level TPU kernel's arithmetic exactly (the streaming
//     kernel rounds p against a running maximum instead; in f32 the two
//     agree to rounding);
//   * dq walks key tiles for one query tile: p = exp(s - lse),
//     ds = p * (dP - delta) rounded to the input dtype, dq += ds K, times the
//     scale at the end; dk/dv walks query tiles for one key tile:
//     dv += round(p)^T dO, dk += round(ds)^T Q, times the scale at the end;
//     delta = rowsum(dO * O) - dlse comes in from the caller;
//   * masking follows the TPU kernels: a key is valid when it lies inside T,
//     its mask value is not 0 and (causal) it is not after the query; an
//     invalid score is -1e30 in the max and p = 0 exactly, so a row with no
//     valid key gives output 0 and lse = -1e30 + log(1e-30), never NaN;
//   * under `causal`, key tiles wholly after a query tile (and query tiles
//     wholly before a key tile) are skipped.
//
// C interface (ctypes): dtype 0 = float32, 1 = bfloat16; route as above;
// q, k, v share the element strides (sb, st, sh) over batch, token and head,
// with unit stride over Dh; out, dout, dq, dk and dv are contiguous
// [B, T, H, Dh]; mask is f32 [B, T] or null; lse and delta are f32
// [B, H, T].  Every entry returns cudaGetLastError() after its launch (or
// cudaErrorInvalidValue for a route the dtype, Dh or layout cannot take);
// launches are asynchronous on `stream`.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

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

// rows [row0, row0 + 64) x columns [0, DH) of a [rows, Dh] slice whose row
// r starts at base + r * row_stride, into a [64][DH + 1] f32 tile; rows past
// n_rows and columns past dh read as 0
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int64_t row_stride, int row0,
                                          int n_rows, int dh) {
  for (int idx = threadIdx.x; idx < kTile * DH; idx += kThreads) {
    const int r = idx / DH, c = idx % DH, row = row0 + r;
    dst[r * (DH + 1) + c] =
        (row < n_rows && c < dh) ? to_f32<T>(base[static_cast<int64_t>(row) * row_stride + c])
                                 : 0.f;
  }
}

// key validity of one key tile: inside T and mask != 0 (the TPU's test)
__device__ __forceinline__ void load_key_valid(bool* dst, const float* mrow, int k0, int n) {
  if (threadIdx.x < kTile) {
    const int key = k0 + threadIdx.x;
    dst[threadIdx.x] = key < n && (mrow == nullptr || mrow[key] != 0.f);
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

// valid[i][j] for rows q0 + ty + 16 i (queries) and columns k0 + tx + 16 j
// (keys) of a tile whose key validity is kvalid
__device__ __forceinline__ void tile_valid(bool valid[4][4], const bool* kvalid, int q0, int k0,
                                           int ty, int tx, int n, bool causal) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      valid[i][j] = q < n && kvalid[tx + 16 * j] && (!causal || q >= key);
    }
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

struct Layout {
  int64_t sb, st, sh;  // q/k/v element strides over batch, token, head
  int n, heads, dh;    // T, H, true head dim
  float scale;
  bool causal;
  bool vec;  // every row of every operand starts 16-byte aligned and Dh % 8 == 0
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse,
               Layout L) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * (DH + 1);
  float* Vs = Ks + kTile * (DH + 1);
  float* Ps = Vs + kTile * (DH + 1);
  bool* kvalid = reinterpret_cast<bool*>(Ps + kTile * kPLd);
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kTile;
  const int64_t off = b * L.sb + h * L.sh;
  const float* mrow = mask ? mask + static_cast<int64_t>(b) * L.n : nullptr;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ntiles = (L.n + kTile - 1) / kTile;
  const int nk = L.causal ? min(ntiles, static_cast<int>(blockIdx.x) + 1) : ntiles;

  load_tile<T, DH>(Qs, q + off, L.st, q0, L.n, L.dh);
  // pass 1: each row's maximum score (invalid scores count as -1e30)
  float m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kMasked;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile<T, DH>(Ks, k + off, L.st, kt * kTile, L.n, L.dh);
    load_key_valid(kvalid, mrow, kt * kTile, L.n);
    __syncthreads();
    float s[4][4];
    bool valid[4][4];
    tile_dot<DH>(Qs, Ks, s, ty, tx);
    tile_valid(valid, kvalid, q0, kt * kTile, ty, tx, L.n, L.causal);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) m[i] = fmaxf(m[i], valid[i][j] ? s[i][j] * L.scale : kMasked);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = row_max16(m[i]);

  // pass 2: p = exp(s - m), l = sum p, o = round(p) V / l
  float l[4], o[4][DH / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) o[i][j] = 0.f;
  }
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile<T, DH>(Ks, k + off, L.st, kt * kTile, L.n, L.dh);
    load_tile<T, DH>(Vs, v + off, L.st, kt * kTile, L.n, L.dh);
    load_key_valid(kvalid, mrow, kt * kTile, L.n);
    __syncthreads();
    float s[4][4];
    bool valid[4][4];
    tile_dot<DH>(Qs, Ks, s, ty, tx);
    tile_valid(valid, kvalid, q0, kt * kTile, ty, tx, L.n, L.causal);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[i][j] ? expf(s[i][j] * L.scale - m[i]) : 0.f;
        l[i] += p;
        Ps[(ty + 16 * i) * kPLd + tx + 16 * j] = round_to<T>(p);
      }
    __syncthreads();
    acc_px<DH>(Ps, Vs, o, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = fmaxf(row_sum16(l[i]), 1e-30f);
    const int row = q0 + ty + 16 * i;
    if (row >= L.n) continue;
    if (tx == 0) lse[(static_cast<int64_t>(b) * L.heads + h) * L.n + row] = m[i] + logf(denom);
    T* dst = out + ((static_cast<int64_t>(b) * L.n + row) * L.heads + h) * L.dh;
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      const int c = tx + 16 * j;
      if (c < L.dh) dst[c] = from_f32<T>(o[i][j] / denom);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ mask, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, Layout L) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * (DH + 1);
  float* Ks = dOs + kTile * (DH + 1);
  float* Vs = Ks + kTile * (DH + 1);
  float* dSs = Vs + kTile * (DH + 1);
  bool* kvalid = reinterpret_cast<bool*>(dSs + kTile * kPLd);
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kTile;
  const int64_t off = b * L.sb + h * L.sh;
  const int64_t row_ld = static_cast<int64_t>(L.heads) * L.dh;  // contiguous [B, T, H, Dh]
  const int64_t doff = static_cast<int64_t>(b) * L.n * row_ld + static_cast<int64_t>(h) * L.dh;
  const float* mrow = mask ? mask + static_cast<int64_t>(b) * L.n : nullptr;
  const int64_t stat0 = (static_cast<int64_t>(b) * L.heads + h) * L.n;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ntiles = (L.n + kTile - 1) / kTile;
  const int nk = L.causal ? min(ntiles, static_cast<int>(blockIdx.x) + 1) : ntiles;

  load_tile<T, DH>(Qs, q + off, L.st, q0, L.n, L.dh);
  load_tile<T, DH>(dOs, dout + doff, row_ld, q0, L.n, L.dh);
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < L.n ? lse[stat0 + row] : 0.f;
    row_delta[i] = row < L.n ? delta[stat0 + row] : 0.f;
  }
  float acc[4][DH / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile<T, DH>(Ks, k + off, L.st, kt * kTile, L.n, L.dh);
    load_tile<T, DH>(Vs, v + off, L.st, kt * kTile, L.n, L.dh);
    load_key_valid(kvalid, mrow, kt * kTile, L.n);
    __syncthreads();
    float s[4][4], dp[4][4];
    bool valid[4][4];
    tile_dot<DH>(Qs, Ks, s, ty, tx);
    tile_dot<DH>(dOs, Vs, dp, ty, tx);
    tile_valid(valid, kvalid, q0, kt * kTile, ty, tx, L.n, L.causal);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[i][j] ? expf(s[i][j] * L.scale - row_lse[i]) : 0.f;
        dSs[(ty + 16 * i) * kPLd + tx + 16 * j] = round_to<T>(p * (dp[i][j] - row_delta[i]));
      }
    __syncthreads();
    acc_px<DH>(dSs, Ks, acc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= L.n) continue;
    T* dst = dq + doff + static_cast<int64_t>(row) * row_ld;
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      const int c = tx + 16 * j;
      if (c < L.dh) dst[c] = from_f32<T>(acc[i][j] * L.scale);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ mask, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, Layout L) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * (DH + 1);
  float* Qs = Vs + kTile * (DH + 1);
  float* dOs = Qs + kTile * (DH + 1);
  float* Ps = dOs + kTile * (DH + 1);
  float* dSs = Ps + kTile * kPLd;
  float* lse_s = dSs + kTile * kPLd;
  float* delta_s = lse_s + kTile;
  bool* kvalid = reinterpret_cast<bool*>(delta_s + kTile);
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kTile;
  const int64_t off = b * L.sb + h * L.sh;
  const int64_t row_ld = static_cast<int64_t>(L.heads) * L.dh;
  const int64_t doff = static_cast<int64_t>(b) * L.n * row_ld + static_cast<int64_t>(h) * L.dh;
  const float* mrow = mask ? mask + static_cast<int64_t>(b) * L.n : nullptr;
  const int64_t stat0 = (static_cast<int64_t>(b) * L.heads + h) * L.n;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ntiles = (L.n + kTile - 1) / kTile;
  // under causal, query tiles wholly before this key tile see none of it
  const int qt0 = L.causal ? static_cast<int>(blockIdx.x) : 0;

  load_tile<T, DH>(Ks, k + off, L.st, k0, L.n, L.dh);
  load_tile<T, DH>(Vs, v + off, L.st, k0, L.n, L.dh);
  load_key_valid(kvalid, mrow, k0, L.n);
  float acc_k[4][DH / 16], acc_v[4][DH / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) { acc_k[i][j] = 0.f; acc_v[i][j] = 0.f; }
  for (int qt = qt0; qt < ntiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, DH>(Qs, q + off, L.st, q0, L.n, L.dh);
    load_tile<T, DH>(dOs, dout + doff, row_ld, q0, L.n, L.dh);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < L.n ? lse[stat0 + row] : 0.f;
      delta_s[threadIdx.x] = row < L.n ? delta[stat0 + row] : 0.f;
    }
    __syncthreads();
    // rows are queries q0 + ty + 16 i, columns this block's keys k0 + tx + 16 j;
    // under causal the roles of the tile's axes swap against the forward's
    float s[4][4], dp[4][4];
    bool valid[4][4];
    tile_dot<DH>(Qs, Ks, s, ty, tx);
    tile_dot<DH>(dOs, Vs, dp, ty, tx);
    tile_valid(valid, kvalid, q0, k0, ty, tx, L.n, L.causal);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[i][j] ? expf(s[i][j] * L.scale - lse_s[r]) : 0.f;
        Ps[r * kPLd + tx + 16 * j] = round_to<T>(p);
        dSs[r * kPLd + tx + 16 * j] = round_to<T>(p * (dp[i][j] - delta_s[r]));
      }
    }
    __syncthreads();
    acc_ptx<DH>(Ps, dOs, acc_v, ty, tx);
    acc_ptx<DH>(dSs, Qs, acc_k, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= L.n) continue;
    const int64_t row = doff + static_cast<int64_t>(key) * row_ld;
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      const int c = tx + 16 * j;
      if (c >= L.dh) continue;
      dk[row + c] = from_f32<T>(acc_k[i][j] * L.scale);
      dv[row + c] = from_f32<T>(acc_v[i][j]);
    }
  }
}

// ----------------------------------------------------------------------------
// mma.sync path: bf16 at Dh <= 64 off the wgmma route.  The same three
// functions with the same roundings, the products on mma.sync.m16n8k16
// (bf16 in, f32 accumulate: bf16 products are exact in f32, so only the
// summation order differs from the FMA kernels).  One block of 4 warps per
// 64-row tile; each warp owns 16 rows.  Operands sit in shared memory as
// bf16, row-major ([row][DH + 8]) and, where a product needs the other
// orientation as its B operand, transposed ([DH][64 + 8]); the pads keep
// the 32-bit fragment loads free of bank conflicts.  Scores come back as
// mma accumulator fragments, which FlashAttention-2's register trick turns
// into the A fragments of the next product (P.V, dS.K, P^T.dO, dS^T.Q)
// without a trip through shared memory.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4; a 32-bit
// register holds two bf16, the lower index in the low half):
//   A (16 x 16): a0 = A[g][2t..], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B (16 x 8):  b0 = B[2t..][g], b1 = B[2t+8..][g]
//   C (16 x 8):  c0, c1 = C[g][2t], C[g][2t+1]; c2, c3 = C[g+8][2t], C[g+8][2t+1]

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t word(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + 64) of a [rows, Dh] slice into `rows` ([64][DH + 8]);
// rows past n and columns past dh read as 0.  With `vec`, 16-byte loads
// and stores of 8 values (Dh % 8 == 0, so a chunk is whole or absent).
template <int DH>
__device__ __forceinline__ void load_bf16_tile(bf16* rows, const bf16* base, int64_t row_stride,
                                               int row0, int n, int dh, bool vec) {
  if (vec) {
    for (int idx = threadIdx.x; idx < kTile * DH / 8; idx += kMmaThreads) {
      const int r = idx / (DH / 8), c = idx % (DH / 8) * 8, row = row0 + r;
      uint4 chunk = make_uint4(0u, 0u, 0u, 0u);
      if (row < n && c < dh)
        chunk = *reinterpret_cast<const uint4*>(base + static_cast<int64_t>(row) * row_stride + c);
      *reinterpret_cast<uint4*>(rows + r * (DH + 8) + c) = chunk;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kTile * DH; idx += kMmaThreads) {
    const int r = idx / DH, c = idx % DH, row = row0 + r;
    rows[r * (DH + 8) + c] = (row < n && c < dh)
                                 ? base[static_cast<int64_t>(row) * row_stride + c]
                                 : __float2bfloat16(0.f);
  }
}

// the A fragments of this warp's 16 rows of a [64][DH + 8] tile
template <int DH>
__device__ __forceinline__ void load_a_frags(uint32_t a[DH / 16][4], const bf16* tile, int r0,
                                             int g, int t) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    const bf16* p = tile + (r0 + g) * (DH + 8) + ks * 16 + 2 * t;
    a[ks][0] = word(p);
    a[ks][1] = word(p + 8 * (DH + 8));
    a[ks][2] = word(p + 8);
    a[ks][3] = word(p + 8 * (DH + 8) + 8);
  }
}

// s[nb] = A . B^T over the 64 rows of `tile` ([64][DH + 8]), 8 n-blocks
template <int DH>
__device__ __forceinline__ void mma_rows(float s[8][4], const uint32_t a[DH / 16][4],
                                         const bf16* tile, int g, int t) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      const bf16* p = tile + (nb * 8 + g) * (DH + 8) + ks * 16 + 2 * t;
      mma_bf16(s[nb], a[ks], word(p), word(p + 8));
    }
  }
}

// four 8 x 8 bf16 matrices of shared memory, transposed on the way in:
// lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// acc[ob] += P . X over the 64 rows of X ([64][DH + 8], row-major), where
// P's A fragments come from the accumulator fragments p[8][4] (rounded to
// bf16).  X is the B operand with k along its rows, so its fragments come
// from ldmatrix.trans: matrices 0/1 are rows k0..k0+7 / k0+8..k0+15 of
// columns n0..n0+7 (b0, b1 of n-block n0), matrices 2/3 the same rows of
// columns n0+8..n0+15.
template <int DH>
__device__ __forceinline__ void mma_acc(float acc[DH / 8][4], const float p[8][4],
                                        const bf16* X, int lane) {
  const int mi = lane / 8, r = lane % 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                           pack_bf16(p[2 * j][2], p[2 * j][3]),
                           pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int ob2 = 0; ob2 < DH / 16; ++ob2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, X + (j * 16 + r + (mi & 1) * 8) * (DH + 8) + ob2 * 16 + (mi >> 1) * 8);
      mma_bf16(acc[2 * ob2], a, b[0], b[1]);
      mma_bf16(acc[2 * ob2 + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
    fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ mask,
                   bf16* __restrict__ out, float* __restrict__ lse, Layout L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kTile * (DH + 8);
  bf16* Vs = Ks + kTile * (DH + 8);
  bool* kvalid = reinterpret_cast<bool*>(Vs + kTile * (DH + 8));
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kTile;
  const int64_t off = b * L.sb + h * L.sh;
  const float* mrow = mask ? mask + static_cast<int64_t>(b) * L.n : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp, row_lo = q0 + r0 + g, row_hi = row_lo + 8;
  const int ntiles = (L.n + kTile - 1) / kTile;
  const int nk = L.causal ? min(ntiles, static_cast<int>(blockIdx.x) + 1) : ntiles;

  load_bf16_tile<DH>(Qs, q + off, L.st, q0, L.n, L.dh, L.vec);
  __syncthreads();
  uint32_t qa[DH / 16][4];
  load_a_frags<DH>(qa, Qs, r0, g, t);

  // pass 1: each row's maximum score (invalid scores count as -1e30)
  float m_lo = kMasked, m_hi = kMasked;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_bf16_tile<DH>(Ks, k + off, L.st, kt * kTile, L.n, L.dh, L.vec);
    load_key_valid(kvalid, mrow, kt * kTile, L.n);
    __syncthreads();
    float s[8][4];
    mma_rows<DH>(s, qa, Ks, g, t);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kl = nb * 8 + 2 * t + j, key = kt * kTile + kl;
        const bool kv = kvalid[kl];
        if (kv && row_lo < L.n && (!L.causal || row_lo >= key)) m_lo = fmaxf(m_lo, s[nb][j] * L.scale);
        if (kv && row_hi < L.n && (!L.causal || row_hi >= key)) m_hi = fmaxf(m_hi, s[nb][2 + j] * L.scale);
      }
  }
  m_lo = quad_max(m_lo);
  m_hi = quad_max(m_hi);

  // pass 2: p = exp(s - m), l = sum p, o = round(p) V / l
  float l_lo = 0.f, l_hi = 0.f, o[DH / 8][4];
#pragma unroll
  for (int ob = 0; ob < DH / 8; ++ob) o[ob][0] = o[ob][1] = o[ob][2] = o[ob][3] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_bf16_tile<DH>(Ks, k + off, L.st, kt * kTile, L.n, L.dh, L.vec);
    load_bf16_tile<DH>(Vs, v + off, L.st, kt * kTile, L.n, L.dh, L.vec);
    load_key_valid(kvalid, mrow, kt * kTile, L.n);
    __syncthreads();
    float s[8][4];
    mma_rows<DH>(s, qa, Ks, g, t);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kl = nb * 8 + 2 * t + j, key = kt * kTile + kl;
        const bool kv = kvalid[kl];
        const bool v_lo = kv && row_lo < L.n && (!L.causal || row_lo >= key);
        const bool v_hi = kv && row_hi < L.n && (!L.causal || row_hi >= key);
        s[nb][j] = v_lo ? expf(s[nb][j] * L.scale - m_lo) : 0.f;
        s[nb][2 + j] = v_hi ? expf(s[nb][2 + j] * L.scale - m_hi) : 0.f;
        l_lo += s[nb][j];
        l_hi += s[nb][2 + j];
      }
    mma_acc<DH>(o, s, Vs, lane);
  }
  const float d_lo = fmaxf(quad_sum(l_lo), 1e-30f), d_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  const int64_t row_ld = static_cast<int64_t>(L.heads) * L.dh;
  const int64_t base = static_cast<int64_t>(b) * L.n * row_ld + static_cast<int64_t>(h) * L.dh;
  const int64_t stat0 = (static_cast<int64_t>(b) * L.heads + h) * L.n;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_hi : row_lo;
    const float denom = half ? d_hi : d_lo;
    if (row >= L.n) continue;
    if (t == 0) lse[stat0 + row] = (half ? m_hi : m_lo) + logf(denom);
    bf16* dst = out + base + static_cast<int64_t>(row) * row_ld;
#pragma unroll
    for (int ob = 0; ob < DH / 8; ++ob)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = ob * 8 + 2 * t + j;
        if (c < L.dh) dst[c] = __float2bfloat16(o[ob][2 * half + j] / denom);
      }
  }
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
    dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ mask,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq, Layout L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTile * (DH + 8);
  bf16* Ks = dOs + kTile * (DH + 8);
  bf16* Vs = Ks + kTile * (DH + 8);
  bool* kvalid = reinterpret_cast<bool*>(Vs + kTile * (DH + 8));
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kTile;
  const int64_t off = b * L.sb + h * L.sh;
  const int64_t row_ld = static_cast<int64_t>(L.heads) * L.dh;
  const int64_t doff = static_cast<int64_t>(b) * L.n * row_ld + static_cast<int64_t>(h) * L.dh;
  const float* mrow = mask ? mask + static_cast<int64_t>(b) * L.n : nullptr;
  const int64_t stat0 = (static_cast<int64_t>(b) * L.heads + h) * L.n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp, row_lo = q0 + r0 + g, row_hi = row_lo + 8;
  const int ntiles = (L.n + kTile - 1) / kTile;
  const int nk = L.causal ? min(ntiles, static_cast<int>(blockIdx.x) + 1) : ntiles;

  load_bf16_tile<DH>(Qs, q + off, L.st, q0, L.n, L.dh, L.vec);
  load_bf16_tile<DH>(dOs, dout + doff, row_ld, q0, L.n, L.dh, L.vec);
  __syncthreads();
  uint32_t qa[DH / 16][4], da[DH / 16][4];
  load_a_frags<DH>(qa, Qs, r0, g, t);
  load_a_frags<DH>(da, dOs, r0, g, t);
  const float lse_lo = row_lo < L.n ? lse[stat0 + row_lo] : 0.f;
  const float lse_hi = row_hi < L.n ? lse[stat0 + row_hi] : 0.f;
  const float dl_lo = row_lo < L.n ? delta[stat0 + row_lo] : 0.f;
  const float dl_hi = row_hi < L.n ? delta[stat0 + row_hi] : 0.f;
  float acc[DH / 8][4];
#pragma unroll
  for (int ob = 0; ob < DH / 8; ++ob) acc[ob][0] = acc[ob][1] = acc[ob][2] = acc[ob][3] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_bf16_tile<DH>(Ks, k + off, L.st, kt * kTile, L.n, L.dh, L.vec);
    load_bf16_tile<DH>(Vs, v + off, L.st, kt * kTile, L.n, L.dh, L.vec);
    load_key_valid(kvalid, mrow, kt * kTile, L.n);
    __syncthreads();
    float s[8][4], dp[8][4];
    mma_rows<DH>(s, qa, Ks, g, t);
    mma_rows<DH>(dp, da, Vs, g, t);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kl = nb * 8 + 2 * t + j, key = kt * kTile + kl;
        const bool kv = kvalid[kl];
        const bool v_lo = kv && row_lo < L.n && (!L.causal || row_lo >= key);
        const bool v_hi = kv && row_hi < L.n && (!L.causal || row_hi >= key);
        const float p_lo = v_lo ? expf(s[nb][j] * L.scale - lse_lo) : 0.f;
        const float p_hi = v_hi ? expf(s[nb][2 + j] * L.scale - lse_hi) : 0.f;
        s[nb][j] = p_lo * (dp[nb][j] - dl_lo);
        s[nb][2 + j] = p_hi * (dp[nb][2 + j] - dl_hi);
      }
    mma_acc<DH>(acc, s, Ks, lane);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_hi : row_lo;
    if (row >= L.n) continue;
    bf16* dst = dq + doff + static_cast<int64_t>(row) * row_ld;
#pragma unroll
    for (int ob = 0; ob < DH / 8; ++ob)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = ob * 8 + 2 * t + j;
        if (c < L.dh) dst[c] = __float2bfloat16(acc[ob][2 * half + j] * L.scale);
      }
  }
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
    dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ mask,
                   const bf16* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, Layout L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTile * (DH + 8);
  bf16* Qs = Vs + kTile * (DH + 8);
  bf16* dOs = Qs + kTile * (DH + 8);
  float* lse_s = reinterpret_cast<float*>(dOs + kTile * (DH + 8));
  float* delta_s = lse_s + kTile;
  bool* kvalid = reinterpret_cast<bool*>(delta_s + kTile);
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kTile;
  const int64_t off = b * L.sb + h * L.sh;
  const int64_t row_ld = static_cast<int64_t>(L.heads) * L.dh;
  const int64_t doff = static_cast<int64_t>(b) * L.n * row_ld + static_cast<int64_t>(h) * L.dh;
  const float* mrow = mask ? mask + static_cast<int64_t>(b) * L.n : nullptr;
  const int64_t stat0 = (static_cast<int64_t>(b) * L.heads + h) * L.n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp;  // this warp's keys: k0 + r0 + g and + 8
  const int key_lo = k0 + r0 + g, key_hi = key_lo + 8;
  const int ntiles = (L.n + kTile - 1) / kTile;
  const int qt0 = L.causal ? static_cast<int>(blockIdx.x) : 0;

  load_bf16_tile<DH>(Ks, k + off, L.st, k0, L.n, L.dh, L.vec);
  load_bf16_tile<DH>(Vs, v + off, L.st, k0, L.n, L.dh, L.vec);
  load_key_valid(kvalid, mrow, k0, L.n);
  __syncthreads();
  uint32_t ka[DH / 16][4], va[DH / 16][4];
  load_a_frags<DH>(ka, Ks, r0, g, t);
  load_a_frags<DH>(va, Vs, r0, g, t);
  const bool kv_lo = kvalid[r0 + g], kv_hi = kvalid[r0 + g + 8];
  float acc_k[DH / 8][4], acc_v[DH / 8][4];
#pragma unroll
  for (int ob = 0; ob < DH / 8; ++ob)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[ob][i] = acc_v[ob][i] = 0.f;
  for (int qt = qt0; qt < ntiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_bf16_tile<DH>(Qs, q + off, L.st, q0, L.n, L.dh, L.vec);
    load_bf16_tile<DH>(dOs, dout + doff, row_ld, q0, L.n, L.dh, L.vec);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < L.n ? lse[stat0 + row] : 0.f;
      delta_s[threadIdx.x] = row < L.n ? delta[stat0 + row] : 0.f;
    }
    __syncthreads();
    // rows are this warp's keys, columns the tile's queries: the roles of
    // the forward's axes swap, causal included (valid when query >= key)
    float s[8][4], dp[8][4];
    mma_rows<DH>(s, ka, Qs, g, t);
    mma_rows<DH>(dp, va, dOs, g, t);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ql = nb * 8 + 2 * t + j, query = q0 + ql;
        const bool qin = query < L.n;
        const bool v_lo = kv_lo && qin && (!L.causal || query >= key_lo);
        const bool v_hi = kv_hi && qin && (!L.causal || query >= key_hi);
        const float p_lo = v_lo ? expf(s[nb][j] * L.scale - lse_s[ql]) : 0.f;
        const float p_hi = v_hi ? expf(s[nb][2 + j] * L.scale - lse_s[ql]) : 0.f;
        s[nb][j] = p_lo;
        s[nb][2 + j] = p_hi;
        dp[nb][j] = p_lo * (dp[nb][j] - delta_s[ql]);
        dp[nb][2 + j] = p_hi * (dp[nb][2 + j] - delta_s[ql]);
      }
    mma_acc<DH>(acc_v, s, dOs, lane);
    mma_acc<DH>(acc_k, dp, Qs, lane);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key_hi : key_lo;
    if (key >= L.n) continue;
    const int64_t row = doff + static_cast<int64_t>(key) * row_ld;
#pragma unroll
    for (int ob = 0; ob < DH / 8; ++ob)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = ob * 8 + 2 * t + j;
        if (c >= L.dh) continue;
        dk[row + c] = __float2bfloat16(acc_k[ob][2 * half + j] * L.scale);
        dv[row + c] = __float2bfloat16(acc_v[ob][2 * half + j]);
      }
  }
}

// ----------------------------------------------------------------------------
// Hopper path: bf16 at Dh 32 and 64 on layouts TMA can describe (the long-
// context and causal-LM main paths), for the forward (K6/K9), dk/dv
// (K8/K11) and dq (K7/K10, after dk/dv).  The same functions and
// roundings as the mma.sync kernels above; the products run on wgmma
// (bf16 in, f32 accumulate), the tiles arrive by TMA into a ring of
// shared-memory stages guarded by full/empty mbarriers, and the block
// (384 threads, one a SM) is warp-specialised:
//   * warpgroups 0 and 1 consume: each owns 64 rows of the block's 128
//     (query rows in the forward and dq, keys in dk/dv) and keeps its
//     accumulators in registers;
//   * the first warp of warpgroup 2 produces: lane 0 issues the TMA
//     loads, all 32 lanes write the per-tile side data (key validity; in
//     dk/dv also lse, delta and an all-valid flag) with plain stores and
//     arrive on the stage's full barrier (count 32, plus the TMA bytes),
//     so the data reaches the consumers with the tile.
// Scores come back as wgmma accumulators and turn into the bf16 A operand
// of the next product in registers (hopper.cuh), never through shared
// memory.  In dk/dv and dq a tile whose scores are all valid (every key
// valid, every query inside T, no causal cut) skips the per-element
// masking.
// Rows past T and Dh columns past the tile read as TMA's zero fill.
//
// What bounds them: all are bound by operations (the forward's 3
// products, dq's 3, dk/dv's 4).  The exp of every score (MUFU, 16 a clock
// an SM) costs about as much as the tensor-core time of the products
// around it at Dh 64, so the forward's second pass is bound by both
// together, and the kernels reach the bound only where one warpgroup's
// exp runs while the other's products do.  dk/dv and dq issue the next
// stage's products behind this stage's (below); the forward waits for each tile's scores, and its
// two warpgroups fill each other's gaps only as the scheduler happens to
// interleave them (a paced ping-pong between them is a later step).

using hopper::aligned16;
using hopper::allow_smem;
using hopper::desc_add;
using hopper::make_map;
using hopper::make_map_f32;
using hopper::Strides;

constexpr int kWgConsumers = 2;
// two consumer warpgroups and a producer warpgroup, of which one warp
// works; setmaxnreg moves registers from the producer (40 a thread) to the
// consumers (232), within the SM's 65,536
constexpr int kWgThreads = 128 * (kWgConsumers + 1);
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kWgBlock = 128;    // query rows (forward) or keys (dk/dv) a block owns
constexpr int kFwdKeys = 128;    // keys a forward stage carries
constexpr int kDkvQueries = 64;  // queries a dk/dv stage carries
constexpr int kFwdStages = 3;
constexpr int kDkvStages = 4;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// 4 keys a lane of one 128-key tile: inside T and mask != 0; returns
// (to the whole warp) whether every key of the tile is valid
__device__ __forceinline__ bool write_key_valid(uint8_t* dst, const float* mrow, int k0, int n, int lane) {
  uint32_t word = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int key = k0 + 4 * lane + e;
    const bool valid = key < n && (mrow == nullptr || mrow[key] != 0.f);
    word |= static_cast<uint32_t>(valid) << (8 * e);
  }
  reinterpret_cast<uint32_t*>(dst)[lane] = word;
  return __all_sync(0xffffffffu, word == 0x01010101u);
}

template <int DH>
struct FwdSmem {
  static constexpr int kRowBytes = 2 * DH;
  static constexpr int kTile = kFwdKeys * kRowBytes;  // a K or V tile; Q is 128 rows too
  static constexpr int kStage = 2 * kTile;
  static constexpr int kValid = kTile + kFwdStages * kStage;  // a byte a key, per stage
  static constexpr int kBars = kValid + kFwdStages * kFwdKeys;
  static constexpr size_t kBytes = kBars + (2 * kFwdStages + 1) * sizeof(uint64_t) + 1024;
};

// The forward's consumer warpgroup takes one stage's 128 keys at a time:
// scores as one m64n128 product (64 registers a thread), then, in pass 2,
// P.V; it waits for each product, and the two warpgroups fill each
// other's waits.

// issue S = Q . K^T over one stage's 128 keys as one group; `q_rows`: the
// shared address of this warpgroup's 64 Q rows
template <int DH>
__device__ __forceinline__ void fwd_issue_scores(float (&s)[64], uint32_t q_rows, const unsigned char* Ks) {
  constexpr uint32_t RB = 2 * DH;
  const uint64_t dq = hopper::make_desc(q_rows, 16, 8 * RB, hopper::swizzle_code(RB));
  const uint64_t dk = hopper::desc_k_major<RB>(Ks);
  hopper::wgmma_fence();
  hopper::wgmma_ss_init(s, dq, dk);
#pragma unroll
  for (int ks = 1; ks < DH / 16; ++ks) hopper::wgmma_ss_acc(s, desc_add(dq, 32 * ks), desc_add(dk, 32 * ks));
  hopper::wgmma_commit();
}

// the validity of score (row, key) of a tile whose key validity is `kv`
// (the kernel's parameters stay in the constant bank, not in registers)
__device__ __forceinline__ bool fwd_valid(const uint8_t* kv, int col, int row, int key, const Layout& L) {
  return kv[col] != 0 && row < L.n && (!L.causal || row >= key);
}

// pass 1: the rows' maxima over one tile's valid scores (`kv` and `key0`:
// the tile's first key; `lo`: this thread's first row, the other 8 below;
// `t`: its quad lane)
__device__ __forceinline__ void fwd_tile_max(const float (&s)[64], float& m_lo, float& m_hi, const uint8_t* kv,
                                             int key0, int lo, int t, const Layout& L) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t + e;
      if (fwd_valid(kv, col, lo, key0 + col, L)) m_lo = fmaxf(m_lo, s[4 * j + e] * L.scale);
      if (fwd_valid(kv, col, lo + 8, key0 + col, L)) m_hi = fmaxf(m_hi, s[4 * j + 2 + e] * L.scale);
    }
}

// pass 2: p = exp(s - m) of one tile in place (0 where masked), summed
// unrounded into l (`ml_*`: m log2 e)
__device__ __forceinline__ void fwd_tile_p(float (&s)[64], float& l_lo, float& l_hi, float ml_lo, float ml_hi,
                                           const uint8_t* kv, int key0, int lo, int t, const Layout& L) {
  const float sl2 = L.scale * kLog2e;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t + e, i = 4 * j + e;
      s[i] = fwd_valid(kv, col, lo, key0 + col, L) ? exp2f(fmaf(s[i], sl2, -ml_lo)) : 0.f;
      s[i + 2] = fwd_valid(kv, col, lo + 8, key0 + col, L) ? exp2f(fmaf(s[i + 2], sl2, -ml_hi)) : 0.f;
      l_lo += s[i];
      l_hi += s[i + 2];
    }
}

// p rounded to bf16 into the A fragments of P.V (hopper.cuh), then
// o += P V issued as one group (`dv`: the descriptor of the tile's V)
template <int DH>
__device__ __forceinline__ void fwd_tile_pv(const float (&p)[64], uint32_t (&pa)[8][4], float (&o)[DH / 2],
                                            uint64_t dv) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[k][r] = hopper::pack_bf16x2(p[8 * k + 2 * r], p[8 * k + 2 * r + 1]);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < 8; ++k) hopper::wgmma_rs(o, pa[k], desc_add(dv, k * 16 * 2 * DH));
  hopper::wgmma_commit();
}

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ mask,
                     bf16* __restrict__ out, float* __restrict__ lse, Layout L) {
  using S = FwdSmem<DH>;
  constexpr int RB = S::kRowBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* Qs = base;
  uint8_t* kvalid = base + S::kValid;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBars);
  uint64_t* empty = full + kFwdStages;
  uint64_t* qbar = empty + kFwdStages;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kWgBlock;
  const int ntiles = (L.n + kFwdKeys - 1) / kFwdKeys;
  const int nk = L.causal ? min(ntiles, static_cast<int>(blockIdx.x) + 1) : ntiles;
  const int wg = threadIdx.x / 128;  // kWgConsumers: the producer
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], 128 * kWgConsumers);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kWgConsumers) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 >= 32) return;
    // producer: Q once, then pass 1's K tiles, then pass 2's K and V tiles
    const int lane = threadIdx.x % 32;
    const float* mrow = mask ? mask + static_cast<int64_t>(b) * L.n : nullptr;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(qbar, S::kTile);
      hopper::tma_load_4d(Qs, &tm_q, qbar, 0, h, q0, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < 2 * nk; ++it) {
      const bool second = it >= nk;
      const int kt = second ? it - nk : it;
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      write_key_valid(kvalid + stage * kFwdKeys, mrow, kt * kFwdKeys, L.n, lane);
      unsigned char* Ks = base + S::kTile + stage * S::kStage;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[stage], (second ? 2 : 1) * S::kTile);
        hopper::tma_load_4d(Ks, &tm_k, &full[stage], 0, h, kt * kFwdKeys, b);
        if (second) hopper::tma_load_4d(Ks + S::kTile, &tm_v, &full[stage], 0, h, kt * kFwdKeys, b);
      } else {
        hopper::mbar_arrive(&full[stage]);
      }
      if (++stage == kFwdStages) { stage = 0; phase ^= 1; }
    }
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegs>();
  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63, walking the
  // stream of 2 nk stages (pass 1's nk K tiles, then pass 2's K and V)
  const int tid = threadIdx.x % 128, t = tid % 4;
  const int row0 = q0 + 64 * wg, lo = row0 + tid / 32 * 16 + tid % 32 / 4;  // and lo + 8
  const uint32_t q_rows = hopper::smem_addr(Qs + 64 * wg * RB);
  int stage = 0;
  uint32_t phase = 0;
  float s[64];
  hopper::mbar_wait(qbar, 0);

  // pass 1: each row's maximum score (invalid scores count as -1e30)
  float m_lo = kMasked, m_hi = kMasked;
  for (int kt = 0; kt < nk; ++kt) {
    hopper::mbar_wait(&full[stage], phase);
    fwd_issue_scores<DH>(s, q_rows, base + S::kTile + stage * S::kStage);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    fwd_tile_max(s, m_lo, m_hi, kvalid + stage * kFwdKeys, kt * kFwdKeys, lo, t, L);
    hopper::mbar_arrive(&empty[stage]);
    if (++stage == kFwdStages) { stage = 0; phase ^= 1; }
  }
  m_lo = quad_max(m_lo);
  m_hi = quad_max(m_hi);

  // pass 2: p = exp(s - m), l = sum p (unrounded), o += round(p) V
  float l_lo = 0.f, l_hi = 0.f, o[DH / 2];
  const float ml_lo = m_lo * kLog2e, ml_hi = m_hi * kLog2e;
  uint32_t pa[8][4];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    hopper::mbar_wait(&full[stage], phase);
    const unsigned char* Ks = base + S::kTile + stage * S::kStage;
    fwd_issue_scores<DH>(s, q_rows, Ks);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    fwd_tile_p(s, l_lo, l_hi, ml_lo, ml_hi, kvalid + stage * kFwdKeys, kt * kFwdKeys, lo, t, L);
    fwd_tile_pv<DH>(s, pa, o, hopper::desc_mn_major<RB>(Ks + S::kTile));
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(pa);
    hopper::mbar_arrive(&empty[stage]);
    if (++stage == kFwdStages) { stage = 0; phase ^= 1; }
  }

  const float d_lo = fmaxf(quad_sum(l_lo), 1e-30f), d_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  const int64_t row_ld = static_cast<int64_t>(L.heads) * DH;
  const int64_t obase = static_cast<int64_t>(b) * L.n * row_ld + static_cast<int64_t>(h) * DH;
  const int64_t stat0 = (static_cast<int64_t>(b) * L.heads + h) * L.n;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = lo + 8 * half;
    const float denom = half ? d_hi : d_lo;
    if (row >= L.n) continue;
    if (t == 0) lse[stat0 + row] = (half ? m_hi : m_lo) + logf(denom);
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + obase + static_cast<int64_t>(row) * row_ld);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      dst[4 * j + t] = hopper::pack_bf16x2(o[4 * j + 2 * half] / denom, o[4 * j + 2 * half + 1] / denom);
  }
}

template <int DH>
struct DkvSmem {
  static constexpr int kRowBytes = 2 * DH;
  static constexpr int kKV = kWgBlock * kRowBytes;      // the block's K (or V) tile
  static constexpr int kTile = kDkvQueries * kRowBytes; // a Q or dO tile
  static constexpr int kStages0 = 2 * kKV;
  static constexpr int kStats = kStages0 + kDkvStages * 2 * kTile;  // lse, delta per stage
  static constexpr int kValid = kStats + kDkvStages * 2 * kDkvQueries * static_cast<int>(sizeof(float));
  static constexpr int kFull = kValid + kWgBlock;  // every key of the block valid
  static constexpr int kBars = kFull + 8;
  static constexpr size_t kBytes = kBars + (2 * kDkvStages + 1) * sizeof(uint64_t) + 1024;
};

// s^T = K Q^T and dP^T = V dO^T of one stage (K, V: this warpgroup's 64 keys)
template <int DH>
__device__ __forceinline__ void dkv_scores(float (&s)[32], float (&dp)[32], uint64_t dk_a, uint64_t dv_a,
                                           const unsigned char* Qst) {
  constexpr int RB = 2 * DH;
  const uint64_t dq_b = hopper::desc_k_major<RB>(Qst);
  const uint64_t ddo_b = hopper::desc_k_major<RB>(Qst + kDkvQueries * RB);
  hopper::wgmma_fence();
  hopper::wgmma_ss_init(s, dk_a, dq_b);
#pragma unroll
  for (int ks = 1; ks < DH / 16; ++ks) hopper::wgmma_ss_acc(s, desc_add(dk_a, 32 * ks), desc_add(dq_b, 32 * ks));
  hopper::wgmma_ss_init(dp, dv_a, ddo_b);
#pragma unroll
  for (int ks = 1; ks < DH / 16; ++ks) hopper::wgmma_ss_acc(dp, desc_add(dv_a, 32 * ks), desc_add(ddo_b, 32 * ks));
  hopper::wgmma_commit();
}

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ mask, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, Layout L) {
  using S = DkvSmem<DH>;
  constexpr int RB = S::kRowBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* Ks = base;
  unsigned char* Vs = base + S::kKV;
  float* stats = reinterpret_cast<float*>(base + S::kStats);
  uint8_t* kvalid = base + S::kValid;
  uint32_t* keys_full = reinterpret_cast<uint32_t*>(base + S::kFull);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBars);
  uint64_t* empty = full + kDkvStages;
  uint64_t* kvbar = empty + kDkvStages;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kWgBlock;
  const int ntiles = (L.n + kDkvQueries - 1) / kDkvQueries;
  // under causal, query tiles wholly before this block's keys see none of them
  const int qt0 = L.causal ? k0 / kDkvQueries : 0;
  const int wg = threadIdx.x / 128;  // kWgConsumers: the producer
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDkvStages; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], 128 * kWgConsumers);
    }
    hopper::mbar_init(kvbar, 32);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kWgConsumers) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 >= 32) return;
    // producer: K, V and their validity once, then Q, dO, lse, delta per query tile
    const int lane = threadIdx.x % 32;
    const float* mrow = mask ? mask + static_cast<int64_t>(b) * L.n : nullptr;
    const int64_t stat0 = (static_cast<int64_t>(b) * L.heads + h) * L.n;
    const bool all = write_key_valid(kvalid, mrow, k0, L.n, lane);
    if (lane == 0) {
      *keys_full = all;
      hopper::mbar_arrive_expect_tx(kvbar, 2 * S::kKV);
      hopper::tma_load_4d(Ks, &tm_k, kvbar, 0, h, k0, b);
      hopper::tma_load_4d(Vs, &tm_v, kvbar, 0, h, k0, b);
    } else {
      hopper::mbar_arrive(kvbar);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int qt = qt0; qt < ntiles; ++qt) {
      const int q0 = qt * kDkvQueries;
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      float* st = stats + stage * 2 * kDkvQueries;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 2 * lane + e, row = q0 + r;
        st[r] = row < L.n ? lse[stat0 + row] * kLog2e : 0.f;
        st[kDkvQueries + r] = row < L.n ? delta[stat0 + row] : 0.f;
      }
      unsigned char* Qst = base + S::kStages0 + stage * 2 * S::kTile;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[stage], 2 * S::kTile);
        hopper::tma_load_4d(Qst, &tm_q, &full[stage], 0, h, q0, b);
        hopper::tma_load_4d(Qst + S::kTile, &tm_do, &full[stage], 0, h, q0, b);
      } else {
        hopper::mbar_arrive(&full[stage]);
      }
      if (++stage == kDkvStages) { stage = 0; phase ^= 1; }
    }
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegs>();
  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63; rows of every
  // product are keys, columns queries (the forward's axes swapped, causal
  // included: valid when query >= key).  The next stage's S^T and dP^T
  // are issued right behind this stage's dV and dK, so the tensor cores
  // run both groups back to back.
  const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r_lo = 64 * wg + 16 * w + g;
  const int key0 = k0 + 64 * wg, key_lo = k0 + r_lo, key_hi = key_lo + 8;
  const uint64_t dk_a = hopper::desc_k_major<RB>(Ks + 64 * wg * RB);
  const uint64_t dv_a = hopper::desc_k_major<RB>(Vs + 64 * wg * RB);
  const float sl2 = L.scale * kLog2e;
  hopper::mbar_wait(kvbar, 0);
  const bool kv_lo = kvalid[r_lo] != 0, kv_hi = kvalid[r_lo + 8] != 0, keys_in = *keys_full != 0;
  float acc_k[DH / 2], acc_v[DH / 2], s[32], dp[32];
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[k][r] = da[k][r] = 0u;
  int stage = 0, pending = -1;
  uint32_t phase = 0;
  hopper::mbar_wait(&full[0], 0);
  dkv_scores<DH>(s, dp, dk_a, dv_a, base + S::kStages0);
  for (int qt = qt0; qt < ntiles; ++qt) {
    const int q0 = qt * kDkvQueries, st_now = stage;
    const unsigned char* Qst = base + S::kStages0 + st_now * 2 * S::kTile;
    const float* st = stats + st_now * 2 * kDkvQueries;
    hopper::wgmma_wait<0>();  // this stage's S^T and dP^T, the last stage's dV and dK
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::fence_regs(acc_k);
    hopper::fence_regs(acc_v);
    hopper::fence_regs(pa);
    hopper::fence_regs(da);
    if (pending >= 0) hopper::mbar_arrive(&empty[pending]);
    // p = exp(s - lse); ds = p (dP - delta), from the unrounded p; no
    // score is masked when every key is valid, every query inside T and
    // (causal) every query at or after this warpgroup's last key
    const bool fast = keys_in && q0 + kDkvQueries <= L.n && (!L.causal || q0 >= key0 + 63);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = 8 * j + 2 * t + e, query = q0 + ql;
        const float lse_l2 = st[ql], dl = st[kDkvQueries + ql];
        float p_lo = hopper::ex2(fmaf(s[4 * j + e], sl2, -lse_l2));
        float p_hi = hopper::ex2(fmaf(s[4 * j + 2 + e], sl2, -lse_l2));
        if (!fast) {
          const bool qin = query < L.n;
          p_lo = kv_lo && qin && (!L.causal || query >= key_lo) ? p_lo : 0.f;
          p_hi = kv_hi && qin && (!L.causal || query >= key_hi) ? p_hi : 0.f;
        }
        s[4 * j + e] = p_lo;
        s[4 * j + 2 + e] = p_hi;
        dp[4 * j + e] = p_lo * (dp[4 * j + e] - dl);
        dp[4 * j + 2 + e] = p_hi * (dp[4 * j + 2 + e] - dl);
      }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[k][r] = hopper::pack_bf16x2(s[8 * k + 2 * r], s[8 * k + 2 * r + 1]);
        da[k][r] = hopper::pack_bf16x2(dp[8 * k + 2 * r], dp[8 * k + 2 * r + 1]);
      }
    // dV += round(P^T) dO, dK += round(dS^T) Q: dO and Q MN-major
    const uint64_t dq_mn = hopper::desc_mn_major<RB>(Qst), ddo_mn = hopper::desc_mn_major<RB>(Qst + S::kTile);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) hopper::wgmma_rs(acc_v, pa[k], desc_add(ddo_mn, k * 16 * RB));
#pragma unroll
    for (int k = 0; k < 4; ++k) hopper::wgmma_rs(acc_k, da[k], desc_add(dq_mn, k * 16 * RB));
    hopper::wgmma_commit();
    pending = st_now;
    if (++stage == kDkvStages) { stage = 0; phase ^= 1; }
    if (qt + 1 < ntiles) {
      hopper::mbar_wait(&full[stage], phase);
      dkv_scores<DH>(s, dp, dk_a, dv_a, base + S::kStages0 + stage * 2 * S::kTile);
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc_k);
  hopper::fence_regs(acc_v);
  hopper::fence_regs(pa);
  hopper::fence_regs(da);

  const int64_t row_ld = static_cast<int64_t>(L.heads) * DH;
  const int64_t obase = static_cast<int64_t>(b) * L.n * row_ld + static_cast<int64_t>(h) * DH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key_hi : key_lo;
    if (key >= L.n) continue;
    uint32_t* dkr = reinterpret_cast<uint32_t*>(dk + obase + static_cast<int64_t>(key) * row_ld);
    uint32_t* dvr = reinterpret_cast<uint32_t*>(dv + obase + static_cast<int64_t>(key) * row_ld);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      dkr[4 * j + t] =
          hopper::pack_bf16x2(acc_k[4 * j + 2 * half] * L.scale, acc_k[4 * j + 2 * half + 1] * L.scale);
      dvr[4 * j + t] = hopper::pack_bf16x2(acc_v[4 * j + 2 * half], acc_v[4 * j + 2 * half + 1]);
    }
  }
}

// dq (K7/K10) on the Hopper path: dq_wgmma_kernel, dk/dv's kernel with the
// roles of queries and keys swapped.  The block owns 128 query rows, one
// consumer warpgroup a 64-row half; Q and dO arrive once, then K and V
// tiles of 64 keys through a 4-stage ring.  Per key tile a warpgroup
// issues S = Q K^T and dP = dO V^T from K-major descriptors, forms
// p = exp(s * scale - lse) (0 where the pair is invalid) and
// ds = p (dP - delta) in registers, rounds ds to bf16 into A fragments,
// and accumulates dq += dS K with K as the MN-major B operand (the
// forward's P.V with K for V); the next tile's S and dP are issued right
// behind it, so the tensor cores see two groups back to back.  The scale
// comes at the end.
//
// What bounds it: operations (3 products a valid pair).  The producer
// reads each tile's key validity before it loads the tile and passes over
// a tile whose 64 keys are all invalid (masked or past T): every p of it
// is 0, so it adds exactly 0 to dq, and the padded text batches mask a
// third of their keys (on an H100 SXM at 700 W this took dq at the
// long-context shape from 6.37 ms to 3.39 ms: PERF.md).  It ends the walk with a stage whose
// tile index is -1, so the consumers never count tiles themselves.
constexpr int kDqKeys = 64;  // keys a dq stage carries
constexpr int kDqStages = 4;

template <int DH>
struct DqSmem {
  static constexpr int kRowBytes = 2 * DH;
  static constexpr int kQ = kWgBlock * kRowBytes;      // the block's Q (or dO) rows
  static constexpr int kTile = kDqKeys * kRowBytes;    // a K or V tile
  static constexpr int kStages0 = 2 * kQ;
  static constexpr int kInfo = kStages0 + kDqStages * 2 * kTile;  // per stage: tile index, all keys valid
  static constexpr int kValid = kInfo + kDqStages * 2 * static_cast<int>(sizeof(int));
  static constexpr int kBars = kValid + kDqStages * kDqKeys;
  static constexpr size_t kBytes = kBars + (2 * kDqStages + 1) * sizeof(uint64_t) + 1024;
};

// S = Q K^T and dP = dO V^T of one stage as one group (Q, dO: this
// warpgroup's 64 rows; K, V: the stage's 64 keys)
template <int DH>
__device__ __forceinline__ void dq_scores(float (&s)[32], float (&dp)[32], uint64_t dq_a, uint64_t ddo_a,
                                          const unsigned char* Kst) {
  constexpr int RB = 2 * DH;
  const uint64_t dk_b = hopper::desc_k_major<RB>(Kst);
  const uint64_t dv_b = hopper::desc_k_major<RB>(Kst + kDqKeys * RB);
  hopper::wgmma_fence();
  hopper::wgmma_ss_init(s, dq_a, dk_b);
#pragma unroll
  for (int ks = 1; ks < DH / 16; ++ks) hopper::wgmma_ss_acc(s, desc_add(dq_a, 32 * ks), desc_add(dk_b, 32 * ks));
  hopper::wgmma_ss_init(dp, ddo_a, dv_b);
#pragma unroll
  for (int ks = 1; ks < DH / 16; ++ks) hopper::wgmma_ss_acc(dp, desc_add(ddo_a, 32 * ks), desc_add(dv_b, 32 * ks));
  hopper::wgmma_commit();
}

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ mask, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, Layout L) {
  using S = DqSmem<DH>;
  constexpr int RB = S::kRowBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* Qs = base;
  unsigned char* dOs = base + S::kQ;
  int* info = reinterpret_cast<int*>(base + S::kInfo);
  uint8_t* kvalid = base + S::kValid;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBars);
  uint64_t* empty = full + kDqStages;
  uint64_t* qbar = empty + kDqStages;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kWgBlock;
  const int ntiles = (L.n + kDqKeys - 1) / kDqKeys;
  // under causal, key tiles wholly after the block's last query see none of it
  const int nk = L.causal ? min(ntiles, (q0 + kWgBlock - 1) / kDqKeys + 1) : ntiles;
  const int wg = threadIdx.x / 128;  // kWgConsumers: the producer
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], 128 * kWgConsumers);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kWgConsumers) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 >= 32) return;
    // producer: Q and dO once, then K, V and their keys' validity per tile
    const int lane = threadIdx.x % 32;
    const float* mrow = mask ? mask + static_cast<int64_t>(b) * L.n : nullptr;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(qbar, 2 * S::kQ);
      hopper::tma_load_4d(Qs, &tm_q, qbar, 0, h, q0, b);
      hopper::tma_load_4d(dOs, &tm_do, qbar, 0, h, q0, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < nk; ++kt) {
      uint32_t word = 0;  // keys kt * 64 + 2 lane and + 1: inside T and mask != 0, a byte each
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt * kDqKeys + 2 * lane + e;
        word |= static_cast<uint32_t>(key < L.n && (mrow == nullptr || mrow[key] != 0.f)) << (8 * e);
      }
      if (!__any_sync(0xffffffffu, word != 0)) continue;  // no valid key: adds 0 to dq
      const bool all = __all_sync(0xffffffffu, word == 0x0101u);
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      reinterpret_cast<uint16_t*>(kvalid + stage * kDqKeys)[lane] = static_cast<uint16_t>(word);
      unsigned char* Kst = base + S::kStages0 + stage * 2 * S::kTile;
      if (lane == 0) {
        info[2 * stage] = kt;
        info[2 * stage + 1] = all;
        hopper::mbar_arrive_expect_tx(&full[stage], 2 * S::kTile);
        hopper::tma_load_4d(Kst, &tm_k, &full[stage], 0, h, kt * kDqKeys, b);
        hopper::tma_load_4d(Kst + S::kTile, &tm_v, &full[stage], 0, h, kt * kDqKeys, b);
      } else {
        hopper::mbar_arrive(&full[stage]);
      }
      if (++stage == kDqStages) { stage = 0; phase ^= 1; }
    }
    // the end of the walk: a stage with tile index -1 and no data
    hopper::mbar_wait(&empty[stage], phase ^ 1);
    if (lane == 0) info[2 * stage] = -1;
    hopper::mbar_arrive(&full[stage]);
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegs>();
  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  const int tid = threadIdx.x % 128, t = tid % 4;
  const int row0 = q0 + 64 * wg, lo = row0 + tid / 32 * 16 + tid % 32 / 4, hi = lo + 8;
  const int64_t stat0 = (static_cast<int64_t>(b) * L.heads + h) * L.n;
  const float sl2 = L.scale * kLog2e;
  // the rows' lse (times log2 e) and delta, once
  const float lse_lo = lo < L.n ? lse[stat0 + lo] * kLog2e : 0.f, lse_hi = hi < L.n ? lse[stat0 + hi] * kLog2e : 0.f;
  const float dl_lo = lo < L.n ? delta[stat0 + lo] : 0.f, dl_hi = hi < L.n ? delta[stat0 + hi] : 0.f;
  const uint64_t dq_a = hopper::desc_k_major<RB>(Qs + 64 * wg * RB);
  const uint64_t ddo_a = hopper::desc_k_major<RB>(dOs + 64 * wg * RB);
  float acc[DH / 2], s[32], dp[32];
  uint32_t da[4][4];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) da[k][r] = 0u;
  int stage = 0, pending = -1;
  uint32_t phase = 0;
  hopper::mbar_wait(qbar, 0);
  hopper::mbar_wait(&full[0], 0);
  int kt = info[0];
  if (kt >= 0) dq_scores<DH>(s, dp, dq_a, ddo_a, base + S::kStages0);
  while (kt >= 0) {
    const int st_now = stage;
    const unsigned char* Kst = base + S::kStages0 + st_now * 2 * S::kTile;
    const uint8_t* kv = kvalid + st_now * kDqKeys;
    const int key0 = kt * kDqKeys;
    hopper::wgmma_wait<0>();  // this tile's S and dP, the last tile's dS K
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::fence_regs(acc);
    hopper::fence_regs(da);
    if (pending >= 0) hopper::mbar_arrive(&empty[pending]);
    // no pair is invalid when every key is valid, every row inside T and
    // (causal) the tile's last key at or before this warpgroup's first row
    const bool fast = info[2 * st_now + 1] != 0 && row0 + 63 < L.n && (!L.causal || key0 + kDqKeys - 1 <= row0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e, key = key0 + col;
        float p_lo = hopper::ex2(fmaf(s[4 * j + e], sl2, -lse_lo));
        float p_hi = hopper::ex2(fmaf(s[4 * j + 2 + e], sl2, -lse_hi));
        if (!fast) {
          const bool k_in = kv[col] != 0;
          p_lo = k_in && lo < L.n && (!L.causal || lo >= key) ? p_lo : 0.f;
          p_hi = k_in && hi < L.n && (!L.causal || hi >= key) ? p_hi : 0.f;
        }
        dp[4 * j + e] = p_lo * (dp[4 * j + e] - dl_lo);
        dp[4 * j + 2 + e] = p_hi * (dp[4 * j + 2 + e] - dl_hi);
      }
    // dq += round(dS) K, K MN-major
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r) da[k][r] = hopper::pack_bf16x2(dp[8 * k + 2 * r], dp[8 * k + 2 * r + 1]);
    const uint64_t dk_mn = hopper::desc_mn_major<RB>(Kst);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) hopper::wgmma_rs(acc, da[k], desc_add(dk_mn, k * 16 * RB));
    hopper::wgmma_commit();
    pending = st_now;
    if (++stage == kDqStages) { stage = 0; phase ^= 1; }
    hopper::mbar_wait(&full[stage], phase);
    kt = info[2 * stage];
    if (kt >= 0) dq_scores<DH>(s, dp, dq_a, ddo_a, base + S::kStages0 + stage * 2 * S::kTile);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  hopper::fence_regs(da);

  const int64_t row_ld = static_cast<int64_t>(L.heads) * DH;
  const int64_t obase = static_cast<int64_t>(b) * L.n * row_ld + static_cast<int64_t>(h) * DH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? hi : lo;
    if (row >= L.n) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(dq + obase + static_cast<int64_t>(row) * row_ld);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      dst[4 * j + t] = hopper::pack_bf16x2(acc[4 * j + 2 * half] * L.scale, acc[4 * j + 2 * half + 1] * L.scale);
  }
}

// ----------------------------------------------------------------------------
// f32 Hopper path (route 3, "tf32x3"): f32 at Dh 32 and 64 on layouts TMA can
// describe, for the forward (K9; K6's function in f32), dk/dv (K11; K8's
// in f32) and dq (K10; K7's in f32).
//   * fwd_tf32x3_kernel replaces _fwd_stream (ops/fused_attention.py:425,
//     body _fwd_stream_kernel :307);
//   * dkv_tf32x3_kernel replaces _bwd_stream dkv (:490, body
//     _dkv_stream_kernel :384);
//   * dq_tf32x3_kernel replaces _bwd_stream dq (:470, body
//     _dq_stream_kernel :349).
//
// What bounds them: operations.  The FMA kernels run every f32 product on
// the FMA units (67 TFLOP/s).  Here each f32 product is three tf32 products
// on wgmma (hopper.cuh: a_small.b_big + a_big.b_small + a_big.b_big, the
// low product of f32's 24-bit significands left out, about 2^-22 of each
// term), so the least time is 3 x the operations at 495 TFLOP/s: 2.2x less
// than the FMA units' bound.  A wgmma .tf32 operand in shared memory must
// be K-major, so a product whose reduction axis is the tile's rows (P.V;
// P^T.dO and dS^T.Q) needs its B tile transposed, which TMA cannot do.
// Design:
//   * warp-specialised blocks of 384 threads as the bf16 kernels: consumer
//     warpgroups on wgmma (two in the forward, one in dk/dv), one producer
//     warp issuing TMA loads into a ring of stages (full/empty mbarriers),
//     and worker warps (three in the forward, seven in dk/dv) that turn
//     each landed tile into the operands wgmma takes: big (cvt.rna to
//     tf32) written
//     over the tile in place and small (x - big) beside it, and, for the
//     tiles a product reduces over their rows (V in the forward; Q and dO
//     in dk/dv), a transposed copy, big and small, written in the same
//     128-byte swizzle with the key (query) order permuted within each 8
//     (x3_row), so that the scores' accumulator registers are the A
//     fragment of the next product as they lie (never staged through
//     shared memory); the workers arrive on a `ready` barrier the
//     consumers wait on;
//   * an f32 row is 256 bytes at Dh 64, twice the 128-byte swizzle's
//     widest row, so every tile lies in shared memory as Dh / 32 halves of
//     32-value rows (two TMA boxes), and the descriptors walk the k8
//     steps of one half, then the other;
//   * the forward makes one pass over the key tiles with the online
//     recurrence (running maximum m, alpha = exp(m_old - m_new)), the JAX
//     stream kernel's arithmetic: in f32 no rounding of p sits between,
//     so it is the plain version's function to rounding; its producer
//     skips key tiles with no valid key (masked or past T) and, under
//     causal, tiles wholly after the block's rows, and ends the walk with a
//     stage of tile index -1;
//   * dk/dv: a block owns 64 keys (one consumer warpgroup) and walks
//     32-query stages; a block whose keys are all masked writes zeros and
//     walks nothing, and under causal the walk starts at the first query
//     tile that sees the block's keys;
//   * dq: a block owns 128 query rows (two consumer warpgroups, Q and dO
//     split once) and walks 32-key stages as the forward walks its tiles
//     (the same producer skips; a row with no valid key gets dq = 0);
//     S = Q.K^T and dP = dO.V^T reduce over Dh and read K and V as TMA
//     lands them, dS.K reduces over the keys and reads K^T, which the
//     workers write beside K's split;
//   * a long sum (P.V over the keys, dV and dK over the queries, dq over
//     the keys) is taken
//     a tile at a time on wgmma and added up in registers (x3_acc): the
//     tensor cores' accumulation truncates, and carried through a whole
//     walk it drifts past what f32 products allow.
// Shared memory set the tile sizes (227 KB a block): the split doubles
// each tile and the transposed copies double the reduced ones again.  The
// forward at Dh 64 holds Q (128 rows, big and small: 64 KB) and 2 stages of
// 64 keys (K big and small, V, V^T big and small: 80 KB each); dk/dv at Dh
// 64 holds its 64 keys' K and V (big and small: 64 KB), 2 stages of 32
// queries (Q and dO in both majors, big and small: 64 KB each) and the
// consumers' running dK and dV (32 KB); dq at Dh 64 holds Q and dO (128
// rows, big and small: 128 KB) and 2 stages of 32 keys (K, V and K^T, big
// and small: 6 x 8 KB = 48 KB each), 224 KB with 1.1 KB of barriers and
// alignment, of the 227; 64-key stages (96 KB each) would leave one stage,
// and 64 query rows with one consumer warpgroup (64 + 3 x 48 = 208 KB)
// would transpose each K tile for half as many rows.  Dh 32 takes 4
// stages.
constexpr int kX3Keys = 64;     // keys a forward stage carries; keys a dk/dv block owns
constexpr int kX3Queries = 32;  // queries a dk/dv stage carries
constexpr int kX3DqKeys = 32;   // keys a dq stage carries
constexpr int kX3Workers = 96;      // the forward's and dq's three worker warps, beside the producer warp
constexpr int kX3DkvWorkers = 224;  // dk/dv's seven (one consumer warpgroup: the rest of the block)

// the row of a tile that slot s of its transposed copy holds: within each
// 8, row 2u + e sits at slot u + 4e, so that the accumulator's columns 2t
// and 2t + 1 (a thread's pair) land at the A fragment's columns t and t + 4
__device__ __forceinline__ int x3_row(int s) { return (s & ~7) | ((s & 3) << 1) | ((s & 7) >> 2); }

// byte offset of value c (< 32) of row r in a tile of 128-byte rows under
// the 128-byte swizzle (16-byte chunk c / 4 of row r moves to c / 4 ^ r % 8)
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2));
}

__device__ __forceinline__ float tf32_big(float x) { return __uint_as_float(hopper::to_tf32(x)); }

// `bytes` of f32 at x split in place: big over x, small to the same offset
// of `small` (the swizzle moves both alike); `worker` < W, the workers
template <int W>
__device__ __forceinline__ void x3_split(unsigned char* x, unsigned char* small, int bytes, int worker) {
#pragma unroll 4
  for (int i = 16 * worker; i < bytes; i += 16 * W) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    const float4 big = make_float4(tf32_big(v.x), tf32_big(v.y), tf32_big(v.z), tf32_big(v.w));
    *reinterpret_cast<float4*>(x + i) = big;
    *reinterpret_cast<float4*>(small + i) = make_float4(v.x - big.x, v.y - big.y, v.z - big.z, v.w - big.w);
  }
}

// the transpose of a tile of R rows x DH (DH / 32 halves of R 128-byte
// rows, as TMA lands it), big and small, into `tbig` and `tsmall` (R / 32
// halves of DH 128-byte rows: row d holds the tile's R values of column d
// in slot order); with `small`, the tile is also split in place (big over
// it, small to `small`).  A warp writes 8 columns x 4 slots of one 16-byte
// chunk at a time, and reads 8 columns of 4 rows whose row % 8 differ by
// an even amount: both without bank conflicts.
template <int DH, int R, int W>
__device__ __forceinline__ void x3_transpose(unsigned char* tile, unsigned char* small, unsigned char* tbig,
                                             unsigned char* tsmall, int worker) {
  const int lane = worker % 32;
  constexpr int kItems = (DH / 8) * (R / 4);
#pragma unroll 4
  for (int it = worker / 32; it < kItems; it += W / 32) {
    const int d = it % (DH / 8) * 8 + (lane & 7);
    const int slot = it / (DH / 8) * 4 + (lane >> 3);
    const int r = x3_row(slot);
    const uint32_t from = (d >> 5) * (R * 128) + sw128(r, d & 31);
    const uint32_t to = (slot >> 5) * (DH * 128) + sw128(d, slot & 31);
    const float x = *reinterpret_cast<const float*>(tile + from);
    const float big = tf32_big(x);
    *reinterpret_cast<float*>(tbig + to) = big;
    *reinterpret_cast<float*>(tsmall + to) = x - big;
    if (small != nullptr) {
      *reinterpret_cast<float*>(tile + from) = big;
      *reinterpret_cast<float*>(small + from) = x - big;
    }
  }
}

// D = A . B^T in 3xTF32 over DH (D's old value neither read nor kept; A, B:
// K-major tiles of Dh / 32 halves, `*_half` bytes apart, their small parts
// `*_small` bytes after the big).  One wgmma group, not committed.
template <int DH, int N>
__device__ __forceinline__ void x3_dot(float (&d)[N], const unsigned char* a, int a_half, int a_small,
                                       const unsigned char* b, int b_half, int b_small) {
#pragma unroll
  for (int ks = 0; ks < DH / 8; ++ks) {
    const int c = ks / 4, off = ks % 4 * 32;
    const uint64_t ab = hopper::desc_add(hopper::desc_k_major<128>(a + c * a_half), off);
    const uint64_t as = hopper::desc_add(hopper::desc_k_major<128>(a + a_small + c * a_half), off);
    const uint64_t bb = hopper::desc_add(hopper::desc_k_major<128>(b + c * b_half), off);
    const uint64_t bs = hopper::desc_add(hopper::desc_k_major<128>(b + b_small + c * b_half), off);
    hopper::wgmma_tf32(d, as, bb, ks > 0);
    hopper::wgmma_tf32(d, ab, bs, 1);
    hopper::wgmma_tf32(d, ab, bb, 1);
  }
}

// D = P . X over one tile's rows in 3xTF32 (D's old value neither read nor
// kept), P's big and small parts in accumulator order (pb, ps: a thread's
// values of K8 column blocks as the scores' accumulator holds them), X
// transposed (x3_transpose: tb, ts, halves of N 128-byte rows); K8 k8
// steps.  Not committed.  The caller adds D to its running sum in
// registers: the tensor cores' f32 accumulation truncates, so a sum
// carried through every tile's products (T / 8 x 3 of them) drifts by
// about 3e-5 of its size at T 8192, against 1e-5 that f32 products allow;
// a tile's own 3 K8 products keep that drift near 1e-7.
template <int K8, int N>
__device__ __forceinline__ void x3_acc(float (&d)[N / 2], const uint32_t (&pb)[4 * K8], const uint32_t (&ps)[4 * K8],
                                       const unsigned char* tb, const unsigned char* ts) {
#pragma unroll
  for (int j = 0; j < K8; ++j) {
    const int c = j / 4, off = j % 4 * 32;
    const uint64_t db = hopper::desc_add(hopper::desc_k_major<128>(tb + c * N * 128), off);
    const uint64_t ds = hopper::desc_add(hopper::desc_k_major<128>(ts + c * N * 128), off);
    hopper::wgmma_tf32_rs(d, ps[4 * j], ps[4 * j + 2], ps[4 * j + 1], ps[4 * j + 3], db, j > 0);
    hopper::wgmma_tf32_rs(d, pb[4 * j], pb[4 * j + 2], pb[4 * j + 1], pb[4 * j + 3], ds, 1);
    hopper::wgmma_tf32_rs(d, pb[4 * j], pb[4 * j + 2], pb[4 * j + 1], pb[4 * j + 3], db, 1);
  }
}

__device__ __forceinline__ void x3_parts(float x, uint32_t& big, uint32_t& small) {
  big = hopper::to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

template <int DH>
struct X3FwdSmem {
  static constexpr int kHalves = DH / 32;
  static constexpr int kStages = DH == 64 ? 2 : 4;
  static constexpr int kQ = kWgBlock * 128 * kHalves;    // Q (big, in place), then Q small
  static constexpr int kTile = kX3Keys * 128 * kHalves;  // a K or V tile, or V^T (Dh rows of 64 slots)
  static constexpr int kStage = 5 * kTile;               // K, K small, V, V^T big, V^T small
  static constexpr int kStages0 = 2 * kQ;
  static constexpr int kInfo = kStages0 + kStages * kStage;  // per stage: tile index, all keys valid
  static constexpr int kValid = kInfo + kStages * 2 * static_cast<int>(sizeof(int));
  static constexpr int kBars = kValid + kStages * kX3Keys;
  static constexpr size_t kBytes = kBars + (3 * kStages + 2) * sizeof(uint64_t) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ mask,
                      float* __restrict__ out, float* __restrict__ lse, Layout L) {
  using S = X3FwdSmem<DH>;
  constexpr int NH = S::kHalves;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* Qs = base;
  int* info = reinterpret_cast<int*>(base + S::kInfo);
  uint8_t* kvalid = base + S::kValid;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBars);
  uint64_t* ready = full + S::kStages;
  uint64_t* empty = ready + S::kStages;
  uint64_t* qbar = empty + S::kStages;
  uint64_t* qready = qbar + 1;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kWgBlock;
  const int ntiles = (L.n + kX3Keys - 1) / kX3Keys;
  // under causal, key tiles wholly after the block's last row see none of it
  const int nk = L.causal ? min(ntiles, (q0 + kWgBlock - 1) / kX3Keys + 1) : ntiles;
  const int wg = threadIdx.x / 128;  // kWgConsumers: producer and workers
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&ready[s], kX3Workers);
      hopper::mbar_init(&empty[s], 128 * kWgConsumers);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_init(qready, kX3Workers);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kWgConsumers) {
    const int lane = threadIdx.x % 32;
    if (threadIdx.x % 128 < 32) {
      // producer: Q once, then K, V and their keys' validity per tile
      const float* mrow = mask ? mask + static_cast<int64_t>(b) * L.n : nullptr;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(qbar, S::kQ);
        for (int c = 0; c < NH; ++c) hopper::tma_load_4d(Qs + c * kWgBlock * 128, &tm_q, qbar, 32 * c, h, q0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < nk; ++kt) {
        uint32_t word = 0;  // keys kt * 64 + 2 lane and + 1: inside T and mask != 0, a byte each
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kt * kX3Keys + 2 * lane + e;
          word |= static_cast<uint32_t>(key < L.n && (mrow == nullptr || mrow[key] != 0.f)) << (8 * e);
        }
        if (!__any_sync(0xffffffffu, word != 0)) continue;  // no valid key: p = 0 for every row
        const bool all = __all_sync(0xffffffffu, word == 0x0101u);
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        reinterpret_cast<uint16_t*>(kvalid + stage * kX3Keys)[lane] = static_cast<uint16_t>(word);
        unsigned char* st = base + S::kStages0 + stage * S::kStage;
        if (lane == 0) {
          info[2 * stage] = kt;
          info[2 * stage + 1] = all;
          hopper::mbar_arrive_expect_tx(&full[stage], 2 * S::kTile);
          for (int c = 0; c < NH; ++c) {
            hopper::tma_load_4d(st + c * kX3Keys * 128, &tm_k, &full[stage], 32 * c, h, kt * kX3Keys, b);
            hopper::tma_load_4d(st + 2 * S::kTile + c * kX3Keys * 128, &tm_v, &full[stage], 32 * c, h,
                                kt * kX3Keys, b);
          }
        } else {
          hopper::mbar_arrive(&full[stage]);
        }
        if (++stage == S::kStages) { stage = 0; phase ^= 1; }
      }
      // the end of the walk: a stage with tile index -1 and no data
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      if (lane == 0) info[2 * stage] = -1;
      hopper::mbar_arrive(&full[stage]);
      return;
    }
    // workers: Q into big and small once, then each stage's K into big and
    // small and V into V^T big and small
    const int worker = threadIdx.x % 128 - 32;
    hopper::mbar_wait(qbar, 0);
    x3_split<kX3Workers>(Qs, Qs + S::kQ, S::kQ, worker);
    hopper::fence_proxy_async();
    hopper::mbar_arrive(qready);
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      hopper::mbar_wait(&full[stage], phase);
      const int kt = info[2 * stage];
      if (kt >= 0) {
        unsigned char* st = base + S::kStages0 + stage * S::kStage;
        x3_split<kX3Workers>(st, st + S::kTile, S::kTile, worker);
        x3_transpose<DH, kX3Keys, kX3Workers>(st + 2 * S::kTile, nullptr, st + 3 * S::kTile, st + 4 * S::kTile,
                                                 worker);
        hopper::fence_proxy_async();
      }
      hopper::mbar_arrive(&ready[stage]);
      if (kt < 0) return;
      if (++stage == S::kStages) { stage = 0; phase ^= 1; }
    }
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63.  Per tile:
  // S = Q K^T (3xTF32), the rows' new maxima, p = exp(s - m) and the
  // rescale of l by alpha, then the tile's P V from P's registers into ot,
  // added as o = o alpha + ot.  A warpgroup waits for each product; the
  // two warpgroups fill each other's waits (at 168 registers a thread, the
  // most 384 threads have, the next tile's S cannot be in flight beside
  // P V's operands and both sums).
  const int tid = threadIdx.x % 128, t = tid % 4;
  const int row0 = q0 + 64 * wg, lo = row0 + tid / 32 * 16 + tid % 32 / 4, hi = lo + 8;
  const unsigned char* q_rows = Qs + 64 * wg * 128;  // this warpgroup's rows of each half
  const float sl2 = L.scale * kLog2e;
  float s[32], o[DH / 2], ot[DH / 2];
  uint32_t pb[32], ps[32];
  float m_lo = kMasked, m_hi = kMasked, l_lo = 0.f, l_hi = 0.f;
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  hopper::mbar_wait(qready, 0);
  for (;;) {
    hopper::mbar_wait(&ready[stage], phase);
    const int kt = info[2 * stage];
    if (kt < 0) break;
    const unsigned char* st = base + S::kStages0 + stage * S::kStage;
    const uint8_t* kv = kvalid + stage * kX3Keys;
    const int key0 = kt * kX3Keys;
    hopper::wgmma_fence();
    x3_dot<DH>(s, q_rows, kWgBlock * 128, S::kQ, st, kX3Keys * 128, S::kTile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    // no pair is invalid when every key is valid, every row inside T and
    // (causal) the tile's last key at or before this warpgroup's first row
    const bool fast = info[2 * stage + 1] != 0 && row0 + 63 < L.n && (!L.causal || key0 + kX3Keys - 1 <= row0);
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        if (fast || fwd_valid(kv, col, lo, key0 + col, L)) mx_lo = fmaxf(mx_lo, s[4 * j + e] * L.scale);
        if (fast || fwd_valid(kv, col, hi, key0 + col, L)) mx_hi = fmaxf(mx_hi, s[4 * j + 2 + e] * L.scale);
      }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    const float a_lo = exp2f((m_lo - mx_lo) * kLog2e), a_hi = exp2f((m_hi - mx_hi) * kLog2e);
    m_lo = mx_lo;
    m_hi = mx_hi;
    const float ml_lo = m_lo * kLog2e, ml_hi = m_hi * kLog2e;
    l_lo *= a_lo;
    l_hi *= a_hi;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e, i = 4 * j + e;
        const float p_lo = fast || fwd_valid(kv, col, lo, key0 + col, L) ? exp2f(fmaf(s[i], sl2, -ml_lo)) : 0.f;
        const float p_hi =
            fast || fwd_valid(kv, col, hi, key0 + col, L) ? exp2f(fmaf(s[i + 2], sl2, -ml_hi)) : 0.f;
        l_lo += p_lo;
        l_hi += p_hi;
        x3_parts(p_lo, pb[i], ps[i]);
        x3_parts(p_hi, pb[i + 2], ps[i + 2]);
      }
    hopper::wgmma_fence();
    x3_acc<8, DH>(ot, pb, ps, st + 3 * S::kTile, st + 4 * S::kTile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(ot);
    hopper::fence_regs(pb);
    hopper::fence_regs(ps);
    hopper::mbar_arrive(&empty[stage]);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = fmaf(o[i], i % 4 < 2 ? a_lo : a_hi, ot[i]);
    if (++stage == S::kStages) { stage = 0; phase ^= 1; }
  }

  const float d_lo = fmaxf(quad_sum(l_lo), 1e-30f), d_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  const int64_t row_ld = static_cast<int64_t>(L.heads) * DH;
  const int64_t obase = static_cast<int64_t>(b) * L.n * row_ld + static_cast<int64_t>(h) * DH;
  const int64_t stat0 = (static_cast<int64_t>(b) * L.heads + h) * L.n;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? hi : lo;
    const float denom = half ? d_hi : d_lo;
    if (row >= L.n) continue;
    if (t == 0) lse[stat0 + row] = (half ? m_hi : m_lo) + logf(denom);
    float2* dst = reinterpret_cast<float2*>(out + obase + static_cast<int64_t>(row) * row_ld);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      dst[4 * j + t] = make_float2(o[4 * j + 2 * half] / denom, o[4 * j + 2 * half + 1] / denom);
  }
}

template <int DH>
struct X3DkvSmem {
  static constexpr int kHalves = DH / 32;
  static constexpr int kStages = DH == 64 ? 2 : 4;
  static constexpr int kKV = kX3Keys * 128 * kHalves;       // K or V of the block's keys, big or small
  static constexpr int kTile = kX3Queries * 128 * kHalves;  // Q or dO, big or small, either major
  static constexpr int kStage = 8 * kTile;  // Q, Q small, dO, dO small, Q^T big, small, dO^T big, small
  static constexpr int kStages0 = 4 * kKV;  // K, K small, V, V small
  static constexpr int kSums = kStages0 + kStages * kStage;  // dK and dV, a column of DH values a consumer
  static constexpr int kStats = kSums + 128 * DH * static_cast<int>(sizeof(float));  // lse log2 e, delta
  static constexpr int kValid = kStats + kStages * 2 * kX3Queries * static_cast<int>(sizeof(float));
  static constexpr int kBars = kValid + kX3Keys;
  static constexpr size_t kBytes = kBars + (3 * kStages + 2) * sizeof(uint64_t) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    dkv_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ mask, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, Layout L) {
  using S = X3DkvSmem<DH>;
  constexpr int NH = S::kHalves;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  float* sums = reinterpret_cast<float*>(base + S::kSums);
  float* stats = reinterpret_cast<float*>(base + S::kStats);
  uint8_t* kvalid = base + S::kValid;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBars);
  uint64_t* ready = full + S::kStages;
  uint64_t* empty = ready + S::kStages;
  uint64_t* kvbar = empty + S::kStages;
  uint64_t* kvready = kvbar + 1;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kX3Keys;
  const int64_t row_ld = static_cast<int64_t>(L.heads) * DH;
  const int64_t obase = static_cast<int64_t>(b) * L.n * row_ld + static_cast<int64_t>(h) * DH;
  const float* mrow = mask ? mask + static_cast<int64_t>(b) * L.n : nullptr;
  // the block's keys: inside T and mask != 0
  const bool mine = threadIdx.x < kX3Keys && k0 + static_cast<int>(threadIdx.x) < L.n &&
                    (mrow == nullptr || mrow[k0 + threadIdx.x] != 0.f);
  if (threadIdx.x < kX3Keys) kvalid[threadIdx.x] = mine;
  const bool keys_all = __syncthreads_and(threadIdx.x >= kX3Keys || mine) != 0;
  if (!__syncthreads_or(mine)) {
    // no valid key: every p of these keys is 0, so dk = dv = 0
    for (int i = threadIdx.x; i < kX3Keys * DH; i += kWgThreads) {
      const int key = k0 + i / DH;
      if (key >= L.n) break;
      dk[obase + static_cast<int64_t>(key) * row_ld + i % DH] = 0.f;
      dv[obase + static_cast<int64_t>(key) * row_ld + i % DH] = 0.f;
    }
    return;
  }
  const int nq = (L.n + kX3Queries - 1) / kX3Queries;
  // under causal, query tiles wholly before this block's keys see none of them
  const int qt0 = L.causal ? k0 / kX3Queries : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&ready[s], kX3DkvWorkers);
      hopper::mbar_init(&empty[s], 128);
    }
    hopper::mbar_init(kvbar, 1);
    hopper::mbar_init(kvready, kX3DkvWorkers);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x < 160) {
      // producer (one lane): K and V once, then Q and dO per query tile
      if (threadIdx.x != 128) return;
      hopper::mbar_arrive_expect_tx(kvbar, 2 * S::kKV);
      for (int c = 0; c < NH; ++c) {
        hopper::tma_load_4d(base + c * kX3Keys * 128, &tm_k, kvbar, 32 * c, h, k0, b);
        hopper::tma_load_4d(base + 2 * S::kKV + c * kX3Keys * 128, &tm_v, kvbar, 32 * c, h, k0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int qt = qt0; qt < nq; ++qt) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = base + S::kStages0 + stage * S::kStage;
        hopper::mbar_arrive_expect_tx(&full[stage], 2 * S::kTile);
        for (int c = 0; c < NH; ++c) {
          hopper::tma_load_4d(st + c * kX3Queries * 128, &tm_q, &full[stage], 32 * c, h, qt * kX3Queries, b);
          hopper::tma_load_4d(st + 2 * S::kTile + c * kX3Queries * 128, &tm_do, &full[stage], 32 * c, h,
                              qt * kX3Queries, b);
        }
        if (++stage == S::kStages) { stage = 0; phase ^= 1; }
      }
      return;
    }
    // workers: K and V into big and small once; per stage Q and dO into big
    // and small in both majors, and the queries' lse (times log2 e) and
    // delta, loaded a stage ahead
    const int worker = threadIdx.x - 160;
    const int64_t stat0 = (static_cast<int64_t>(b) * L.heads + h) * L.n;
    float lse_next = 0.f, delta_next = 0.f;
    if (worker < kX3Queries && qt0 * kX3Queries + worker < L.n) {
      lse_next = lse[stat0 + qt0 * kX3Queries + worker] * kLog2e;
      delta_next = delta[stat0 + qt0 * kX3Queries + worker];
    }
    hopper::mbar_wait(kvbar, 0);
    x3_split<kX3DkvWorkers>(base, base + S::kKV, S::kKV, worker);
    x3_split<kX3DkvWorkers>(base + 2 * S::kKV, base + 3 * S::kKV, S::kKV, worker);
    hopper::fence_proxy_async();
    hopper::mbar_arrive(kvready);
    int stage = 0;
    uint32_t phase = 0;
    for (int qt = qt0; qt < nq; ++qt) {
      const float lse_now = lse_next, delta_now = delta_next;
      const int row = (qt + 1) * kX3Queries + worker;
      if (worker < kX3Queries && row < L.n) {
        lse_next = lse[stat0 + row] * kLog2e;
        delta_next = delta[stat0 + row];
      }
      hopper::mbar_wait(&full[stage], phase);
      unsigned char* st = base + S::kStages0 + stage * S::kStage;
      if (worker < kX3Queries) {
        float* sts = stats + stage * 2 * kX3Queries;
        sts[worker] = lse_now;
        sts[kX3Queries + worker] = delta_now;
      }
      x3_transpose<DH, kX3Queries, kX3DkvWorkers>(st, st + S::kTile, st + 4 * S::kTile, st + 5 * S::kTile, worker);
      x3_transpose<DH, kX3Queries, kX3DkvWorkers>(st + 2 * S::kTile, st + 3 * S::kTile, st + 6 * S::kTile,
                                                  st + 7 * S::kTile, worker);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&ready[stage]);
      if (++stage == S::kStages) { stage = 0; phase ^= 1; }
    }
    return;
  }

  // consumers: the warpgroup owns the block's 64 keys; rows of every
  // product are keys, columns queries (causal: valid when query >= key).
  // Per stage S^T = K Q^T and dP^T = V dO^T (3xTF32), p^T = exp(s^T - lse),
  // dS^T = p^T (dP^T - delta), then the stage's P^T dO and dS^T Q from the
  // registers into tv and tk, added to dV and dK (x3_acc), which a thread
  // keeps in its own column of shared memory: at 168 registers a thread,
  // the most 384 threads have, they do not fit beside the stage's values.
  // The warpgroup waits for each product; the seven workers transpose the
  // next stage meanwhile.
  const int w = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int r_lo = 16 * w + g, key_lo = k0 + r_lo, key_hi = key_lo + 8;
  float* sum_k = sums + threadIdx.x;  // value i of dK at sum_k[128 i], of dV at sum_v[128 i]
  float* sum_v = sum_k + 128 * (DH / 2);
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) sum_k[128 * i] = sum_v[128 * i] = 0.f;
  const float sl2 = L.scale * kLog2e;
  const bool kv_lo = kvalid[r_lo] != 0, kv_hi = kvalid[r_lo + 8] != 0;
  float tk[DH / 2], tv[DH / 2], s[16], dp[16];
  uint32_t pb[16], ps[16], db[16], dsm[16];
  int stage = 0;
  uint32_t phase = 0;
  hopper::mbar_wait(kvready, 0);
  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * kX3Queries;
    const unsigned char* st = base + S::kStages0 + stage * S::kStage;
    const float* sts = stats + stage * 2 * kX3Queries;
    hopper::mbar_wait(&ready[stage], phase);
    hopper::wgmma_fence();
    x3_dot<DH>(s, base, kX3Keys * 128, S::kKV, st, kX3Queries * 128, S::kTile);
    x3_dot<DH>(dp, base + 2 * S::kKV, kX3Keys * 128, S::kKV, st + 2 * S::kTile, kX3Queries * 128, S::kTile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    // no pair is invalid when every key is valid, every query inside T and
    // (causal) the stage's first query at or after the block's last key
    const bool fast = keys_all && q0 + kX3Queries <= L.n && (!L.causal || q0 >= k0 + kX3Keys - 1);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = 8 * j + 2 * t + e, query = q0 + ql, i = 4 * j + e;
        const float lse_l2 = sts[ql], dl = sts[kX3Queries + ql];
        float p_lo = exp2f(fmaf(s[i], sl2, -lse_l2));
        float p_hi = exp2f(fmaf(s[i + 2], sl2, -lse_l2));
        if (!fast) {
          const bool qin = query < L.n;
          p_lo = kv_lo && qin && (!L.causal || query >= key_lo) ? p_lo : 0.f;
          p_hi = kv_hi && qin && (!L.causal || query >= key_hi) ? p_hi : 0.f;
        }
        x3_parts(p_lo, pb[i], ps[i]);
        x3_parts(p_hi, pb[i + 2], ps[i + 2]);
        x3_parts(p_lo * (dp[i] - dl), db[i], dsm[i]);
        x3_parts(p_hi * (dp[i + 2] - dl), db[i + 2], dsm[i + 2]);
      }
    // the stage's P^T dO and dS^T Q: dO^T and Q^T as the transposed B tiles
    hopper::wgmma_fence();
    x3_acc<4, DH>(tv, pb, ps, st + 6 * S::kTile, st + 7 * S::kTile);
    x3_acc<4, DH>(tk, db, dsm, st + 4 * S::kTile, st + 5 * S::kTile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(tk);
    hopper::fence_regs(tv);
    hopper::fence_regs(pb);
    hopper::fence_regs(ps);
    hopper::fence_regs(db);
    hopper::fence_regs(dsm);
    hopper::mbar_arrive(&empty[stage]);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) {
      sum_k[128 * i] += tk[i];
      sum_v[128 * i] += tv[i];
    }
    if (++stage == S::kStages) { stage = 0; phase ^= 1; }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key_hi : key_lo;
    if (key >= L.n) continue;
    float2* dkr = reinterpret_cast<float2*>(dk + obase + static_cast<int64_t>(key) * row_ld);
    float2* dvr = reinterpret_cast<float2*>(dv + obase + static_cast<int64_t>(key) * row_ld);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int i = 4 * j + 2 * half;
      dkr[4 * j + t] = make_float2(sum_k[128 * i] * L.scale, sum_k[128 * (i + 1)] * L.scale);
      dvr[4 * j + t] = make_float2(sum_v[128 * i], sum_v[128 * (i + 1)]);
    }
  }
}

template <int DH>
struct X3DqSmem {
  static constexpr int kHalves = DH / 32;
  static constexpr int kStages = DH == 64 ? 2 : 4;
  static constexpr int kQ = kWgBlock * 128 * kHalves;      // Q (or dO) of the block's rows, big or small
  static constexpr int kTile = kX3DqKeys * 128 * kHalves;  // a K or V tile, big or small, or K^T (Dh rows)
  static constexpr int kStage = 6 * kTile;                 // K, K small, V, V small, K^T big, K^T small
  static constexpr int kStages0 = 4 * kQ;                  // Q, Q small, dO, dO small
  static constexpr int kInfo = kStages0 + kStages * kStage;  // per stage: tile index, all keys valid
  static constexpr int kValid = kInfo + kStages * 2 * static_cast<int>(sizeof(int));
  static constexpr int kBars = kValid + kStages * kX3DqKeys;
  static constexpr size_t kBytes = kBars + (3 * kStages + 2) * sizeof(uint64_t) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    dq_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ mask, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq, Layout L) {
  using S = X3DqSmem<DH>;
  constexpr int NH = S::kHalves;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  int* info = reinterpret_cast<int*>(base + S::kInfo);
  uint8_t* kvalid = base + S::kValid;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBars);
  uint64_t* ready = full + S::kStages;
  uint64_t* empty = ready + S::kStages;
  uint64_t* qbar = empty + S::kStages;
  uint64_t* qready = qbar + 1;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kWgBlock;
  const int ntiles = (L.n + kX3DqKeys - 1) / kX3DqKeys;
  // under causal, key tiles wholly after the block's last row see none of it
  const int nk = L.causal ? min(ntiles, (q0 + kWgBlock - 1) / kX3DqKeys + 1) : ntiles;
  const int wg = threadIdx.x / 128;  // kWgConsumers: producer and workers
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&ready[s], kX3Workers);
      hopper::mbar_init(&empty[s], 128 * kWgConsumers);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_init(qready, kX3Workers);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kWgConsumers) {
    const int lane = threadIdx.x % 32;
    if (threadIdx.x % 128 < 32) {
      // producer: Q and dO once, then K, V and their keys' validity per tile
      const float* mrow = mask ? mask + static_cast<int64_t>(b) * L.n : nullptr;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(qbar, 2 * S::kQ);
        for (int c = 0; c < NH; ++c) {
          hopper::tma_load_4d(base + c * kWgBlock * 128, &tm_q, qbar, 32 * c, h, q0, b);
          hopper::tma_load_4d(base + 2 * S::kQ + c * kWgBlock * 128, &tm_do, qbar, 32 * c, h, q0, b);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < nk; ++kt) {
        const int key = kt * kX3DqKeys + lane;  // a key a lane: inside T and mask != 0
        const bool valid = key < L.n && (mrow == nullptr || mrow[key] != 0.f);
        if (!__any_sync(0xffffffffu, valid)) continue;  // no valid key: adds 0 to dq
        const bool all = __all_sync(0xffffffffu, valid);
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        kvalid[stage * kX3DqKeys + lane] = valid;
        unsigned char* st = base + S::kStages0 + stage * S::kStage;
        if (lane == 0) {
          info[2 * stage] = kt;
          info[2 * stage + 1] = all;
          hopper::mbar_arrive_expect_tx(&full[stage], 2 * S::kTile);
          for (int c = 0; c < NH; ++c) {
            hopper::tma_load_4d(st + c * kX3DqKeys * 128, &tm_k, &full[stage], 32 * c, h, kt * kX3DqKeys, b);
            hopper::tma_load_4d(st + 2 * S::kTile + c * kX3DqKeys * 128, &tm_v, &full[stage], 32 * c, h,
                                kt * kX3DqKeys, b);
          }
        } else {
          hopper::mbar_arrive(&full[stage]);
        }
        if (++stage == S::kStages) { stage = 0; phase ^= 1; }
      }
      // the end of the walk: a stage with tile index -1 and no data
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      if (lane == 0) info[2 * stage] = -1;
      hopper::mbar_arrive(&full[stage]);
      return;
    }
    // workers: Q and dO into big and small once, then each stage's K into
    // big and small in both majors and V into big and small
    const int worker = threadIdx.x % 128 - 32;
    hopper::mbar_wait(qbar, 0);
    x3_split<kX3Workers>(base, base + S::kQ, S::kQ, worker);
    x3_split<kX3Workers>(base + 2 * S::kQ, base + 3 * S::kQ, S::kQ, worker);
    hopper::fence_proxy_async();
    hopper::mbar_arrive(qready);
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      hopper::mbar_wait(&full[stage], phase);
      const int kt = info[2 * stage];
      if (kt >= 0) {
        unsigned char* st = base + S::kStages0 + stage * S::kStage;
        x3_transpose<DH, kX3DqKeys, kX3Workers>(st, st + S::kTile, st + 4 * S::kTile, st + 5 * S::kTile, worker);
        x3_split<kX3Workers>(st + 2 * S::kTile, st + 3 * S::kTile, S::kTile, worker);
        hopper::fence_proxy_async();
      }
      hopper::mbar_arrive(&ready[stage]);
      if (kt < 0) return;
      if (++stage == S::kStages) { stage = 0; phase ^= 1; }
    }
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63.  Per stage:
  // S = Q K^T and dP = dO V^T (3xTF32), p = exp(s - lse) (0 on invalid
  // pairs), dS = p (dP - delta), then the stage's dS K from dS's registers
  // (K^T as the transposed B tile) into dt, added to dq in registers.  A
  // warpgroup waits for each product; the two warpgroups fill each
  // other's waits.
  const int tid = threadIdx.x % 128, t = tid % 4;
  const int row0 = q0 + 64 * wg, lo = row0 + tid / 32 * 16 + tid % 32 / 4, hi = lo + 8;
  const int64_t stat0 = (static_cast<int64_t>(b) * L.heads + h) * L.n;
  const float sl2 = L.scale * kLog2e;
  // the rows' lse (times log2 e) and delta, once
  const float lse_lo = lo < L.n ? lse[stat0 + lo] * kLog2e : 0.f, lse_hi = hi < L.n ? lse[stat0 + hi] * kLog2e : 0.f;
  const float dl_lo = lo < L.n ? delta[stat0 + lo] : 0.f, dl_hi = hi < L.n ? delta[stat0 + hi] : 0.f;
  const unsigned char* q_rows = base + 64 * wg * 128;  // this warpgroup's rows of each half
  const unsigned char* do_rows = q_rows + 2 * S::kQ;
  float acc[DH / 2], dt[DH / 2], s[16], dp[16];
  uint32_t db[16], dsm[16];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  hopper::mbar_wait(qready, 0);
  for (;;) {
    hopper::mbar_wait(&ready[stage], phase);
    const int kt = info[2 * stage];
    if (kt < 0) break;
    const unsigned char* st = base + S::kStages0 + stage * S::kStage;
    const uint8_t* kv = kvalid + stage * kX3DqKeys;
    const int key0 = kt * kX3DqKeys;
    hopper::wgmma_fence();
    x3_dot<DH>(s, q_rows, kWgBlock * 128, S::kQ, st, kX3DqKeys * 128, S::kTile);
    x3_dot<DH>(dp, do_rows, kWgBlock * 128, S::kQ, st + 2 * S::kTile, kX3DqKeys * 128, S::kTile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    // no pair is invalid when every key is valid, every row inside T and
    // (causal) the tile's last key at or before this warpgroup's first row
    const bool fast = info[2 * stage + 1] != 0 && row0 + 63 < L.n && (!L.causal || key0 + kX3DqKeys - 1 <= row0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e, key = key0 + col, i = 4 * j + e;
        float p_lo = exp2f(fmaf(s[i], sl2, -lse_lo));
        float p_hi = exp2f(fmaf(s[i + 2], sl2, -lse_hi));
        if (!fast) {
          const bool k_in = kv[col] != 0;
          p_lo = k_in && lo < L.n && (!L.causal || lo >= key) ? p_lo : 0.f;
          p_hi = k_in && hi < L.n && (!L.causal || hi >= key) ? p_hi : 0.f;
        }
        x3_parts(p_lo * (dp[i] - dl_lo), db[i], dsm[i]);
        x3_parts(p_hi * (dp[i + 2] - dl_hi), db[i + 2], dsm[i + 2]);
      }
    hopper::wgmma_fence();
    x3_acc<4, DH>(dt, db, dsm, st + 4 * S::kTile, st + 5 * S::kTile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dt);
    hopper::fence_regs(db);
    hopper::fence_regs(dsm);
    hopper::mbar_arrive(&empty[stage]);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] += dt[i];
    if (++stage == S::kStages) { stage = 0; phase ^= 1; }
  }

  const int64_t row_ld = static_cast<int64_t>(L.heads) * DH;
  const int64_t obase = static_cast<int64_t>(b) * L.n * row_ld + static_cast<int64_t>(h) * DH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? hi : lo;
    if (row >= L.n) continue;
    float2* dst = reinterpret_cast<float2*>(dq + obase + static_cast<int64_t>(row) * row_ld);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      dst[4 * j + t] = make_float2(acc[4 * j + 2 * half] * L.scale, acc[4 * j + 2 * half + 1] * L.scale);
  }
}

constexpr size_t rows_bytes(int dh) { return sizeof(bf16) * kTile * (dh + 8); }
constexpr size_t fwd_mma_smem(int dh) { return 3 * rows_bytes(dh) + kTile; }
constexpr size_t dq_mma_smem(int dh) { return 4 * rows_bytes(dh) + kTile; }
constexpr size_t dkv_mma_smem(int dh) { return 4 * rows_bytes(dh) + 2 * sizeof(float) * kTile + kTile; }
// the mma.sync kernels serve bf16 up to Dh 64; f32 (exact f32 products)
// and Dh 128 (whose accumulators would spill) take the FMA kernels
template <typename T, int DH>
constexpr bool use_mma() { return std::is_same<T, bf16>::value && DH <= 64; }

constexpr size_t tile_bytes(int dh) { return sizeof(float) * kTile * (dh + 1); }
constexpr size_t p_bytes() { return sizeof(float) * kTile * kPLd; }
constexpr size_t fwd_smem(int dh) { return 3 * tile_bytes(dh) + p_bytes() + kTile; }
constexpr size_t dq_smem(int dh) { return 4 * tile_bytes(dh) + p_bytes() + kTile; }
constexpr size_t dkv_smem(int dh) {
  return 4 * tile_bytes(dh) + 2 * p_bytes() + 2 * sizeof(float) * kTile + kTile;
}

// `operands` are the row-major bf16/f32 operands the kernels load rows of
Layout make_layout(long long sb, long long st, long long sh, int T, int H, int Dh, float scale,
                   int causal, std::initializer_list<const void*> operands) {
  Layout L;
  L.vec = Dh % 8 == 0 && sb % 8 == 0 && st % 8 == 0 && sh % 8 == 0;
  for (const void* p : operands) L.vec = L.vec && aligned16(p);
  L.sb = sb;
  L.st = st;
  L.sh = sh;
  L.n = T;
  L.heads = H;
  L.dh = Dh;
  L.scale = scale;
  L.causal = causal != 0;
  return L;
}

// The layouts the TMA route takes (ops/fused_attention.py::kernel_route
// states the same rule): bf16 at Dh 32 or 64, 16-byte-aligned bases, and
// strides nested as a tensor map describes them (each dimension's byte
// stride a positive multiple of 16 that spans the dimensions inside it; a
// dimension of size 1 is free).  Returns false where they fail.
bool tma_strides(Strides& s, int B, int T, int H, int Dh, int item) {
  if (H == 1) s.sh = Dh;
  if (T == 1) s.st = s.sh * H;
  if (B == 1) s.sb = s.st * T;
  for (long long x : {s.sh, s.st, s.sb})
    if (x <= 0 || (item * x) % 16 != 0) return false;
  return s.sh >= Dh && s.st >= s.sh * H && s.sb >= s.st * T;
}

// the maps of q, k and v (rows `qrows` and `kvrows` a box; `item`: 2 for
// bf16, 4 for f32), or an error when the layout is not a TMA route's
cudaError_t qkv_maps(CUtensorMap maps[3], const void* q, const void* k, const void* v, int B, const Layout& L,
                     int qrows, int kvrows, int item = 2) {
  Strides s{L.sh, L.st, L.sb};
  if (!(L.dh == 32 || L.dh == 64) || !tma_strides(s, B, L.n, L.heads, L.dh, item)) return cudaErrorInvalidValue;
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    if (ptrs[i] == nullptr || !aligned16(ptrs[i])) return cudaErrorInvalidValue;
    const int rows = i == 0 ? qrows : kvrows;
    const cudaError_t err = item == 4 ? make_map_f32(&maps[i], ptrs[i], s, B, L.n, L.heads, L.dh, rows)
                                      : make_map(&maps[i], ptrs[i], s, B, L.n, L.heads, L.dh, rows);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int DH>
int fwd_wgmma(const void* q, const void* k, const void* v, const float* mask, void* out, float* lse, int B,
              const Layout& L, cudaStream_t stream) {
  CUtensorMap maps[3];
  cudaError_t err = qkv_maps(maps, q, k, v, B, L, kWgBlock, kFwdKeys);
  if (err == cudaSuccess) err = allow_smem(reinterpret_cast<const void*>(fwd_wgmma_kernel<DH>), FwdSmem<DH>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L.n + kWgBlock - 1) / kWgBlock, L.heads, B);
  fwd_wgmma_kernel<DH><<<grid, kWgThreads, FwdSmem<DH>::kBytes, stream>>>(
      maps[0], maps[1], maps[2], mask, static_cast<bf16*>(out), lse, L);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int dkv_wgmma(const void* q, const void* k, const void* v, const float* mask, const void* dout, const float* lse,
              const float* delta, void* dk, void* dv, int B, const Layout& L, cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t err = qkv_maps(maps, q, k, v, B, L, kDkvQueries, kWgBlock);
  // dout is contiguous [B, T, H, Dh]
  const long long row = static_cast<long long>(L.heads) * DH;
  if (err == cudaSuccess && !aligned16(dout)) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = make_map(&maps[3], dout, Strides{DH, row, row * L.n}, B, L.n, L.heads, DH, kDkvQueries);
  if (err == cudaSuccess) err = allow_smem(reinterpret_cast<const void*>(dkv_wgmma_kernel<DH>), DkvSmem<DH>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L.n + kWgBlock - 1) / kWgBlock, L.heads, B);
  dkv_wgmma_kernel<DH><<<grid, kWgThreads, DkvSmem<DH>::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], mask, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), L);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int dq_wgmma(const void* q, const void* k, const void* v, const float* mask, const void* dout, const float* lse,
             const float* delta, void* dq, int B, const Layout& L, cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t err = qkv_maps(maps, q, k, v, B, L, kWgBlock, kDqKeys);
  // dout is contiguous [B, T, H, Dh]
  const long long row = static_cast<long long>(L.heads) * DH;
  if (err == cudaSuccess && !aligned16(dout)) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = make_map(&maps[3], dout, Strides{DH, row, row * L.n}, B, L.n, L.heads, DH, kWgBlock);
  if (err == cudaSuccess) err = allow_smem(reinterpret_cast<const void*>(dq_wgmma_kernel<DH>), DqSmem<DH>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L.n + kWgBlock - 1) / kWgBlock, L.heads, B);
  dq_wgmma_kernel<DH><<<grid, kWgThreads, DqSmem<DH>::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], mask, lse, delta, static_cast<bf16*>(dq), L);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int fwd_tf32x3(const void* q, const void* k, const void* v, const float* mask, void* out, float* lse, int B,
               const Layout& L, cudaStream_t stream) {
  using S = X3FwdSmem<DH>;
  CUtensorMap maps[3];
  cudaError_t err = qkv_maps(maps, q, k, v, B, L, kWgBlock, kX3Keys, 4);
  if (err == cudaSuccess) err = allow_smem(reinterpret_cast<const void*>(fwd_tf32x3_kernel<DH>), S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L.n + kWgBlock - 1) / kWgBlock, L.heads, B);
  fwd_tf32x3_kernel<DH><<<grid, kWgThreads, S::kBytes, stream>>>(maps[0], maps[1], maps[2], mask,
                                                                  static_cast<float*>(out), lse, L);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int dkv_tf32x3(const void* q, const void* k, const void* v, const float* mask, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, const Layout& L, cudaStream_t stream) {
  using S = X3DkvSmem<DH>;
  CUtensorMap maps[4];
  cudaError_t err = qkv_maps(maps, q, k, v, B, L, kX3Queries, kX3Keys, 4);
  // dout is contiguous [B, T, H, Dh]
  const long long row = static_cast<long long>(L.heads) * DH;
  if (err == cudaSuccess && !aligned16(dout)) err = cudaErrorInvalidValue;
  if (err == cudaSuccess)
    err = make_map_f32(&maps[3], dout, Strides{DH, row, row * L.n}, B, L.n, L.heads, DH, kX3Queries);
  if (err == cudaSuccess) err = allow_smem(reinterpret_cast<const void*>(dkv_tf32x3_kernel<DH>), S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L.n + kX3Keys - 1) / kX3Keys, L.heads, B);
  dkv_tf32x3_kernel<DH><<<grid, kWgThreads, S::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], mask, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), L);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int dq_tf32x3(const void* q, const void* k, const void* v, const float* mask, const void* dout, const float* lse,
              const float* delta, void* dq, int B, const Layout& L, cudaStream_t stream) {
  using S = X3DqSmem<DH>;
  CUtensorMap maps[4];
  cudaError_t err = qkv_maps(maps, q, k, v, B, L, kWgBlock, kX3DqKeys, 4);
  // dout is contiguous [B, T, H, Dh]
  const long long row = static_cast<long long>(L.heads) * DH;
  if (err == cudaSuccess && !aligned16(dout)) err = cudaErrorInvalidValue;
  if (err == cudaSuccess)
    err = make_map_f32(&maps[3], dout, Strides{DH, row, row * L.n}, B, L.n, L.heads, DH, kWgBlock);
  if (err == cudaSuccess) err = allow_smem(reinterpret_cast<const void*>(dq_tf32x3_kernel<DH>), S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L.n + kWgBlock - 1) / kWgBlock, L.heads, B);
  dq_tf32x3_kernel<DH><<<grid, kWgThreads, S::kBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], mask, lse,
                                                                 delta, static_cast<float*>(dq), L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int fwd(const void* q, const void* k, const void* v, const float* mask, void* out, float* lse,
        int B, const Layout& L, cudaStream_t stream) {
  const dim3 grid((L.n + kTile - 1) / kTile, L.heads, B);
  if constexpr (use_mma<T, DH>()) {
    cudaError_t err = allow_smem(reinterpret_cast<const void*>(fwd_mma_kernel<DH>), fwd_mma_smem(DH));
    if (err != cudaSuccess) return static_cast<int>(err);
    fwd_mma_kernel<DH><<<grid, kMmaThreads, fwd_mma_smem(DH), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mask, static_cast<bf16*>(out), lse, L);
  } else {
    cudaError_t err = allow_smem(reinterpret_cast<const void*>(fwd_kernel<T, DH>), fwd_smem(DH));
    if (err != cudaSuccess) return static_cast<int>(err);
    fwd_kernel<T, DH><<<grid, kThreads, fwd_smem(DH), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
        static_cast<T*>(out), lse, L);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int dq_launch(const void* q, const void* k, const void* v, const float* mask, const void* dout,
              const float* lse, const float* delta, void* dq, int B, const Layout& L,
              cudaStream_t stream) {
  const dim3 grid((L.n + kTile - 1) / kTile, L.heads, B);
  if constexpr (use_mma<T, DH>()) {
    cudaError_t err = allow_smem(reinterpret_cast<const void*>(dq_mma_kernel<DH>), dq_mma_smem(DH));
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_mma_kernel<DH><<<grid, kMmaThreads, dq_mma_smem(DH), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mask, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), L);
  } else {
    cudaError_t err = allow_smem(reinterpret_cast<const void*>(dq_kernel<T, DH>), dq_smem(DH));
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_kernel<T, DH><<<grid, kThreads, dq_smem(DH), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), L);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int dkv_launch(const void* q, const void* k, const void* v, const float* mask, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int B, const Layout& L,
               cudaStream_t stream) {
  const dim3 grid((L.n + kTile - 1) / kTile, L.heads, B);
  if constexpr (use_mma<T, DH>()) {
    cudaError_t err = allow_smem(reinterpret_cast<const void*>(dkv_mma_kernel<DH>), dkv_mma_smem(DH));
    if (err != cudaSuccess) return static_cast<int>(err);
    dkv_mma_kernel<DH><<<grid, kMmaThreads, dkv_mma_smem(DH), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mask, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), L);
  } else {
    cudaError_t err = allow_smem(reinterpret_cast<const void*>(dkv_kernel<T, DH>), dkv_smem(DH));
    if (err != cudaSuccess) return static_cast<int>(err);
    dkv_kernel<T, DH><<<grid, kThreads, dkv_smem(DH), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), L);
  }
  return static_cast<int>(cudaGetLastError());
}

// the padded head dim a true Dh runs at: 32, 64 or 128 (0 = refused)
int dh_pad(int Dh) { return Dh <= 0 ? 0 : Dh <= 32 ? 32 : Dh <= 64 ? 64 : Dh <= 128 ? 128 : 0; }

// routes, chosen by the caller from the layout (ops/fused_attention.py::
// kernel_route): 0 the FMA kernels (f32; bf16 at Dh 128), 1 the mma.sync
// kernels (bf16 up to Dh 64), 2 the wgmma/TMA kernels (bf16 at Dh 32 or
// 64 on a layout TMA describes), 3 the 3xTF32 wgmma/TMA kernels (f32 at
// Dh 32 or 64 on a layout TMA describes)
constexpr int kRouteFma = 0, kRouteMma = 1, kRouteWgmma = 2, kRouteTf32x3 = 3;

// the route the FMA/mma.sync dispatch below takes for (dtype, Dh)
int plain_route(int dtype, int Dh) { return dtype == 1 && dh_pad(Dh) <= 64 ? kRouteMma : kRouteFma; }

}  // namespace

// dispatch one launcher over dtype (0 = f32, 1 = bf16) and the padded head dim
#define DISPATCH(LAUNCH, ...)                                                   \
  do {                                                                          \
    const int pad = dh_pad(Dh);                                                 \
    if (dtype == 0 && pad == 32) return LAUNCH<float, 32>(__VA_ARGS__);         \
    if (dtype == 0 && pad == 64) return LAUNCH<float, 64>(__VA_ARGS__);         \
    if (dtype == 0 && pad == 128) return LAUNCH<float, 128>(__VA_ARGS__);       \
    if (dtype == 1 && pad == 32) return LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__); \
    if (dtype == 1 && pad == 64) return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__); \
    if (dtype == 1 && pad == 128) return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__); \
    return static_cast<int>(cudaErrorInvalidValue);                             \
  } while (0)

// the wgmma route at Dh 32 or 64 (bf16 only), else refused
#define DISPATCH_WGMMA(LAUNCH, ...)                                      \
  do {                                                                   \
    if (dtype == 1 && Dh == 64) return LAUNCH<64>(__VA_ARGS__);          \
    if (dtype == 1 && Dh == 32) return LAUNCH<32>(__VA_ARGS__);          \
    return static_cast<int>(cudaErrorInvalidValue);                      \
  } while (0)

// the 3xTF32 route at Dh 32 or 64 (f32 only), else refused
#define DISPATCH_TF32X3(LAUNCH, ...)                                     \
  do {                                                                   \
    if (dtype == 0 && Dh == 64) return LAUNCH<64>(__VA_ARGS__);          \
    if (dtype == 0 && Dh == 32) return LAUNCH<32>(__VA_ARGS__);          \
    return static_cast<int>(cudaErrorInvalidValue);                      \
  } while (0)

extern "C" {

// out [B, T, H, Dh] (input dtype), lse [B, H, T] f32
int fused_attention_fwd(int dtype, int route, const void* q, const void* k, const void* v, long long sb,
                        long long st, long long sh, const float* mask, void* out, float* lse,
                        int B, int T, int H, int Dh, float scale, int causal, void* stream) {
  const Layout L = make_layout(sb, st, sh, T, H, Dh, scale, causal, {q, k, v});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteWgmma) DISPATCH_WGMMA(fwd_wgmma, q, k, v, mask, out, lse, B, L, s);
  if (route == kRouteTf32x3) DISPATCH_TF32X3(fwd_tf32x3, q, k, v, mask, out, lse, B, L, s);
  if (route != plain_route(dtype, Dh)) return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH(fwd, q, k, v, mask, out, lse, B, L, s);
}

// dq [B, T, H, Dh] from dout, the forward's lse and delta = rowsum(dout * out) - dlse
int fused_attention_dq(int dtype, int route, const void* q, const void* k, const void* v, long long sb,
                       long long st, long long sh, const float* mask, const void* dout,
                       const float* lse, const float* delta, void* dq, int B, int T, int H,
                       int Dh, float scale, int causal, void* stream) {
  const Layout L = make_layout(sb, st, sh, T, H, Dh, scale, causal, {q, k, v, dout});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteWgmma) DISPATCH_WGMMA(dq_wgmma, q, k, v, mask, dout, lse, delta, dq, B, L, s);
  if (route == kRouteTf32x3) DISPATCH_TF32X3(dq_tf32x3, q, k, v, mask, dout, lse, delta, dq, B, L, s);
  if (route != plain_route(dtype, Dh)) return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH(dq_launch, q, k, v, mask, dout, lse, delta, dq, B, L, s);
}

// dk, dv [B, T, H, Dh]
int fused_attention_dkv(int dtype, int route, const void* q, const void* k, const void* v, long long sb,
                        long long st, long long sh, const float* mask, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int B, int T,
                        int H, int Dh, float scale, int causal, void* stream) {
  const Layout L = make_layout(sb, st, sh, T, H, Dh, scale, causal, {q, k, v, dout});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteWgmma) DISPATCH_WGMMA(dkv_wgmma, q, k, v, mask, dout, lse, delta, dk, dv, B, L, s);
  if (route == kRouteTf32x3) DISPATCH_TF32X3(dkv_tf32x3, q, k, v, mask, dout, lse, delta, dk, dv, B, L, s);
  if (route != plain_route(dtype, Dh)) return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH(dkv_launch, q, k, v, mask, dout, lse, delta, dk, dv, B, L, s);
}

}  // extern "C"
