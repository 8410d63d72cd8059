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
// K6/K9 -> fwd_kernel or fwd_mma_kernel, K7/K10 -> dq_kernel or
// dq_mma_kernel, K8/K11 -> dkv_kernel or dkv_mma_kernel (the path below).
// The TPU's two tiers (one-level, streaming) compute one function and differ
// only in how much of K/V fits VMEM; a block here never holds more than one
// 64-row tile of each operand, so one kernel serves both.
//
// What bounds it on the H100.  At the main path's shape (B = 8, H = 8,
// T = 8192, Dh = 64, bf16) the forward needs 2 products of 2*T*T*Dh flop per
// (batch, head), 1.10e12 flop, against 0.3 GB of operands: bound by
// operations (1.11 ms at 989 TFLOP/s on the tensor cores); dq needs 3
// products, dkv 4.  Two paths compute the same function:
//   * bf16 at Dh <= 64 (the main path) runs fwd_mma_kernel, dq_mma_kernel
//     and dkv_mma_kernel: products on the tensor cores with
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate), 16-byte tile loads,
//     ldmatrix.trans for B operands that need the other orientation.  No
//     cp.async pipeline and no wgmma/TMA yet: those are the next steps;
//   * f32 (whose products must stay exact f32) and Dh 128 (whose tensor-
//     core accumulators would spill) run fwd_kernel, dq_kernel and
//     dkv_kernel: products on the f32 FMA units (67 TFLOP/s peak) with
//     4 x 4 register tiles per thread, as K4/K5 do.
//
// Design (not the TPU's), both paths:
//   * one block per (64-row tile, head, batch): 256 threads (16 x 16) on the
//     FMA path, 4 warps of 16 rows each on the tensor-core path; the walk
//     over the other axis is a loop inside the block (the TPU carries it
//     across grid steps in VMEM scratch);
//   * operands are loaded into shared memory (as f32 on the FMA path, bf16
//     on the tensor-core path), 64 rows x Dh_pad columns, rows padded so the
//     products' operand reads meet no bank conflicts; columns past the true
//     Dh and rows past T read as 0, so no padded copy of q/k/v exists in
//     memory;
//   * the forward makes two passes over the key tiles: the first finds each
//     row's maximum score, the second forms p = exp(s - m) against that
//     global maximum, sums it unrounded into l, rounds p to the input dtype
//     before P.V and divides by l at the end.  That is the one-level TPU
//     kernel's arithmetic exactly (the streaming kernel rounds p against a
//     running maximum instead; in f32 the two agree to rounding);
//   * dq_kernel walks key tiles for one query tile: p = exp(s - lse),
//     ds = p * (dP - delta) rounded to the input dtype, dq += ds K, times the
//     scale at the end; dkv_kernel walks query tiles for one key tile:
//     dv += round(p)^T dO, dk += round(ds)^T Q, times the scale at the end;
//     delta = rowsum(dO * O) - dlse comes in from the caller;
//   * masking follows the TPU kernels: a key is valid when it lies inside T,
//     its mask value is not 0 and (causal) it is not after the query; an
//     invalid score is -1e30 in the max and p = 0 exactly, so a row with no
//     valid key gives output 0 and lse = -1e30 + log(1e-30), never NaN;
//   * under `causal`, key tiles wholly after a query tile (and query tiles
//     wholly before a key tile) are skipped.
//
// C interface (ctypes): dtype 0 = float32, 1 = bfloat16; q, k, v share the
// element strides (sb, st, sh) over batch, token and head, with unit stride
// over Dh; out, dout, dq, dk and dv are contiguous [B, T, H, Dh]; mask is f32
// [B, T] or null; lse and delta are f32 [B, H, T].  Every entry returns
// cudaGetLastError() after its launch; launches are asynchronous on `stream`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

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
// Tensor-core path: bf16 at Dh <= 64 (the main path).  The same three
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

constexpr size_t rows_bytes(int dh) { return sizeof(bf16) * kTile * (dh + 8); }
constexpr size_t fwd_mma_smem(int dh) { return 3 * rows_bytes(dh) + kTile; }
constexpr size_t dq_mma_smem(int dh) { return 4 * rows_bytes(dh) + kTile; }
constexpr size_t dkv_mma_smem(int dh) { return 4 * rows_bytes(dh) + 2 * sizeof(float) * kTile + kTile; }
// the tensor-core kernels serve bf16 up to Dh 64; f32 (exact f32 products)
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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

template <typename T, int DH>
int fwd(const void* q, const void* k, const void* v, const float* mask, void* out, float* lse,
        int B, const Layout& L, cudaStream_t stream) {
  if constexpr (use_mma<T, DH>()) {
    cudaError_t err = allow_smem(fwd_mma_kernel<DH>, fwd_mma_smem(DH));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((L.n + kTile - 1) / kTile, L.heads, B);
    fwd_mma_kernel<DH><<<grid, kMmaThreads, fwd_mma_smem(DH), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mask, static_cast<bf16*>(out), lse, L);
    return static_cast<int>(cudaGetLastError());
  } else {
    cudaError_t err = allow_smem(fwd_kernel<T, DH>, fwd_smem(DH));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((L.n + kTile - 1) / kTile, L.heads, B);
    fwd_kernel<T, DH><<<grid, kThreads, fwd_smem(DH), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
        static_cast<T*>(out), lse, L);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int DH>
int dq_launch(const void* q, const void* k, const void* v, const float* mask, const void* dout,
              const float* lse, const float* delta, void* dq, int B, const Layout& L,
              cudaStream_t stream) {
  if constexpr (use_mma<T, DH>()) {
    cudaError_t err = allow_smem(dq_mma_kernel<DH>, dq_mma_smem(DH));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((L.n + kTile - 1) / kTile, L.heads, B);
    dq_mma_kernel<DH><<<grid, kMmaThreads, dq_mma_smem(DH), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mask, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), L);
    return static_cast<int>(cudaGetLastError());
  } else {
    cudaError_t err = allow_smem(dq_kernel<T, DH>, dq_smem(DH));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((L.n + kTile - 1) / kTile, L.heads, B);
    dq_kernel<T, DH><<<grid, kThreads, dq_smem(DH), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), L);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int DH>
int dkv_launch(const void* q, const void* k, const void* v, const float* mask, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int B, const Layout& L,
               cudaStream_t stream) {
  if constexpr (use_mma<T, DH>()) {
    cudaError_t err = allow_smem(dkv_mma_kernel<DH>, dkv_mma_smem(DH));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((L.n + kTile - 1) / kTile, L.heads, B);
    dkv_mma_kernel<DH><<<grid, kMmaThreads, dkv_mma_smem(DH), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mask, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), L);
    return static_cast<int>(cudaGetLastError());
  } else {
    cudaError_t err = allow_smem(dkv_kernel<T, DH>, dkv_smem(DH));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((L.n + kTile - 1) / kTile, L.heads, B);
    dkv_kernel<T, DH><<<grid, kThreads, dkv_smem(DH), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), L);
    return static_cast<int>(cudaGetLastError());
  }
}

// the padded head dim a true Dh runs at: 32, 64 or 128 (0 = refused)
int dh_pad(int Dh) { return Dh <= 0 ? 0 : Dh <= 32 ? 32 : Dh <= 64 ? 64 : Dh <= 128 ? 128 : 0; }

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

extern "C" {

// out [B, T, H, Dh] (input dtype), lse [B, H, T] f32
int fused_attention_fwd(int dtype, const void* q, const void* k, const void* v, long long sb,
                        long long st, long long sh, const float* mask, void* out, float* lse,
                        int B, int T, int H, int Dh, float scale, int causal, void* stream) {
  const Layout L = make_layout(sb, st, sh, T, H, Dh, scale, causal, {q, k, v});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(fwd, q, k, v, mask, out, lse, B, L, s);
}

// dq [B, T, H, Dh] from dout, the forward's lse and delta = rowsum(dout * out) - dlse
int fused_attention_dq(int dtype, const void* q, const void* k, const void* v, long long sb,
                       long long st, long long sh, const float* mask, const void* dout,
                       const float* lse, const float* delta, void* dq, int B, int T, int H,
                       int Dh, float scale, int causal, void* stream) {
  const Layout L = make_layout(sb, st, sh, T, H, Dh, scale, causal, {q, k, v, dout});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dq_launch, q, k, v, mask, dout, lse, delta, dq, B, L, s);
}

// dk, dv [B, T, H, Dh]
int fused_attention_dkv(int dtype, const void* q, const void* k, const void* v, long long sb,
                        long long st, long long sh, const float* mask, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int B, int T,
                        int H, int Dh, float scale, int causal, void* stream) {
  const Layout L = make_layout(sb, st, sh, T, H, Dh, scale, causal, {q, k, v, dout});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dkv_launch, q, k, v, mask, dout, lse, delta, dk, dv, B, L, s);
}

}  // extern "C"
