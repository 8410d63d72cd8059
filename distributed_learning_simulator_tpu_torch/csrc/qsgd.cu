// qsgd: the QSGD transport codec, encode (K2) and decode (K3).
//
// Replaces: distributed_learning_simulator_tpu/ops/pallas_kernels.py
//   qsgd_encode (:107-143) with _qsgd_quantize_and_pack (:66) and _pack
//   (:53), and qsgd_decode (:166-181) with _qsgd_decode_kernel (:147).
//
// Layout (the TPU kernels'): a flat f32 leaf of n values is read as a
// zero-padded [rows, 128] matrix, rows a multiple of lcm(32 / bits, 32).
// With `bits` bits (1 to 24) per level, lanes = 32 / bits consecutive ROWS of one 128-lane column
// share a u32 word (value of row g*lanes + j at shift j*bits), so the
// levels are [rows / lanes, 128] words; signs pack 32 rows a word,
// [rows / 32, 128].  The scale is max(max|x|, 1e-12), one f32.
//
// Arithmetic (the reference's, in the order XLA evaluates it; every
// product, quotient and difference rounds on its own: the __f*_rn
// intrinsics keep nvcc from contracting them into FMAs, and the build has
// no fast-math):
//   normalized = |x| / scale * level;  f = floor(normalized)
//   u = (bits >> 8) * 2^-24;  q = f + (u < normalized - f)
//   decode: (q * step) * (1 - 2 * sign),  step = scale * fl(1 / level)
//   (XLA turns the reference's q / level * scale into a product with the
//   f32 reciprocal of the constant, folded into the scalar scale first)
//
// Bound on the H100: memory.  Encode reads n f32 values twice (the abs-max
// pass, then the quantize pass: 8 bytes a value) and writes bits/8 + 1/8
// bytes a value; decode reads those and writes 4 bytes a value.  Both do a
// few operations a byte, far below the card's ridge.  The design:
//   * the TPU kernel holds the whole leaf in VMEM and reduces max|x| in
//     one pass; blocks of the card cannot see each other, so the abs-max
//     is its own kernel: a grid-stride max per thread, a warp and block
//     max, then one atomicMax on the float's bits per block (the values
//     are non-negative, so their bit patterns order as unsigned ints);
//   * the quantize kernel runs one block per group of lcm(lanes, 32) rows
//     (32 rows where lanes divides 32; 96 or 160 for 3, 5, 6, 9 and 10 bits):
//     thread (l, s) builds the level words of its word rows in column l,
//     reading rows g*lanes .. g*lanes + lanes - 1, so a warp reads 32
//     neighbouring floats of one row per step (coalesced 128-byte loads);
//     the sign bits of the group meet in shared memory (atomicOr) and one
//     thread a column writes each sign word;
//   * random bits come from a `rand_bits` input ([rows, 128] u32, the
//     TPU interpreter's contract) or from Philox4x32-10 drawn in the
//     kernel with counter = element index and key = seed; qsgd_philox_fill
//     writes the same stream, so the two entries can be held bit for bit;
//   * decode: one thread per output element, the output cut to n.
//
// C interface (ctypes): every entry returns cudaGetLastError() after its
// launches.  All pointers are device pointers; launches are asynchronous
// on `stream`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kMaxBits = 24;
constexpr int kMaxSignRows = 5;  // lcm(32 / bits, 32) / 32 is at most 5 (3 or 6 bits)

// Philox4x32-10 (Salmon et al., SC'11), counter (lo, hi, 0, 0) of the
// element index, key (seed, 0); returns the first output word.
__device__ __forceinline__ uint32_t philox_bits(uint64_t index, uint32_t seed) {
  uint32_t c0 = static_cast<uint32_t>(index), c1 = static_cast<uint32_t>(index >> 32);
  uint32_t c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n1 = lo1, n2 = hi0 ^ c3 ^ k1, n3 = lo0;
    c0 = n0; c1 = n1; c2 = n2; c3 = n3;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

__global__ void absmax_kernel(const float* __restrict__ x, int64_t n, uint32_t* amax_bits) {
  float m = 0.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride)
    m = fmaxf(m, fabsf(__ldg(x + i)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (blockDim.x + 31) / 32 ? warp_max[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(amax_bits, __float_as_uint(m));
  }
}

// One block per group of `group_rows` = lcm(lanes, 32) rows: `word_rows`
// = group_rows / lanes level-word rows and `sign_rows` = group_rows / 32
// sign-word rows (at most 5, for 3 or 6 bits).  blockDim (128, y),
// y = min(word_rows, 8); thread (l, s) builds the level words of rows
// s, s + y, ... of the group in column l.  kHostBits: read rand_bits, else
// draw Philox bits in the kernel.
template <bool kHostBits>
__global__ void encode_kernel(const float* __restrict__ x, int64_t n,
                              const uint32_t* __restrict__ amax_bits,
                              const uint32_t* __restrict__ rand_bits, uint32_t seed, int level,
                              int bits, int word_rows, int sign_rows,
                              uint32_t* __restrict__ packed, uint32_t* __restrict__ signs) {
  __shared__ uint32_t sign_part[kMaxSignRows][kLane];
  const int l = threadIdx.x, s = threadIdx.y;
  const int lanes = 32 / bits;
  const int64_t group = blockIdx.x;
  for (int t = s; t < sign_rows; t += blockDim.y) sign_part[t][l] = 0u;
  __syncthreads();
  const float scale = fmaxf(__uint_as_float(__ldg(amax_bits)), 1e-12f);
  const float flevel = static_cast<float>(level);
  for (int w = s; w < word_rows; w += blockDim.y) {
    const int64_t word_row = group * word_rows + w;
    uint32_t word = 0u;
    for (int j = 0; j < lanes; ++j) {
      const int64_t idx = (word_row * lanes + j) * kLane + l;
      const float v = idx < n ? __ldg(x + idx) : 0.f;
      const float normalized = __fmul_rn(__fdiv_rn(fabsf(v), scale), flevel);
      const float f = floorf(normalized);
      const uint32_t r = kHostBits ? __ldg(rand_bits + idx) : philox_bits(static_cast<uint64_t>(idx), seed);
      const float u = __fmul_rn(static_cast<float>(static_cast<int32_t>(r >> 8)), 1.0f / 16777216.0f);
      const float q = f + (u < __fsub_rn(normalized, f) ? 1.0f : 0.0f);
      word |= static_cast<uint32_t>(static_cast<int32_t>(q)) << (j * bits);
      if (v < 0.f) {
        const int local = w * lanes + j;  // row within the group
        atomicOr(&sign_part[local / 32][l], 1u << (local % 32));
      }
    }
    packed[word_row * kLane + l] = word;
  }
  __syncthreads();
  for (int t = s; t < sign_rows; t += blockDim.y)
    signs[(group * sign_rows + t) * kLane + l] = sign_part[t][l];
}

__global__ void decode_kernel(const uint32_t* __restrict__ packed,
                              const uint32_t* __restrict__ signs,
                              const float* __restrict__ scale, int level, int bits, int64_t n,
                              float* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int lanes = 32 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  const float step = __fmul_rn(__ldg(scale), __fdiv_rn(1.0f, static_cast<float>(level)));
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; idx < n;
       idx += stride) {
    const int64_t row = idx / kLane, l = idx % kLane;
    const uint32_t word = __ldg(packed + (row / lanes) * kLane + l);
    const uint32_t q = (word >> ((row % lanes) * bits)) & mask;
    const uint32_t sign = (__ldg(signs + (row / 32) * kLane + l) >> (row % 32)) & 1u;
    const float magnitude = __fmul_rn(static_cast<float>(static_cast<int32_t>(q)), step);
    out[idx] = __fmul_rn(magnitude, sign ? -1.0f : 1.0f);
  }
}

__global__ void philox_fill_kernel(int64_t count, uint32_t seed, uint32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += stride)
    out[i] = philox_bits(static_cast<uint64_t>(i), seed);
}

// 1 to 24 bits: levels up to 2^24 - 1, the integers f32 holds exactly
bool bits_supported(int bits) { return bits >= 1 && bits <= kMaxBits; }

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

int grid_for(int64_t items, int threads) {
  int64_t blocks = (items + threads - 1) / threads;
  const int64_t cap = 132 * 8;
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

int encode(const float* x, int64_t n, int64_t rows, const uint32_t* rand_bits, uint32_t seed,
           int level, int bits, uint32_t* amax_bits, uint32_t* packed, uint32_t* signs,
           cudaStream_t stream) {
  if (!bits_supported(bits)) return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = 32 / bits;
  const int group_rows = lanes / gcd(lanes, 32) * 32;  // lcm(lanes, 32)
  if (rows % group_rows != 0 || rows * kLane < n) return static_cast<int>(cudaErrorInvalidValue);
  // amax_bits must hold 0 (the wrapper passes a zeroed word)
  absmax_kernel<<<grid_for(n, 256), 256, 0, stream>>>(x, n, amax_bits);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int word_rows = group_rows / lanes, sign_rows = group_rows / 32;
  const dim3 block(kLane, word_rows < 8 ? word_rows : 8);
  const unsigned grid = static_cast<unsigned>(rows / group_rows);
  if (rand_bits != nullptr)
    encode_kernel<true><<<grid, block, 0, stream>>>(x, n, amax_bits, rand_bits, seed, level, bits,
                                                    word_rows, sign_rows, packed, signs);
  else
    encode_kernel<false><<<grid, block, 0, stream>>>(x, n, amax_bits, nullptr, seed, level, bits,
                                                     word_rows, sign_rows, packed, signs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K2 with Philox bits drawn in the kernel.  x: [n] f32; packed:
// [rows / (32 / bits), 128] u32; signs: [rows / 32, 128] u32; amax_bits:
// one zeroed u32 word, left holding max|x|'s bits (the scale is
// max(that, 1e-12)).
int qsgd_encode(const float* x, int64_t n, int64_t rows, uint32_t seed, int level, int bits,
                uint32_t* amax_bits, uint32_t* packed, uint32_t* signs, void* stream) {
  return encode(x, n, rows, nullptr, seed, level, bits, amax_bits, packed, signs,
                static_cast<cudaStream_t>(stream));
}

// K2 with its random bits given: rand_bits is [rows, 128] u32.
int qsgd_encode_with_bits(const float* x, int64_t n, int64_t rows, const uint32_t* rand_bits,
                          int level, int bits, uint32_t* amax_bits, uint32_t* packed,
                          uint32_t* signs, void* stream) {
  if (rand_bits == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return encode(x, n, rows, rand_bits, 0u, level, bits, amax_bits, packed, signs,
                static_cast<cudaStream_t>(stream));
}

// K3: out [n] f32 from K2's packed levels, signs and scale ([1] f32).
int qsgd_decode(const uint32_t* packed, const uint32_t* signs, const float* scale, int level,
                int bits, int64_t n, float* out, void* stream) {
  if (!bits_supported(bits)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0)
    decode_kernel<<<grid_for(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        packed, signs, scale, level, bits, n, out);
  return static_cast<int>(cudaGetLastError());
}

// The Philox stream qsgd_encode draws: out[i] = bits of element i, i < count.
int qsgd_philox_fill(int64_t count, uint32_t seed, uint32_t* out, void* stream) {
  philox_fill_kernel<<<grid_for(count, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      count, seed, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
