// qsgd: the QSGD transport codec, encode (K2) and decode (K3).
//
// Replaces: distributed_learning_simulator_tpu/ops/pallas_kernels.py
//   qsgd_encode (:108-143) with _qsgd_quantize_and_pack (:66) and _pack
//   (:53), and qsgd_decode (:167-181) with _qsgd_decode_kernel (:147).
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
// Bound on the H100.  Encode reads n f32 values twice (the abs-max pass,
// then the quantize pass: 8 bytes a value) and writes bits/8 + 1/8 bytes a
// value; decode reads those (at 8 bits 1 + 1/8 bytes a value) and writes 4
// bytes a value, so the bytes bound it.  Both do a few f32 operations a
// byte, far below the card's ridge.  The encode's random bits
// are integer work besides: Philox4x32-10 is about 100 integer
// instructions a call (10 rounds of 2 mul.hi, 2 mul.lo, xors and key
// additions), and one call makes four 32-bit words.  The design:
//   * the TPU kernel holds the whole leaf in VMEM and reduces max|x| in
//     one pass; blocks of the card cannot see each other, so the abs-max
//     is its own kernel, which writes one partial maximum a block; every
//     quantize block reduces those partials itself (a few hundred floats,
//     read from L2) and block 0 writes the scale, so no buffer needs
//     zeroing first and the scale needs no pass of its own;
//   * the quantize kernel runs one block per group of lcm(lanes, 32) rows
//     (32 rows where lanes divides 32; 96 or 160 for 3, 5, 6, 9 and 10 bits):
//     thread (l, s) builds level words of the group in column l, each
//     from rows g*lanes .. g*lanes + lanes - 1, so a warp reads 32
//     neighbouring floats of one row per step (coalesced 128-byte loads);
//     a thread takes about 16 values (EncodeShape) and loads them all
//     before it computes, so that its loads are in flight together and a
//     leaf's blocks fit the card at once;
//     a thread gathers its word's sign bits in a register and ORs them
//     into the group's sign words in shared memory once (twice where the
//     word's rows straddle two sign words: 3, 5, 6, 9 and 10 bits), and
//     one thread a column writes each sign word;
//   * random bits come from a `rand_bits` input ([rows, 128] u32, the
//     TPU interpreter's contract) or from Philox4x32-10 drawn in the
//     kernel, key (seed, 0): element (row, column) takes word row % 4 of
//     the call whose counter is (row / 4) * 128 + column, so at 8 bits (4
//     rows a level word, the main path) one call serves one thread's word
//     and every word of it is used; the stream is a function of (seed,
//     element index) alone, and qsgd_philox_fill writes the same stream,
//     so the two entries can be held bit for bit;
//   * decode walks packed words, not values: a thread takes the level
//     words of 4 neighbouring columns of one word-row (of 4 / lanes
//     word-rows at 24 to 11 bits, so a thread has at least 16 values) in
//     one 16-byte load each, and the matching sign words in one (two
//     where a word's rows straddle two sign words: 3, 5, 6, 9 and 10
//     bits), starts every load before it unpacks, and writes each of its
//     rows as one 16-byte store of 4 neighbouring columns (a warp's store
//     is 512 contiguous bytes of a row; scalar stores past n on the
//     ragged last row).  Its index arithmetic is 32-bit on word-rows, one
//     product by lanes a thread: lanes is a template parameter wherever
//     it divides 32 (1, 2, 4, 7, 8 and 11 to 24 bits), and one generic
//     instantiation takes lanes 3, 5, 6 and 10 at run time; the field
//     width stays a run-time shift.  The step is computed once a thread,
//     and the grid covers the leaf (no thread loops).
// The designs these replaced stay below for chip_smoke.py to time beside
// them: qsgd_encode_per_value (a Philox call for every value, keeping
// one of its four words; an atomicOr for every negative value; the
// abs-max as an atomicMax into a word the caller zeroed) and
// qsgd_decode_per_value (a thread per value, a 64-bit division and
// remainder by a run-time lanes for each, the grid capped at 1056
// blocks).
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
constexpr int kAbsmaxThreads = 256;
constexpr int kDecodeThreads = 128;  // 4 warps: a decode unit each
constexpr int kMaxGenericLanes = 10;  // 3 bits

// Philox4x32-10 (Salmon et al., SC'11) of counter (lo, hi, 0, 0) of
// `counter`, key (seed, 0): its four output words
__device__ __forceinline__ uint4 philox4(uint64_t counter, uint32_t seed) {
  uint32_t c0 = static_cast<uint32_t>(counter), c1 = static_cast<uint32_t>(counter >> 32);
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
  return make_uint4(c0, c1, c2, c3);
}

// word w (0 to 3) of a Philox call
__device__ __forceinline__ uint32_t philox_word(const uint4& d, int w) {
  return w == 0 ? d.x : w == 1 ? d.y : w == 2 ? d.z : d.w;
}

// the max of v over the block (every warp whole; at most 32 warps)
__device__ __forceinline__ float block_max(float v, float* warp_max) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  v = lane < (blockDim.x * blockDim.y + 31) / 32 ? warp_max[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// partials[block] = max |x| over the block's grid-stride share, read as
// 16-byte vectors where x is 16-byte aligned
__global__ void absmax_kernel(const float* __restrict__ x, int64_t n, float* __restrict__ partials) {
  __shared__ float warp_max[32];
  float m = 0.f;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t vectors = reinterpret_cast<uintptr_t>(x) % 16 == 0 ? n / 4 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
  for (int64_t i = first; i < vectors; i += stride) {
    const float4 v = __ldg(x4 + i);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  for (int64_t i = 4 * vectors + first; i < n; i += stride) m = fmaxf(m, fabsf(__ldg(x + i)));
  m = block_max(m, warp_max);
  if (threadIdx.x == 0) partials[blockIdx.x] = m;
}

constexpr int gcd_c(int a, int b) { return b == 0 ? a : gcd_c(b, a % b); }
constexpr int pow2_floor(int v) { return v < 2 ? 1 : 2 * pow2_floor(v / 2); }

// The quantize kernel's shape for LANES values a level word: a block per
// group of kGroupRows = lcm(LANES, 32) rows, kWordRows level-word rows and
// kSignRows sign-word rows of it (at most 5, for 3 or 6 bits); blockDim
// (128, kY), and thread (l, s) builds the kWords level words of rows s,
// s + kY, ... of the group in column l: about 16 values a thread (at 8
// bits 4 words, 256 threads a block), so a thread's loads are all in
// flight at once and every block of a leaf fits the card at once.
template <int LANES>
struct EncodeShape {
  static constexpr int kGroupRows = LANES / gcd_c(LANES, 32) * 32;
  static constexpr int kWordRows = kGroupRows / LANES;
  static constexpr int kSignRows = kGroupRows / 32;
  static constexpr int kWant = pow2_floor(16 / LANES) < kWordRows ? pow2_floor(16 / LANES) : kWordRows;
  static constexpr int kWords = kWordRows / kWant > 8 ? kWordRows / 8 : kWant;  // kY at most 8
  static constexpr int kY = kWordRows / kWords;
  static_assert(kSignRows <= kMaxSignRows && kY * kWords == kWordRows, "encode shape");
};

// kHostBits: read rand_bits, else draw Philox bits in the kernel.  The
// scale comes from the abs-max kernel's `nparts` partial maxima; block 0
// writes it to `scale_out`.  A thread's values (and given bits) are loaded
// before the block reduces the partials, so the reads overlap.
template <int LANES, bool kHostBits>
__global__ void __launch_bounds__(kLane * EncodeShape<LANES>::kY)
    encode_kernel(const float* __restrict__ x, int64_t n, const float* __restrict__ partials, int nparts,
                  const uint32_t* __restrict__ rand_bits, uint32_t seed, int level, int bits,
                  uint32_t* __restrict__ packed, uint32_t* __restrict__ signs, float* __restrict__ scale_out) {
  using E = EncodeShape<LANES>;
  __shared__ uint32_t sign_part[E::kSignRows][kLane];
  __shared__ float warp_max[32];
  const int l = threadIdx.x, s = threadIdx.y;
  const int64_t group = blockIdx.x;
  for (int t = s; t < E::kSignRows; t += E::kY) sign_part[t][l] = 0u;
  float vals[E::kWords][LANES];
  uint32_t given[kHostBits ? E::kWords : 1][LANES];
#pragma unroll
  for (int k = 0; k < E::kWords; ++k)
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
      const int64_t idx = ((group * E::kWordRows + s + E::kY * k) * LANES + j) * kLane + l;
      vals[k][j] = idx < n ? __ldg(x + idx) : 0.f;
      if constexpr (kHostBits) given[k][j] = __ldg(rand_bits + idx);
    }
  float m = 0.f;
  for (int i = s * kLane + l; i < nparts; i += kLane * E::kY) m = fmaxf(m, __ldg(partials + i));
  // (block_max's barrier also orders the zeroing above before the ORs below)
  const float scale = fmaxf(block_max(m, warp_max), 1e-12f);
  if (group == 0 && l == 0 && s == 0) *scale_out = scale;
  const float flevel = static_cast<float>(level);
#pragma unroll
  for (int k = 0; k < E::kWords; ++k) {
    const int w = s + E::kY * k;
    const int64_t word_row = group * E::kWordRows + w;
    uint32_t word = 0u, neg = 0u;
    uint4 draw = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
      const int64_t row = word_row * LANES + j;
      const float v = vals[k][j];
      const float normalized = __fmul_rn(__fdiv_rn(fabsf(v), scale), flevel);
      const float f = floorf(normalized);
      uint32_t r;
      if constexpr (kHostBits) {
        r = given[k][j];
      } else {
        if (j == 0 || (row & 3) == 0) draw = philox4(static_cast<uint64_t>(row >> 2) * kLane + l, seed);
        r = philox_word(draw, static_cast<int>(row & 3));
      }
      const float u = __fmul_rn(static_cast<float>(static_cast<int32_t>(r >> 8)), 1.0f / 16777216.0f);
      const float q = f + (u < __fsub_rn(normalized, f) ? 1.0f : 0.0f);
      word |= static_cast<uint32_t>(static_cast<int32_t>(q)) << (j * bits);
      neg |= static_cast<uint32_t>(v < 0.f) << j;
    }
    packed[word_row * kLane + l] = word;
    if (neg != 0u) {  // the word's rows of the group: w * LANES .. + LANES - 1
      const int local = w * LANES;
      const uint64_t at = static_cast<uint64_t>(neg) << (local % 32);
      atomicOr(&sign_part[local / 32][l], static_cast<uint32_t>(at));
      if (at >> 32) atomicOr(&sign_part[local / 32 + 1][l], static_cast<uint32_t>(at >> 32));
    }
  }
  __syncthreads();
  for (int t = s; t < E::kSignRows; t += E::kY)
    signs[(group * E::kSignRows + t) * kLane + l] = sign_part[t][l];
}

// K3's shape for LANES values a level word (0: 3, 5, 6 or 10, given at
// run time): a thread decodes kWords consecutive word-rows of 4
// neighbouring columns, kRows rows a word unrolled
template <int LANES>
struct DecodeShape {
  static constexpr int kWords = LANES == 1 || LANES == 2 ? 4 / LANES : 1;
  static constexpr int kRows = LANES == 0 ? kMaxGenericLanes : LANES;
};

// value (q * step) * (+-1) of the field at `shift` of `word`, signed by bit
// `bit` of `sign_word`
__device__ __forceinline__ float decode_value(uint32_t word, uint32_t sign_word, int shift, int bit, uint32_t mask,
                                              float step) {
  const uint32_t q = (word >> shift) & mask;
  const float magnitude = __fmul_rn(static_cast<float>(static_cast<int32_t>(q)), step);
  return __fmul_rn(magnitude, (sign_word >> bit) & 1u ? -1.0f : 1.0f);
}

// a unit is kWords word-rows x 128 columns, one warp: thread c4 takes
// columns 4 c4 .. 4 c4 + 3.  packed, signs and out are 16-byte aligned.
template <int LANES>
__global__ void __launch_bounds__(kDecodeThreads)
    decode_word_kernel(const uint4* __restrict__ packed, const uint4* __restrict__ signs,
                       const float* __restrict__ scale, int level, int bits, int generic_lanes, uint32_t units,
                       int64_t n, float* __restrict__ out) {
  using D = DecodeShape<LANES>;
  const uint32_t lanes = LANES == 0 ? static_cast<uint32_t>(generic_lanes) : LANES;
  const uint32_t t = blockIdx.x * kDecodeThreads + threadIdx.x;
  const uint32_t unit = t >> 5, c4 = t & 31u;
  if (unit >= units) return;
  const uint32_t w0 = unit * D::kWords, row0 = w0 * lanes, s0 = row0 >> 5;
  uint4 word[D::kWords];
#pragma unroll
  for (int k = 0; k < D::kWords; ++k) word[k] = __ldg(packed + (w0 + k) * 32u + c4);
  const uint4 sign0 = __ldg(signs + s0 * 32u + c4);
  const uint4 sign1 =
      LANES == 0 && ((row0 + lanes - 1) >> 5) != s0 ? __ldg(signs + (s0 + 1) * 32u + c4) : sign0;
  const float step = __fmul_rn(__ldg(scale), __fdiv_rn(1.0f, static_cast<float>(level)));
  const uint32_t mask = (1u << bits) - 1u;
#pragma unroll
  for (int k = 0; k < D::kWords; ++k)
#pragma unroll
    for (int j = 0; j < D::kRows; ++j) {
      if (LANES == 0 && j >= static_cast<int>(lanes)) break;
      const uint32_t row = row0 + k * lanes + j;
      const int b = static_cast<int>(row - (s0 << 5));  // the row's bit in sign0 (past 31: sign1)
      const uint4 sw = LANES != 0 || b < 32 ? sign0 : sign1;
      const int shift = j * bits, bit = b & 31;
      const float4 v = make_float4(decode_value(word[k].x, sw.x, shift, bit, mask, step),
                                   decode_value(word[k].y, sw.y, shift, bit, mask, step),
                                   decode_value(word[k].z, sw.z, shift, bit, mask, step),
                                   decode_value(word[k].w, sw.w, shift, bit, mask, step));
      const int64_t at = static_cast<int64_t>(row) * kLane + 4 * c4;
      if (at + 4 <= n) {
        *reinterpret_cast<float4*>(out + at) = v;
      } else {  // the ragged last row
        if (at < n) out[at] = v.x;
        if (at + 1 < n) out[at + 1] = v.y;
        if (at + 2 < n) out[at + 2] = v.z;
      }
    }
}

// ------------------------------------------- the replaced decode design
// A thread per value, its word-row and field from a 64-bit division and
// remainder by the run-time lanes.  Reached only from chip_smoke.py,
// which times it beside decode_word_kernel.
__global__ void decode_per_value_kernel(const uint32_t* __restrict__ packed,
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

// the stream encode_kernel draws, for elements below `count`: a thread per
// Philox call writes its four words to elements (4 g + w) * 128 + column
__global__ void philox_fill_kernel(int64_t count, uint32_t seed, uint32_t* __restrict__ out) {
  const int64_t calls = (count + 4 * kLane - 1) / (4 * kLane) * kLane;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; c < calls; c += stride) {
    const uint4 d = philox4(static_cast<uint64_t>(c), seed);
    const int64_t first = (c / kLane) * 4 * kLane + c % kLane;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      if (first + w * kLane < count) out[first + w * kLane] = philox_word(d, w);
  }
}

// ------------------------------------------- the replaced encode design
// A Philox call for every value (counter = the element index, its first
// word kept), an atomicOr for every negative value, and max|x| as an
// atomicMax on the float's bits into a word the caller zeroed (the
// values are non-negative, so their bit patterns order as unsigned ints).
// Reached only from chip_smoke.py, which times it beside the kernels above.
__global__ void absmax_atomic_kernel(const float* __restrict__ x, int64_t n, uint32_t* amax_bits) {
  __shared__ float warp_max[32];
  float m = 0.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride)
    m = fmaxf(m, fabsf(__ldg(x + i)));
  m = block_max(m, warp_max);
  if (threadIdx.x == 0) atomicMax(amax_bits, __float_as_uint(m));
}

__global__ void encode_per_value_kernel(const float* __restrict__ x, int64_t n,
                                        const uint32_t* __restrict__ amax_bits, uint32_t seed, int level,
                                        int bits, int word_rows, int sign_rows, uint32_t* __restrict__ packed,
                                        uint32_t* __restrict__ signs) {
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
      const uint32_t r = philox4(static_cast<uint64_t>(idx), seed).x;
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

// 1 to 24 bits: levels up to 2^24 - 1, the integers f32 holds exactly
bool bits_supported(int bits) { return bits >= 1 && bits <= kMaxBits; }

int grid_for(int64_t items, int threads) {
  int64_t blocks = (items + threads - 1) / threads;
  const int64_t cap = 132 * 8;
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

// the quantize launch of `lanes` (32 / bits) values a level word over
// `rows` rows (a multiple of the group)
template <bool kHostBits>
void launch_encode(int lanes, int64_t rows, cudaStream_t stream, const float* x, int64_t n, const float* partials,
                   int nparts, const uint32_t* rand_bits, uint32_t seed, int level, int bits, uint32_t* packed,
                   uint32_t* signs, float* scale) {
#define QSGD_ENCODE(L)                                                                                      \
  case L:                                                                                                   \
    encode_kernel<L, kHostBits>                                                                             \
        <<<static_cast<unsigned>(rows / EncodeShape<L>::kGroupRows), dim3(kLane, EncodeShape<L>::kY), 0,    \
           stream>>>(x, n, partials, nparts, rand_bits, seed, level, bits, packed, signs, scale);            \
    break;
  switch (lanes) {
    QSGD_ENCODE(1)
    QSGD_ENCODE(2)
    QSGD_ENCODE(3)
    QSGD_ENCODE(4)
    QSGD_ENCODE(5)
    QSGD_ENCODE(6)
    QSGD_ENCODE(8)
    QSGD_ENCODE(10)
    QSGD_ENCODE(16)
    QSGD_ENCODE(32)
  }
#undef QSGD_ENCODE
}

// rows of the padded matrix must be a multiple of lcm(lanes, 32)
bool rows_fit(int64_t rows, int64_t n, int bits) {
  const int lanes = 32 / bits;
  return rows % (lanes / gcd_c(lanes, 32) * 32) == 0 && rows * kLane >= n;
}

// the decode launch over the units that hold the first n values; the
// caller has checked the layout (rows_fit, decode_fits)
template <int LANES>
void launch_decode(int lanes, const uint32_t* packed, const uint32_t* signs, const float* scale, int level, int bits,
                   int64_t n, float* out, cudaStream_t stream) {
  const int64_t unit_rows = DecodeShape<LANES>::kWords * static_cast<int64_t>(lanes);
  const int64_t units = ((n + kLane - 1) / kLane + unit_rows - 1) / unit_rows;
  const int64_t blocks = (units * 32 + kDecodeThreads - 1) / kDecodeThreads;
  decode_word_kernel<LANES><<<static_cast<unsigned>(blocks), kDecodeThreads, 0, stream>>>(
      reinterpret_cast<const uint4*>(packed), reinterpret_cast<const uint4*>(signs), scale, level, bits, lanes,
      static_cast<uint32_t>(units), n, out);
}

// the decode's 32-bit word indices describe the leaf, and its 16-byte
// loads and stores are aligned
bool decode_fits(const void* packed, const void* signs, const float* out, int64_t rows, int bits) {
  const bool aligned = reinterpret_cast<uintptr_t>(packed) % 16 == 0 && reinterpret_cast<uintptr_t>(signs) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return aligned && rows / (32 / bits) * kLane <= UINT32_MAX;
}

int encode(const float* x, int64_t n, int64_t rows, const uint32_t* rand_bits, uint32_t seed, int level,
           int bits, float* partials, uint32_t* packed, uint32_t* signs, float* scale, cudaStream_t stream) {
  if (!bits_supported(bits) || !rows_fit(rows, n, bits)) return static_cast<int>(cudaErrorInvalidValue);
  const int nparts = grid_for(n, kAbsmaxThreads);
  absmax_kernel<<<nparts, kAbsmaxThreads, 0, stream>>>(x, n, partials);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (rand_bits != nullptr)
    launch_encode<true>(32 / bits, rows, stream, x, n, partials, nparts, rand_bits, seed, level, bits, packed,
                        signs, scale);
  else
    launch_encode<false>(32 / bits, rows, stream, x, n, partials, nparts, nullptr, seed, level, bits, packed,
                         signs, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The f32 scratch the encode entries need: one partial maximum a block of
// the abs-max kernel.
int qsgd_partials(int64_t n) { return grid_for(n, kAbsmaxThreads); }

// K2 with Philox bits drawn in the kernel.  x: [n] f32; packed:
// [rows / (32 / bits), 128] u32; signs: [rows / 32, 128] u32; scale: [1]
// f32, max(max|x|, 1e-12); partials: qsgd_partials(n) f32 of scratch.
int qsgd_encode(const float* x, int64_t n, int64_t rows, uint32_t seed, int level, int bits, float* partials,
                uint32_t* packed, uint32_t* signs, float* scale, void* stream) {
  return encode(x, n, rows, nullptr, seed, level, bits, partials, packed, signs, scale,
                static_cast<cudaStream_t>(stream));
}

// K2 with its random bits given: rand_bits is [rows, 128] u32.
int qsgd_encode_with_bits(const float* x, int64_t n, int64_t rows, const uint32_t* rand_bits, int level,
                          int bits, float* partials, uint32_t* packed, uint32_t* signs, float* scale,
                          void* stream) {
  if (rand_bits == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return encode(x, n, rows, rand_bits, 0u, level, bits, partials, packed, signs, scale,
                static_cast<cudaStream_t>(stream));
}

// The replaced K2 design (chip_smoke.py's yardstick): amax_bits is one
// zeroed u32 word, left holding max|x|'s bits; its stream is not
// qsgd_philox_fill's.
int qsgd_encode_per_value(const float* x, int64_t n, int64_t rows, uint32_t seed, int level, int bits,
                          uint32_t* amax_bits, uint32_t* packed, uint32_t* signs, void* stream) {
  if (!bits_supported(bits) || !rows_fit(rows, n, bits)) return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = 32 / bits, group_rows = lanes / gcd_c(lanes, 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  absmax_atomic_kernel<<<grid_for(n, kAbsmaxThreads), kAbsmaxThreads, 0, s>>>(x, n, amax_bits);
  const int word_rows = group_rows / lanes, sign_rows = group_rows / 32;
  const dim3 block(kLane, word_rows < 8 ? word_rows : 8);
  encode_per_value_kernel<<<static_cast<unsigned>(rows / group_rows), block, 0, s>>>(
      x, n, amax_bits, seed, level, bits, word_rows, sign_rows, packed, signs);
  return static_cast<int>(cudaGetLastError());
}

// K3: out [n] f32 from K2's packed levels ([rows / (32 / bits), 128]
// u32), signs ([rows / 32, 128] u32) and scale ([1] f32); packed, signs
// and out 16-byte aligned.
int qsgd_decode(const uint32_t* packed, const uint32_t* signs, const float* scale, int level, int bits, int64_t rows,
                int64_t n, float* out, void* stream) {
  if (!bits_supported(bits) || !rows_fit(rows, n, bits) || !decode_fits(packed, signs, out, rows, bits))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int lanes = 32 / bits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 32: launch_decode<32>(lanes, packed, signs, scale, level, bits, n, out, s); break;
    case 16: launch_decode<16>(lanes, packed, signs, scale, level, bits, n, out, s); break;
    case 8: launch_decode<8>(lanes, packed, signs, scale, level, bits, n, out, s); break;
    case 4: launch_decode<4>(lanes, packed, signs, scale, level, bits, n, out, s); break;
    case 2: launch_decode<2>(lanes, packed, signs, scale, level, bits, n, out, s); break;
    case 1: launch_decode<1>(lanes, packed, signs, scale, level, bits, n, out, s); break;
    default: launch_decode<0>(lanes, packed, signs, scale, level, bits, n, out, s);  // 10, 6, 5, 3
  }
  return static_cast<int>(cudaGetLastError());
}

// The replaced K3 design (chip_smoke.py's yardstick): the same function,
// a thread per value.
int qsgd_decode_per_value(const uint32_t* packed, const uint32_t* signs, const float* scale, int level, int bits,
                          int64_t n, float* out, void* stream) {
  if (!bits_supported(bits)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0)
    decode_per_value_kernel<<<grid_for(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        packed, signs, scale, level, bits, n, out);
  return static_cast<int>(cudaGetLastError());
}

// The Philox stream qsgd_encode draws: out[i] = bits of element i, i < count.
int qsgd_philox_fill(int64_t count, uint32_t seed, uint32_t* out, void* stream) {
  philox_fill_kernel<<<grid_for((count + 3) / 4, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      count, seed, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
