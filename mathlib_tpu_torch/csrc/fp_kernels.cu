// Base-field kernels for Hopper (sm_90a):
//
//   mont_mul_kernel,
//   mont_mul_group_kernel <- mathlib_tpu/ops/kernels/fp_pallas.py _mont_mul_kernel
//                       (mont_mul_pallas)
//   fp_pow_kernel    <- mathlib_tpu/ops/kernels/pairing_pallas.py _fp_pow_kernel
//                       (fp_pow_pallas, behind FpCtx.pow_bits / inv / sqrt)
//
// mont_mul: out = a * b * R^-1 mod p per element, relaxed [0, 2p) in and
// out, bit-equal to the reference (REDC's output (a b + m p) / R does not
// depend on how the product is formed: m = -a b p^-1 mod R is unique).
// Layout: a and out are (rows, L, n) 16-bit limbs in 32-bit words, the
// port's (..., L, B) tensors with the leading dims folded into rows.  b has
// a's shape, or is one (L, 1) constant broadcast over every element
// (b_step = 0), as FpCtx.to_mont multiplies by R^2 mod p.  The grid is
// (lane blocks, rows): no division to find an element.
//
// On the pairing-check path it is the Montgomery entry of the encoded pairs
// (6 rows of 4,096 lanes; BN254's pairing_batch 6 rows of 1,024), on the G1
// paths the products of to_affine_rows (2 rows of up to 2^20 lanes).  Bound
// on this card: bytes (a 12-word product is 588 32-bit multiply-adds for 96
// bytes in and 96 out, under the card's ratio of multiply-adds to bytes).
// What a call waits for below ~10^5 elements is a launch, a load and one
// lane's product chain (~650 dependent steps at 12 words); from 2^20 the
// bytes.  Two bodies, the wrapper picks (fp_cuda.mont_group):
//
//   * mont_mul_kernel, one element a thread, on fp_mul, from 2^14
//     elements: its 64-bit carries, which the compiler schedules, wait less
//     than fp_mul_ptx's single carry flag, and the wait is what a small
//     call pays; at 2^20 both are at the bytes;
//   * mont_mul_group_kernel below 2^14 elements: a group of four threads
//     shares an element, each holding three (two at 8 words) of the CIOS
//     accumulator's words and one overlap word above them.  Per word b_i
//     of b, thread 0 forms m_i from the accumulator's lowest word and a
//     shuffle gives it to the group; each thread adds the low halves of
//     a_j b_i and m_i p_j over its words and the high halves one word up
//     (its own a_j and p_j: a thread makes the products of its words), in
//     PTX carry chains; the shift takes each thread's next word up from the
//     thread above (a shuffle) into its overlap word, which sits on that
//     same word, so no carry crosses threads in the loop; three rounds at
//     the end carry each overlap word into the thread above.  A lane waits
//     for NW steps of a few multiply-adds and two shuffles, not ~650
//     steps, but the group runs more than twice the instructions: it
//     wins while the card has few elements, and loses from 24,576 on
//     (PERF.md section 6).
//
// fp_pow: out = a^e per element over the same layout, e's MSB-first bits in a
// device array (one build serves every exponent: p - 2, (p + 1)/4).  The TPU
// kernel keeps the accumulator in VMEM across its fori_loop; here it stays in
// the thread's registers across the whole chain.  Bound: operations (a
// 254-bit inverse at 8 words is ~380 products of 264 multiply-adds for 64
// bytes in and 64 out); each thread's chain is serial, so at the path's
// size (1,024 elements, 8 warps on 132 SMs) the kernel is latency-bound.
#include <cuda_runtime.h>

#include <cstdint>

#include "fp_rows.cuh"

namespace mlt {

constexpr int kMontThreads = 128;
constexpr int kMontGroup = 4;  // threads an element in mont_mul_group_kernel
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// K words of an element from word lo on: row points at its (L, n) row
template <int K>
__device__ __forceinline__ void load_words(uint32_t* w, const uint32_t* row, int64_t n, int i,
                                           int lo) {
  const uint32_t* base = row + 2 * lo * n + i;
#pragma unroll
  for (int j = 0; j < K; ++j) w[j] = (base[(2 * j) * n] & 0xFFFFu) | (base[(2 * j + 1) * n] << 16);
}

template <int K>
__device__ __forceinline__ void store_words(uint32_t* row, const uint32_t* w, int64_t n, int i,
                                            int lo) {
  uint32_t* base = row + 2 * lo * n + i;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    base[(2 * j) * n] = w[j] & 0xFFFFu;
    base[(2 * j + 1) * n] = w[j] >> 16;
  }
}

// one element a thread: fp_mul, whose 64-bit carries the compiler schedules
// (a shorter wait than fp_mul_ptx's one carry flag where latency sets the
// pace, and as fast at 2^20 elements, where bytes do)
template <int NW>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                int b_step, uint32_t* __restrict__ out, int n, FieldConsts k) {
  const int i = blockIdx.x * kMontThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t row = (int64_t)blockIdx.y * 2 * NW * n;
  uint32_t x[NW], y[NW];
  load_words<NW>(x, a + row, n, i, 0);
  if (b_step) {
    load_words<NW>(y, b + row, n, i, 0);
  } else {
    load_words<NW>(y, b, 1, 0, 0);
  }
  fp_mul<NW>(x, x, y, k);
  store_words<NW>(out + row, x, n, i, 0);
}

// word g K + j of the NW words c (a FieldConsts array), by selects on g: a
// runtime index into the kernel's parameters would copy them to the stack
template <int NW, int G>
__device__ __forceinline__ uint32_t group_word(const uint32_t* c, int g, int j) {
  constexpr int K = NW / G;
  uint32_t v = c[j];
#pragma unroll
  for (int h = 1; h < G; ++h) v = g == h ? c[h * K + j] : v;
  return v;
}

// G threads an element (consecutive lanes of a warp): thread g holds words
// [g K, g K + K) of the CIOS accumulator t and an overlap word t[K] at word
// g K + K, which thread g + 1's t[0] also holds: t is the sum of the
// threads' K + 1 words, each at its place.  Every thread of the warp runs
// every shuffle (the lanes past n on zeros).
template <int NW, int G>
__global__ void mont_mul_group_kernel(const uint32_t* __restrict__ a,
                                      const uint32_t* __restrict__ b, int b_step,
                                      uint32_t* __restrict__ out, int n, FieldConsts k) {
  constexpr int K = NW / G;
  const int g = threadIdx.x & (G - 1);
  const int i = blockIdx.x * (kMontThreads / G) + threadIdx.x / G;
  const bool live = i < n;
  const int lo = g * K;
  uint32_t p[K];
#pragma unroll
  for (int j = 0; j < K; ++j) p[j] = group_word<NW, G>(k.p, g, j);
  {
    const int64_t row = (int64_t)blockIdx.y * 2 * NW * n;
    uint32_t x[K] = {}, y[K] = {}, t[K + 1] = {};
    if (live) {
      load_words<K>(x, a + row, n, i, lo);
      if (b_step) {
        load_words<K>(y, b + row, n, i, lo);
      } else {
        load_words<K>(y, b, 1, 0, lo);
      }
    }
#pragma unroll
    for (int it = 0; it < NW; ++it) {
      const uint32_t bi = __shfl_sync(kFullWarp, y[it % K], it / K, G);
      // m = (t_0 + a_0 b_i) (-p^-1) mod 2^32, from thread 0's words
      const uint32_t m = __shfl_sync(kFullWarp, (t[0] + x[0] * bi) * k.np0, 0, G);
      // X = t + a b_i + m p over this thread's words and the two above
      uint32_t X[K + 2];
      X[0] = mad_lo_cc(x[0], bi, t[0]);
#pragma unroll
      for (int j = 1; j < K; ++j) X[j] = madc_lo_cc(x[j], bi, t[j]);
      X[K] = addc_cc(t[K], 0);
      X[K + 1] = addc(0, 0);
      X[1] = mad_hi_cc(x[0], bi, X[1]);
#pragma unroll
      for (int j = 1; j < K; ++j) X[j + 1] = madc_hi_cc(x[j], bi, X[j + 1]);
      X[K + 1] = addc(X[K + 1], 0);
      X[0] = mad_lo_cc(m, p[0], X[0]);
#pragma unroll
      for (int j = 1; j < K; ++j) X[j] = madc_lo_cc(m, p[j], X[j]);
      X[K] = addc_cc(X[K], 0);
      X[K + 1] = addc(X[K + 1], 0);
      X[1] = mad_hi_cc(m, p[0], X[1]);
#pragma unroll
      for (int j = 1; j < K; ++j) X[j + 1] = madc_hi_cc(m, p[j], X[j + 1]);
      X[K + 1] = addc(X[K + 1], 0);
      // t = X / 2^32: word K of X and thread g + 1's word 0 are one word
      // (thread 0's word 0 is 0 and leaves)
      uint32_t above = __shfl_down_sync(kFullWarp, X[0], 1, G);
      if (g == G - 1) above = 0;
#pragma unroll
      for (int j = 0; j + 1 < K; ++j) t[j] = X[j + 1];
      const uint64_t top = (uint64_t)X[K] + above;
      t[K - 1] = (uint32_t)top;
      t[K] = X[K + 1] + (uint32_t)(top >> 32);
    }
    // carry each overlap word into the thread above, from thread 0 up; the
    // top thread's overlap word ends 0 (t < 2p < R)
#pragma unroll
    for (int r = 1; r < G; ++r) {
      const uint32_t c = __shfl_up_sync(kFullWarp, t[K], 1, G);
      if (g == r) {
        uint64_t v = (uint64_t)t[0] + c;
        t[0] = (uint32_t)v;
#pragma unroll
        for (int j = 1; j <= K; ++j) {
          v = (uint64_t)t[j] + (v >> 32);
          t[j] = (uint32_t)v;
        }
      }
    }
    if (live) store_words<K>(out + row, t, n, i, lo);
  }
}

template <int NW>
__global__ void fp_pow_kernel(const uint32_t* __restrict__ a, const uint8_t* __restrict__ bits,
                              int nbits, uint32_t* __restrict__ out, int rows, int n,
                              FieldConsts k) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)rows * n) return;
  const int q = (int)(e / n);
  const int64_t i = e % n;
  uint32_t x[NW];
  load_fp<NW>(x, a, q, n, i);
  fp_pow<NW>(x, x, bits, nbits, k);
  store_fp<NW>(out, x, q, n, i);
}

inline dim3 fp_grid(int rows, int n) { return dim3((unsigned)(((int64_t)rows * n + 127) / 128)); }

}  // namespace mlt

using namespace mlt;

// group: threads an element, 1 (mont_mul_kernel) or kMontGroup
// group: threads an element, 1 (mont_mul_kernel) or kMontGroup; rows go
// to the grid's y, 65,535 a launch
template <int NW>
static void mont_launch(const uint32_t* a, const uint32_t* b, int b_step, uint32_t* out, int rows,
                        int n, const FieldConsts& k, int group, cudaStream_t stream) {
  const int per_block = kMontThreads / group;
  const int64_t row = (int64_t)2 * NW * n;
  for (int q = 0; q < rows; q += 65535) {
    const dim3 grid((unsigned)(((int64_t)n + per_block - 1) / per_block),
                    (unsigned)(rows - q < 65535 ? rows - q : 65535));
    const uint32_t* bq = b_step ? b + q * row : b;
    if (group == 1) {
      mont_mul_kernel<NW><<<grid, kMontThreads, 0, stream>>>(a + q * row, bq, b_step,
                                                             out + q * row, n, k);
    } else {
      mont_mul_group_kernel<NW, kMontGroup><<<grid, kMontThreads, 0, stream>>>(
          a + q * row, bq, b_step, out + q * row, n, k);
    }
  }
}

extern "C" int mlt_fp_mont_mul(const uint32_t* a, const uint32_t* b, int b_step, uint32_t* out,
                               int rows, int n, int L, const uint32_t* consts, int group,
                               cudaStream_t stream) {
  if (group != 1 && group != kMontGroup) return -1;
  switch (L) {
    case 16:
      mont_launch<8>(a, b, b_step, out, rows, n, make_consts(consts, 8), group, stream);
      break;
    case 24:
      mont_launch<12>(a, b, b_step, out, rows, n, make_consts(consts, 12), group, stream);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" int mlt_fp_pow(const uint32_t* a, const uint8_t* bits, int nbits, uint32_t* out,
                          int rows, int n, int L, const uint32_t* consts, cudaStream_t stream) {
  const dim3 grid = fp_grid(rows, n);
  switch (L) {
    case 16:
      fp_pow_kernel<8><<<grid, 128, 0, stream>>>(a, bits, nbits, out, rows, n,
                                                 make_consts(consts, 8));
      break;
    case 24:
      fp_pow_kernel<12><<<grid, 128, 0, stream>>>(a, bits, nbits, out, rows, n,
                                                  make_consts(consts, 12));
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}
