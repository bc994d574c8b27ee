// Base-field kernels for Hopper (sm_90a):
//
//   mont_mul_kernel,
//   mont_mul_group_kernel <- mathlib_tpu/ops/kernels/fp_pallas.py _mont_mul_kernel
//                       (mont_mul_pallas)
//   fp_pow_kernel,
//   fp_pow_group_kernel <- mathlib_tpu/ops/kernels/pairing_pallas.py _fp_pow_kernel
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
//     shares an element, each holding three (two at 8 words) of its words
//     (fp_mul_group, fp_group.cuh).  A lane waits for NW steps of a few
//     multiply-adds and two shuffles, not ~650 steps, but the group runs
//     more than twice the instructions: it wins while the card has few
//     elements, and loses from 24,576 on (PERF.md section 6).
//
// fp_pow: out = a^e per element over the same layout, e's MSB-first bits in a
// device array (one build serves every exponent: p - 2, (p + 1)/4): acc = 1,
// then per bit a square and, at a one-bit, a product with a (the TPU kernel
// keeps acc in VMEM across its fori_loop).  Its paths: batch_inv's one chain
// (24, 2,048) in g1_scalar_mul, sign and verify, and the G2 map's chains,
// eight a hash_to_g2_batch call of 4,096 messages (per map the Fp2 inverse
// at 4,096 elements and the Fp2 square root's chains at 8,192, 32,768 and
// 8,192).  A BLS12-381 chain is 610 dependent 12-word products, and a call
// of up to ~10^4 elements waits for one chain: bound by latency, not by
// the card's multiply rate (~0.04 ms of multiply-adds at 2,048
// elements).  Two bodies, the wrapper picks
// (fp_cuda.pow_group):
//
//   * fp_pow_group_kernel, below fp_cuda.POW_GROUP_BELOW elements: a group
//     of four threads an element, acc and a held as the group holds them
//     (fp_group.cuh), 8 elements (one warp) a block, so 2,048 elements
//     take 256 blocks on the 132 SMs;
//   * fp_pow_kernel from there: one element a thread, on fp_mul, 128
//     threads a block; when the card is full, the group's extra
//     instructions cost more than its shorter wait saves.
#include <cuda_runtime.h>

#include <cstdint>

#include "fp_group.cuh"
#include "words.cuh"

namespace mlt {

constexpr int kMontThreads = 128;
constexpr int kMontGroup = 4;  // threads an element in mont_mul_group_kernel
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

// G threads an element (consecutive lanes of a warp), on fp_mul_group.
// Every thread of the warp runs every shuffle (the lanes past n on zeros).
template <int NW, int G>
__global__ void mont_mul_group_kernel(const uint32_t* __restrict__ a,
                                      const uint32_t* __restrict__ b, int b_step,
                                      uint32_t* __restrict__ out, int n, FieldConsts k) {
  static_assert(NW % G == 0, "a group holds whole slices of an element");
  constexpr int K = NW / G;
  const int g = threadIdx.x & (G - 1);
  const int i = blockIdx.x * (kMontThreads / G) + threadIdx.x / G;
  const bool live = i < n;
  const int lo = g * K;
  uint32_t p[K];
#pragma unroll
  for (int j = 0; j < K; ++j) p[j] = group_word<NW, G>(k.p, g, j);
  const int64_t row = (int64_t)blockIdx.y * 2 * NW * n;
  uint32_t x[K] = {}, y[K] = {};
  if (live) {
    load_words<K>(x, a + row, n, i, lo);
    if (b_step) {
      load_words<K>(y, b + row, n, i, lo);
    } else {
      load_words<K>(y, b, 1, 0, lo);
    }
  }
  fp_mul_group<NW, G>(x, x, y, p, k.np0, g);
  if (live) store_words<K>(out + row, x, n, i, lo);
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

constexpr int kPowThreads = 128;       // fp_pow_kernel: one element a thread
constexpr int kPowGroupThreads = 32;   // fp_pow_group_kernel: 8 elements a block

// fp_pow's chain with each product over a group of G threads: acc = 1, then
// per bit acc = acc acc and, at a one-bit, acc = acc a; acc and a stay in
// the group's registers as slices for the whole chain.  The bits are the
// same for every thread, so the warp never diverges.
template <int NW, int G>
__global__ void __launch_bounds__(kPowGroupThreads)
    fp_pow_group_kernel(const uint32_t* __restrict__ a, const uint8_t* __restrict__ bits,
                        int nbits, uint32_t* __restrict__ out, int rows, int n, FieldConsts k) {
  static_assert(NW % G == 0, "a group holds whole slices of an element");
  constexpr int K = NW / G;
  const int g = threadIdx.x & (G - 1);
  const int64_t e = (int64_t)blockIdx.x * (kPowGroupThreads / G) + threadIdx.x / G;
  const bool live = e < (int64_t)rows * n;
  const int64_t row = live ? (e / n) * 2 * NW * n : 0;
  const int64_t i = live ? e % n : 0;
  uint32_t p[K], base[K] = {}, acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    p[j] = group_word<NW, G>(k.p, g, j);
    acc[j] = group_word<NW, G>(k.one, g, j);
  }
  if (live) load_words<K>(base, a + row, n, i, g * K);
#pragma unroll 1
  for (int b = 0; b < nbits; ++b) {
    fp_mul_group<NW, G>(acc, acc, acc, p, k.np0, g);
    if (__ldg(bits + b)) fp_mul_group<NW, G>(acc, acc, base, p, k.np0, g);
  }
  if (live) store_words<K>(out + row, acc, n, i, g * K);
}

}  // namespace mlt

using namespace mlt;

// group: threads an element, 1 (mont_mul_kernel) or kMontGroup; rows go
// to the grid's y, 65,535 a launch.  Nine words (FP256BN) do not split
// into four slices, so there the one-thread body runs whatever the group.
template <int NW>
static void mont_launch(const uint32_t* a, const uint32_t* b, int b_step, uint32_t* out, int rows,
                        int n, const FieldConsts& k, int group, cudaStream_t stream) {
  if constexpr (NW % kMontGroup != 0) group = 1;
  const int per_block = kMontThreads / group;
  const int64_t row = (int64_t)2 * NW * n;
  for (int q = 0; q < rows; q += 65535) {
    const dim3 grid((unsigned)(((int64_t)n + per_block - 1) / per_block),
                    (unsigned)(rows - q < 65535 ? rows - q : 65535));
    const uint32_t* bq = b_step ? b + q * row : b;
    if constexpr (NW % kMontGroup == 0) {
      if (group != 1) {
        mont_mul_group_kernel<NW, kMontGroup><<<grid, kMontThreads, 0, stream>>>(
            a + q * row, bq, b_step, out + q * row, n, k);
        continue;
      }
    }
    mont_mul_kernel<NW><<<grid, kMontThreads, 0, stream>>>(a + q * row, bq, b_step,
                                                           out + q * row, n, k);
  }
}

MLT_LAUNCHER(mlt_fp_mont_mul, const uint32_t* a, const uint32_t* b, int b_step, uint32_t* out,
             int rows, int n, int L, const uint32_t* consts, int group, cudaStream_t stream) {
  MLT_TO_NW9(mlt_fp_mont_mul, a, b, b_step, out, rows, n, L, consts, group, stream)
  if (group != 1 && group != kMontGroup) return -1;
  MLT_WORDS(L, mont_launch<NW>(a, b, b_step, out, rows, n, make_consts(consts, NW), group, stream))
  return (int)cudaGetLastError();
}

// group: threads an element, 1 (fp_pow_kernel) or kMontGroup
// (fp_pow_group_kernel; at nine words the one-thread body, as mont_launch)
template <int NW>
static void pow_launch(const uint32_t* a, const uint8_t* bits, int nbits, uint32_t* out, int rows,
                       int n, const FieldConsts& k, int group, cudaStream_t stream) {
  const int64_t elements = (int64_t)rows * n;
  if constexpr (NW % kMontGroup == 0) {
    if (group != 1) {
      const int per_block = kPowGroupThreads / kMontGroup;
      const dim3 grid((unsigned)((elements + per_block - 1) / per_block));
      fp_pow_group_kernel<NW, kMontGroup><<<grid, kPowGroupThreads, 0, stream>>>(
          a, bits, nbits, out, rows, n, k);
      return;
    }
  }
  const dim3 grid((unsigned)((elements + kPowThreads - 1) / kPowThreads));
  fp_pow_kernel<NW><<<grid, kPowThreads, 0, stream>>>(a, bits, nbits, out, rows, n, k);
}

MLT_LAUNCHER(mlt_fp_pow, const uint32_t* a, const uint8_t* bits, int nbits, uint32_t* out, int rows,
             int n, int L, const uint32_t* consts, int group, cudaStream_t stream) {
  MLT_TO_NW9(mlt_fp_pow, a, bits, nbits, out, rows, n, L, consts, group, stream)
  if (group != 1 && group != kMontGroup) return -1;
  MLT_WORDS(L, pow_launch<NW>(a, bits, nbits, out, rows, n, make_consts(consts, NW), group, stream))
  return (int)cudaGetLastError();
}
