// One prime-field product over a group of G consecutive threads of a warp,
// shared by mont_mul_group_kernel and fp_pow_group_kernel (fp_kernels.cu)
// and hash_g1_kernel (hash_kernels.cu).
//
// Thread g of a group holds words [g K, g K + K) of each operand and of the
// result (K = NW / G): the element's "slice".  The product is fp_mul's CIOS
// Montgomery product, (a b + m p) / R with m = -a b / p mod R, and no final
// subtraction, so its output is fp_mul's integer bit for bit (REDC's output
// depends on a b alone).  Per word b_i of b (shuffled from the thread that
// holds it), thread 0 forms m_i from the accumulator's lowest word and a
// shuffle gives it to the group; each thread adds the low halves of a_j b_i
// and m_i p_j over its words and the high halves one word up (its own a_j
// and p_j), in PTX carry chains, into its K accumulator words and an
// overlap word above them; the shift takes the next word up from the
// thread above (a shuffle) into the overlap word, so no carry crosses
// threads in the loop; three rounds at the end carry each overlap word into
// the thread above, so the slices a thread returns are the result's words,
// ready to be an operand.  A product waits for NW steps of a few
// multiply-adds and two shuffles, not ~650 dependent steps (fp_mul at 12
// words), for about twice the instructions of fp_mul.
//
// Every thread of the warp must make the same calls (full-warp shuffles):
// lanes past the end of a batch run on zeros.
#pragma once

#include <cstdint>

#include "fp_rows.cuh"

namespace mlt {

constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// word g K + j of the NW words c, by selects on g: a runtime index into a
// register array or the kernel's parameters would go through the stack
template <int NW, int G>
__device__ __forceinline__ uint32_t group_word(const uint32_t* c, int g, int j) {
  constexpr int K = NW / G;
  uint32_t v = c[j];
#pragma unroll
  for (int h = 1; h < G; ++h) v = g == h ? c[h * K + j] : v;
  return v;
}

// K words of an element from word lo on: row points at its (L, n) row of
// 16-bit limbs in 32-bit words
template <int K>
__device__ __forceinline__ void load_words(uint32_t* w, const uint32_t* row, int64_t n, int64_t i,
                                           int lo) {
  const uint32_t* base = row + 2 * lo * n + i;
#pragma unroll
  for (int j = 0; j < K; ++j) w[j] = (base[(2 * j) * n] & 0xFFFFu) | (base[(2 * j + 1) * n] << 16);
}

template <int K>
__device__ __forceinline__ void store_words(uint32_t* row, const uint32_t* w, int64_t n, int64_t i,
                                            int lo) {
  uint32_t* base = row + 2 * lo * n + i;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    base[(2 * j) * n] = w[j] & 0xFFFFu;
    base[(2 * j + 1) * n] = w[j] >> 16;
  }
}

// r = x y R^-1 (relaxed [0, 2p)) over the group: x, y and r this thread's
// slices, p its K words of p.  r may alias x or y.
template <int NW, int G>
__device__ __forceinline__ void fp_mul_group(uint32_t* r, const uint32_t* x, const uint32_t* y,
                                             const uint32_t* p, uint32_t np0, int g) {
  constexpr int K = NW / G;
  // thread g's words [g K, g K + K) of the CIOS accumulator and an overlap
  // word t[K] at word g K + K, which thread g + 1's t[0] also holds: the
  // accumulator is the sum of the threads' K + 1 words, each at its place
  uint32_t t[K + 1];
#pragma unroll
  for (int j = 0; j <= K; ++j) t[j] = 0;
#pragma unroll
  for (int it = 0; it < NW; ++it) {
    const uint32_t bi = __shfl_sync(kFullWarp, y[it % K], it / K, G);
    // m = (t_0 + a_0 b_i) (-p^-1) mod 2^32, from thread 0's words
    const uint32_t m = __shfl_sync(kFullWarp, (t[0] + x[0] * bi) * np0, 0, G);
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
  // top thread's overlap word ends 0 (the result is below 2p < R)
#pragma unroll
  for (int rd = 1; rd < G; ++rd) {
    const uint32_t c = __shfl_up_sync(kFullWarp, t[K], 1, G);
    if (g == rd) {
      uint64_t v = (uint64_t)t[0] + c;
      t[0] = (uint32_t)v;
#pragma unroll
      for (int j = 1; j <= K; ++j) {
        v = (uint64_t)t[j] + (v >> 32);
        t[j] = (uint32_t)v;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) r[j] = t[j];
}

}  // namespace mlt
