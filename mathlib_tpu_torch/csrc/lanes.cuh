// Launch helpers shared by the pairing kernel sources (miller_split_kernels.cu,
// check_kernels.cu, fexp_split_kernels.cu): the tower constants, passed to
// a kernel by value, and the L dispatch (words.cuh).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "fp_rows.cuh"
#include "words.cuh"

namespace mlt {

// Per-curve tower constants, passed by value as a kernel parameter.
struct TowerConsts {
  int n;        // beta = -n: u^2 = -n
  int xi0;      // xi = xi0 + u
  int twist_m;  // 1: M-twist line placement, 0: D-twist
  int conj_end;  // conjugate f after the loop (loop parameter < 0)
  int bn_tail;   // BN: two Frobenius chord lines after the loop
  // BN tail: Q1 = (conj(Qx) cx1, conj(Qy) cy1), Q2 = (Qx cx2, -Qy cy2),
  // Montgomery form, [cx1, cy1, cx2, cy2][c0/c1][word]
  uint32_t tail[4][2][kMaxWords];
};

inline TowerConsts tower_consts(const int32_t* ints, const uint32_t* tail, int nw) {
  // ints: n, xi0, twist_m, conj_end, bn_tail; tail: [4][2][nw] words
  TowerConsts tc = {};
  tc.n = ints[0];
  tc.xi0 = ints[1];
  tc.twist_m = ints[2];
  tc.conj_end = ints[3];
  tc.bn_tail = ints[4];
  for (int a = 0; a < 4; ++a)
    for (int c = 0; c < 2; ++c)
      for (int j = 0; j < nw; ++j) tc.tail[a][c][j] = tail[(a * 2 + c) * nw + j];
  return tc;
}

}  // namespace mlt

// L picks NW among this source's word counts (words.cuh)
#define MLT_PAIR_DISPATCH(L, ...) \
  MLT_WORDS(L, __VA_ARGS__)       \
  return (int)cudaGetLastError();
