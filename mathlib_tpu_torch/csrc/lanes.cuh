// Lane I/O and launch helpers shared by the pairing and G2 kernel sources
// (the tower constants and the L dispatch: miller_split_kernels.cu,
// check_kernels.cu, fexp_split_kernels.cu; T's I/O: g2_kernels.cu through
// g2_rows.cuh): one thread owns one lane of (..., L, B) limb arrays (16-bit
// limbs in 32-bit words, lane batch last); T is (3, 2, L, B).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "fp_rows.cuh"
#include "tower_rows.cuh"

namespace mlt {

template <int NW>
__device__ __forceinline__ void load_T(G2Proj<NW>& T, const uint32_t* src, int64_t n, int64_t i) {
  for (int c = 0; c < 2; ++c) {
    load_fp<NW>(T.x.c[c], src, 0 * 2 + c, n, i);
    load_fp<NW>(T.y.c[c], src, 1 * 2 + c, n, i);
    load_fp<NW>(T.z.c[c], src, 2 * 2 + c, n, i);
  }
}

template <int NW>
__device__ __forceinline__ void store_T(uint32_t* dst, const G2Proj<NW>& T, int64_t n, int64_t i) {
  for (int c = 0; c < 2; ++c) {
    store_fp<NW>(dst, T.x.c[c], 0 * 2 + c, n, i);
    store_fp<NW>(dst, T.y.c[c], 1 * 2 + c, n, i);
    store_fp<NW>(dst, T.z.c[c], 2 * 2 + c, n, i);
  }
}

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

#define MLT_PAIR_DISPATCH(L, ...)        \
  switch (L) {                           \
    case 16: {                           \
      constexpr int NW = 8;              \
      __VA_ARGS__;                       \
      break;                             \
    }                                    \
    case 24: {                           \
      constexpr int NW = 12;             \
      __VA_ARGS__;                       \
      break;                             \
    }                                    \
    default:                             \
      return -1;                         \
  }                                      \
  return (int)cudaGetLastError();

