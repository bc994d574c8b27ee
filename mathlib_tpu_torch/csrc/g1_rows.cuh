// G1 lane layout for one thread's registers, shared by the G1 kernels
// (g1_split_kernels.cu) and the hash-to-G1 kernel (hash_kernels.cu).
//
// Layout: a point batch is (3, L, n) 16-bit limbs in 32-bit words, the
// reference's lane-major structure of arrays.  One thread owns one lane:
// thread i reads limb l of coordinate c at [c][l][i], so a warp reads 128
// consecutive bytes per limb (coalesced), packs limb pairs into NW = L/2
// 32-bit words in registers, computes, and unpacks on the way out.
//
// The kernels' point formulas are RCB (eprint 2015/1060, Algs 7 and 9,
// a = 0) in the reference's exact operation order (mathlib_tpu/ops/kernels/
// g1_pallas.py _rcb_add_rows and _rcb_dbl_rows): in the relaxed domain
// [0, 2p) a different order of adds, subs or small-multiple chains can land
// on the other representative.  Negation is the reference's sub(0, Y) with
// 2p added back, not p - Y.
#pragma once

#include <cstdint>

#include "fp_rows.cuh"

namespace mlt {

template <int NW>
__device__ __forceinline__ void load_coord(uint32_t* w, const uint32_t* src, int c,
                                           int64_t n, int64_t i) {
  const uint32_t* base = src + (int64_t)c * 2 * NW * n + i;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    w[j] = (base[(2 * j) * n] & 0xFFFFu) | (base[(2 * j + 1) * n] << 16);
  }
}

template <int NW>
__device__ __forceinline__ void store_coord(uint32_t* dst, const uint32_t* w, int c,
                                            int64_t n, int64_t i) {
  uint32_t* base = dst + (int64_t)c * 2 * NW * n + i;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    base[(2 * j) * n] = w[j] & 0xFFFFu;
    base[(2 * j + 1) * n] = w[j] >> 16;
  }
}

// y = sub(0, y) in the relaxed domain
template <int NW>
__device__ __forceinline__ void neg_y(uint32_t* y, const FieldConsts& k) {
  uint32_t zero[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) zero[j] = 0;
  fp_sub<NW>(y, zero, y, k);
}

}  // namespace mlt
