// The one-launch pairing-product check for Hopper (sm_90a): port of
// mathlib_tpu/ops/kernels/pairing_pallas.py
//
//   pairing_check_kernel  <- _pairing_check_kernel (:1065): prod_i e(P_i, Q_i)
//                            == 1 for BLS12 curves with the factor-3 final
//                            exponentiation, Miller loops, product, final exp
//                            and unity test in one launch
//
// What the TPU kernel does: each step of its sequential grid runs the Miller
// loop of a tile of lanes, conjugates (x < 0), masks the lanes at or past
// nlanes to one, rotation-multiplies the tile into one f12 and multiplies that
// into a product carried in scratch; the last grid step runs the final
// exponentiation of the product and writes the unity flag.
//
// Hopper runs blocks in no order, so nothing carries across a grid.  Here:
//   1. each thread computes its lane's masked Miller value (miller_lane of
//      tower_rows.cuh, as miller_lanes_kernel; lanes >= nvalid and the pad
//      lanes past B up to the next power of two W are the f12 one);
//   2. each block multiplies its lanes in shared memory (32 lanes x 576 B at
//      NW = 12: 18 KB, static) by the tree f12_seg_product runs: at level s
//      lane t (a multiple of 2s) takes lane t times lane t + s;
//   3. each block writes its partial product to a scratch buffer, fences
//      (__threadfence) and takes a ticket (atomicAdd);
//   4. the block that takes the last ticket multiplies the partials by the
//      same tree, in block order, its threads sharing each level; so the
//      product is bit-equal to f12_seg_product over the W lanes (plain:
//      pairing_cuda.pairing_check_plain), not the reference's rotation
//      product, whose relaxed [0, 2p) limbs differ (the same value mod p);
//   5. one thread of that block writes the unreduced product, runs the final
//      exponentiation (final_exp_lane of fexp_rows.cuh), writes the unity
//      flag and resets the ticket to 0 for the next launch.
//
// The scratch and the ticket are the caller's (pairing_cuda.py keeps one pair
// per device and stream, the ticket zeroed once at allocation): calls that
// share them are serialised on the caller's stream, so no two launches ever
// race on the ticket, and no memset runs per call.
//
// Bound on this card: integer multiplies.  A BLS12-381 lane runs 7,786 field
// muls in its Miller loop, the tree 54 per lane, the final exp ~10,000 once
// (fexp_rows.cuh), each of 588 32-bit multiply-adds (fp_rows.cuh); bytes
// are 288 a lane in, 580 out.  The final exp is one serial chain on one
// thread after every Miller loop has ended: at 4,096 lanes the kernel runs
// about one Miller lane's latency plus one final exp's.
//
// The launcher runs on the caller's stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (or -1 for an unsupported L).
#include <cuda_runtime.h>

#include <cstdint>

#include "fexp_rows.cuh"
#include "fp_rows.cuh"
#include "lanes.cuh"
#include "tower_rows.cuh"

namespace mlt {

// An f12 as 12 * NW consecutive words of a scratch slot, read and written
// at L2 (cg), past the SM's L1, as blocks on other SMs fill them.
template <int NW>
__device__ __forceinline__ void f12_load_cg(F12<NW>& f, const uint32_t* src) {
  for (int h = 0; h < 2; ++h)
    for (int j = 0; j < 3; ++j)
      for (int c = 0; c < 2; ++c)
        for (int w = 0; w < NW; ++w)
          f.c[h].c[j].c[c][w] = __ldcg(src + ((h * 3 + j) * 2 + c) * NW + w);
}

template <int NW>
__device__ __forceinline__ void f12_store_cg(uint32_t* dst, const F12<NW>& f) {
  for (int h = 0; h < 2; ++h)
    for (int j = 0; j < 3; ++j)
      for (int c = 0; c < 2; ++c)
        for (int w = 0; w < NW; ++w) __stcg(dst + ((h * 3 + j) * 2 + c) * NW + w, f.c[h].c[j].c[c][w]);
}

// ok[0] = prod_i e(P_i, Q_i) == 1 over lanes i < nvalid; prod_out (12, L, 1)
// = the unreduced product.  The grid is W / blockDim.x blocks of blockDim.x
// = min(32, W) threads, W the next power of two >= lanes; scratch holds
// 2 * gridDim.x f12 slots.
template <int NW>
__global__ void pairing_check_kernel(const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp,
                                     const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
                                     const uint8_t* __restrict__ bits, int nbits, int nvalid,
                                     FexpArgs fa, uint32_t* __restrict__ ok_out,
                                     uint32_t* __restrict__ prod_out, uint32_t* scratch,
                                     unsigned int* ticket, int lanes, FieldConsts k,
                                     TowerConsts tc) {
  constexpr int kSlot = 12 * NW;
  __shared__ F12<NW> part[kPairThreads];
  __shared__ bool last;
  const int t = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + t;

  // 1. the lane's masked Miller value
  F12<NW> f;
  if (i < nvalid) {  // nvalid <= lanes (the launcher clamps it)
    uint32_t xP[NW], yP[NW];
    F2<NW> Qx, Qy;
    load_fp<NW>(xP, xp, 0, lanes, i);
    load_fp<NW>(yP, yp, 0, lanes, i);
    load_f2<NW>(Qx, qx, lanes, i);
    load_f2<NW>(Qy, qy, lanes, i);
    miller_lane<NW>(f, xP, yP, Qx, Qy, bits, nbits, k, tc);
  } else {
    f12_one<NW>(f, k);
  }
  part[t] = f;
  __syncthreads();

  // 2. the block's product, by f12_seg_product's tree
  for (int s = 1; s < blockDim.x; s <<= 1) {
    if ((t & (2 * s - 1)) == 0) f12_mul<NW>(part[t], part[t], part[t + s], k, tc);
    __syncthreads();
  }

  // 3. publish the partial and take a ticket
  if (t == 0) {
    f12_store_cg<NW>(scratch + (int64_t)blockIdx.x * kSlot, part[0]);
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // 4. the last block: the tree over the partials, level by level between
  // the two halves of the scratch
  uint32_t* src = scratch;
  uint32_t* dst = scratch + (int64_t)gridDim.x * kSlot;
  for (int c = gridDim.x; c > 1; c >>= 1) {
    for (int j = t; j < c / 2; j += blockDim.x) {
      F12<NW> a, b;
      f12_load_cg<NW>(a, src + (int64_t)(2 * j) * kSlot);
      f12_load_cg<NW>(b, src + (int64_t)(2 * j + 1) * kSlot);
      f12_mul<NW>(a, a, b, k, tc);
      f12_store_cg<NW>(dst + (int64_t)j * kSlot, a);
    }
    __threadfence_block();
    __syncthreads();
    uint32_t* tmp = src;
    src = dst;
    dst = tmp;
  }

  // 5. the product, its final exponentiation and the unity flag
  if (t == 0) {
    f12_load_cg<NW>(f, src);
    store_f12<NW>(prod_out, f, 1, 0);
    final_exp_lane<NW>(f, fa, k, tc);
    ok_out[0] = f12_is_one<NW>(f, k) ? 1u : 0u;
    *ticket = 0u;
  }
}

}  // namespace mlt

using namespace mlt;

extern "C" int mlt_pairing_check(const uint32_t* xp, const uint32_t* yp, const uint32_t* qx,
                                 const uint32_t* qy, const uint8_t* bits, int nbits, int nvalid,
                                 const uint8_t* inv_bits, int inv_nbits, const uint8_t* x_bits,
                                 int x_nbits, int x_neg, const uint32_t* gammas,
                                 uint32_t* ok_out, uint32_t* prod_out, uint32_t* scratch,
                                 unsigned int* ticket, int lanes, int width, int L,
                                 const uint32_t* consts, const int32_t* tower_ints,
                                 const uint32_t* tail, cudaStream_t stream) {
  if (width < 1 || (width & (width - 1)) || width < lanes) return -1;
  const int threads = width < kPairThreads ? width : kPairThreads;
  const int valid = nvalid < 0 ? 0 : (nvalid > lanes ? lanes : nvalid);
  const FexpArgs fa = {inv_bits, inv_nbits, x_bits, x_nbits, x_neg, gammas};
  MLT_PAIR_DISPATCH(L, pairing_check_kernel<NW><<<width / threads, threads, 0, stream>>>(
                           xp, yp, qx, qy, bits, nbits, valid, fa, ok_out, prod_out, scratch,
                           ticket, lanes, make_consts(consts, NW),
                           tower_consts(tower_ints, tail, NW)))
}
