// The G2 ladders for Hopper (sm_90a), whose bits' base-field products are
// spread over the warps of a block: port of mathlib_tpu/ops/kernels/
// g2_pallas.py's fused chain kernels.
//
//   g2_ladder_kernel<.., STATIC = false> <- g2_pallas.py:_g2_smul_kernel
//                                          (g2_smul_pallas)
//   g2_ladder_kernel<.., STATIC = true>  <- g2_pallas.py:_g2_smul_static_kernel
//                                          (g2_smul_static_pallas)
//
// out = [k]Q on (3, 2, L, n) points (g2_step.cuh has the layout), MSB first
// from infinity: per-lane scalars (G2Ctx.scalar_mul: each bit a doubling
// D = 2 acc, an add A = D + Q and acc = bit ? A : D), or one MSB-first bit
// array shared by every lane (HashG2Ctx's cofactor ladders: a doubling at
// every bit, the add only at one-bits, no select; the bits are a small
// device array, so one build serves every scalar).
//
// What bounds them on an H100 is the integer multiply rate: a bit of the
// per-lane ladder is 20 Fp2 products, 60 field products (35,280 32-bit
// multiply-adds at NW = 12) for a lane whose points stay on chip.  The
// one-thread design it replaced waited for 60 dependent products a bit in
// one thread (145 registers, a 2,376-byte stack).  Here each half of a bit,
// the doubling D = 2 acc and the add A = D + Q, is g2_step.cuh's half_bit
// on 18 workers of a block of LB lanes, with this kernel's step 5: D into
// the point buffer acc does not use, or acc = bit ? A : D, lane by lane,
// into acc's.  A block none of whose lanes has the bit takes D as acc after
// the doubling (the select would throw A away).  Keep h a runtime value
// (with the two halves inlined as separate calls g2_smul took 8.03 ms at
// 4,096 lanes on an H100, not 7.20) and each half's step-5 store its own.
//
// Q, acc, D, the products and the middle values stay in shared memory for
// all nbits steps (60 slots of NW x LB words: 90 KB at NW = 12 and 32
// lanes, dynamic, above the 48 KB static limit; the per-lane scalar limbs
// after them).  Ten barriers a bit, five where no lane of the block has it.
//
// The launchers run on the caller's stream, allocate nothing, never
// synchronise, and return the CUDA error of reading the card's SM count,
// of raising the kernel's dynamic shared memory cap (once per kernel and
// device) or of the launch (or -1 for an L other than 18 or 24, or for more bits
// than the scalar limbs hold).
#include <cuda_runtime.h>

#include <cstdint>

#include "g2_step.cuh"
#include "words.cuh"

namespace mlt {

// out = [k]Q for the LB lanes of this block (module comment): per-lane
// scalars in (S, n) plain 16-bit limbs (STATIC false), or the MSB-first
// bits shared by every lane (STATIC true).
template <int NW, int LB, bool STATIC>
__global__ void __launch_bounds__(kLadderWorkers * LB, 32 / LB)
    g2_ladder_kernel(const uint32_t* __restrict__ Q, const uint32_t* __restrict__ s,
                     const uint8_t* __restrict__ bits, int nbits, uint32_t* __restrict__ out,
                     int n, FieldConsts k, B3 b3) {
  using S = LadderSlots;
  extern __shared__ uint32_t sm[];
  uint32_t* limbs = sm + S::kN * NW * LB;  // [limb][lane]
  const int t = threadIdx.x % LB;
  const int w = threadIdx.x / LB;
  const int i = blockIdx.x * LB + t;
  const bool live = i < n;
  if (!STATIC) {
    for (int l = w; l < (nbits + 15) / 16; l += kLadderWorkers) {
      limbs[l * LB + t] = live ? s[(int64_t)l * n + i] : 0u;
    }
  }
  if (w < 6) {  // Q's component w; acc = infinity ((0, 0) : (R mod p, 0) : (0, 0))
    uint32_t v[NW] = {};
    if (live) load_fp<NW>(v, Q, w, n, i);
    sput<NW, LB>(sm, S::kQ + w, v, t);
#pragma unroll
    for (int j = 0; j < NW; ++j) v[j] = w == 2 ? k.one[j] : 0u;
    sput<NW, LB>(sm, S::kPt + w, v, t);
  }
  __syncthreads();
  int cur = 0;  // acc is point buffer cur; D goes to the other
  for (int step = 0; step < nbits; ++step) {
    const int A = S::kPt + 6 * cur, D = S::kPt + 6 * (cur ^ 1);
    bool bit = false;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {  // the doubling D = 2 acc, then the add A = D + Q
      if (h == 1 && !__syncthreads_or(bit)) {  // no lane of the block adds: acc = D
        cur ^= 1;
        break;
      }
      half_bit<NW, LB, S>(sm, h, h == 0 ? A : D, w, t, k, b3, [&] {
        if (h == 0) {  // D, and this lane's bit
          if (w < 6) {
            uint32_t r[NW];
            point_out<NW, LB, S>(r, sm, 0, w >> 1, w & 1, t, k);
            sput<NW, LB>(sm, D + w, r, t);
          }
          if (STATIC) {
            bit = bits[step] != 0;
          } else {
            const int b = nbits - 1 - step;
            bit = (limbs[(b >> 4) * LB + t] >> (b & 15)) & 1u;
          }
        } else {
          if (w < 6) {  // acc = bit ? A : D, into acc's buffer (last read by the doubling)
            uint32_t r[NW];
            if (bit) {
              point_out<NW, LB, S>(r, sm, 1, w >> 1, w & 1, t, k);
            } else {
              sget<NW, LB>(r, sm, D + w, t);
            }
            sput<NW, LB>(sm, A + w, r, t);
          }
          __syncthreads();
        }
      });
    }
  }
  if (w < 6 && live) {
    uint32_t v[NW];
    sget<NW, LB>(v, sm, S::kPt + 6 * cur + w, t);
    store_fp<NW>(out, v, w, n, i);
  }
}

template <bool STATIC>
int ladder(const uint32_t* Q, const uint32_t* s, const uint8_t* bits, int nbits, uint32_t* out,
           int n, int L, const uint32_t* consts, B3 b3, cudaStream_t stream) {
  return by_block_lanes(n, L, [&](auto nw, auto lb) {
    constexpr int NW = decltype(nw)::value, LB = decltype(lb)::value;
    static int raised[kMaxDevices] = {};
    const int limbs = STATIC ? 0 : (nbits + 15) / 16;
    return launch_blocks<NW, LB>(g2_ladder_kernel<NW, LB, STATIC>, raised, kLadderWorkers,
                                 LadderSlots::kN, limbs, n, stream, Q, s, bits, nbits, out, n,
                                 make_consts(consts, NW), b3);
  });
}

}  // namespace mlt

using namespace mlt;

MLT_LAUNCHER(mlt_g2_smul, const uint32_t* Q, const uint32_t* s, int S, int nbits, uint32_t* out,
             int n, int L, const uint32_t* consts, int b3c0, int b3c1, cudaStream_t stream) {
  MLT_TO_NW9(mlt_g2_smul, Q, s, S, nbits, out, n, L, consts, b3c0, b3c1, stream)
  if (nbits < 0 || nbits > 16 * S) return -1;
  return ladder<false>(Q, s, nullptr, nbits, out, n, L, consts, B3{b3c0, b3c1}, stream);
}

// the static ladders are hash-to-G2's cofactor clearing (BLS12-381 only):
// no NW = 9 twin
#ifndef MLT_NW9
extern "C" int mlt_g2_smul_static(const uint32_t* Q, const uint8_t* bits, int nbits,
                                  uint32_t* out, int n, int L, const uint32_t* consts, int b3c0,
                                  int b3c1, cudaStream_t stream) {
  return ladder<true>(Q, nullptr, bits, nbits, out, n, L, consts, B3{b3c0, b3c1}, stream);
}
#endif
