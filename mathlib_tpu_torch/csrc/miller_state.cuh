// The lane state of the split Miller loop (ops/kernels/miller_prog.py), shared
// by the Miller kernels (miller_split_kernels.cu) and the one-launch check
// (check_kernels.cu): its fixed slots and the load that fills them.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "fp_rows.cuh"
#include "lanes.cuh"
#include "prog_interp.cuh"

namespace mlt {

// fixed slots (miller_prog.py): f 0-11, T 12-17, xP 18, yP 19, Qx 20-21,
// Qy 22-23, tail constants 24-31
constexpr int kSlotT = 12, kSlotXP = 18, kSlotYP = 19, kSlotQx = 20, kSlotQy = 22;
constexpr int kSlotTail = 24, kStateSlots = 32;

// Lane i's loop state into its slots, slot q by worker q % K: f = 1,
// T = (Qx : Qy : 1), P, Q and the tail constants; a lane that is not `real`
// gets zeros for T's and the points' coordinates, and its inputs are never
// read.
template <int NW, int G>
__device__ __forceinline__ void miller_state(
    const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp,
    const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy, bool real, int64_t i,
    int lanes, int wk, int K, const SlotMem<NW, G>& S, uint32_t* acc, const FieldConsts& k,
    const TowerConsts& tc) {
  for (int q = wk; q < kStateSlots; q += K) {  // f = 1, T = (Qx : Qy : 1), P, Q, tail
    if (q == 0 || q == kSlotT + 4) {
      fp_copy<NW>(acc, k.one);
    } else if (q >= kSlotTail) {  // static indices into the parameter
#pragma unroll
      for (int a = 0; a < 8; ++a)
        if (q == kSlotTail + a) fp_copy<NW>(acc, tc.tail[a / 2][a % 2]);
    } else if (real && q >= kSlotT && q < kSlotT + 4) {
      load_fp<NW>(acc, q < kSlotT + 2 ? qx : qy, q % 2, lanes, i);
    } else if (real && q >= kSlotXP) {
      load_fp<NW>(acc, q == kSlotXP ? xp : q == kSlotYP ? yp : q < kSlotQy ? qx : qy,
                  q >= kSlotQx ? q % 2 : 0, lanes, i);
    } else {
#pragma unroll
      for (int j = 0; j < NW; ++j) acc[j] = 0;
    }
    S.put(q, acc);
  }
}

}  // namespace mlt
