// The Miller loop for Hopper (sm_90a) with one lane's loop spread over the
// warps of a block: port of mathlib_tpu/ops/kernels/pairing_pallas.py
//
//   miller_lanes_split_kernel <- _miller_conj_tail + _mask_pad_to_one, the
//                                front half of _pairing_prod_kernel (:1188)
//                                and _pairing_prod_seg_kernel (:1244)
//   miller_ft_split_kernel    <- _miller_kernel (:788): (f, T) after the
//                                loop, no conjugation and no tail
//   add_step_split_kernel     <- _add_step_kernel (:807): (f l_{T,Q}(P),
//                                T + Q), BN's chord steps after miller_ft
//
// They compute what the plain versions (pairing_cuda.miller_lanes_plain,
// miller_ft_plain, add_step_plain on ops/kernels/tower_rows.py) compute, add
// for add and product for product, so the relaxed [0, 2p) limbs that come
// out are theirs.
//
// What bounds them on an H100 is the integer multiply rate: a BLS12-381 lane
// runs 63 doubling iterations (117 field products each: dbl_step 39,
// f12_sqr 36, f12_sparse_mul 42 at the M-twist, 39 at the D-twist) and 5
// addition steps (83: add_step 41, f12_sparse_mul 42), 7,786 products of
// 4 NW^2 + NW = 588 32-bit multiply-adds each, for 288 bytes in and 576 out
// (miller_ft also writes T, 288 more).  One thread a lane runs them as one
// chain, with f, T and the temporaries on its stack.  The reference instead
// stacks every step into a few batches of products that do not depend on
// each other (RowTower's MulBatch), and so does this design:
//
//   * ops/kernels/miller_prog.py traces one doubling iteration, one doubling
//     iteration followed by an addition step, and the loop's end (the
//     conjugation, the BN chord steps) into graphs of field adds, subs and
//     products, and schedules each for K workers: the products in layers by
//     their depth (f12_sqr joins dbl_step's first layers, a product with slack
//     fills a layer's last round), the linear steps in the phases between,
//     each value in its own slot.  At BLS12-381 with K = 32 a doubling
//     iteration is 117 products in layers of 32, 25, 21 and 39 and 20 phases
//     (506 instructions); a doubling and addition 200 products in layers of
//     32, 25, 21, 32, 27, 32 and 31 and 34 phases (793 instructions);
//   * a block owns G lanes (32, 16 or 8: a template parameter; the launcher
//     picks it from the lane count so that a call puts ~128 blocks on the
//     card, with K = 32, 48 or 64 workers).  Its workers are warps (G = 32)
//     or parts of warps; thread t of every worker works on lane
//     blockIdx.x * G + t.  A worker runs its instruction list of a phase,
//     then the block meets at a barrier.  The instructions are an
//     accumulator machine over shared memory (ADD, SUB, MUL, DBL, NEG, NOP,
//     each with an optional load before and store after; miller_prog.py
//     has their meaning): d = x + y and d = x * y are one instruction each.
//     Workers that share a warp have their products at the same instruction
//     index (NOP padding), so the warp runs each product once for all of
//     them;
//   * the loop bits are the same for every lane: the block runs the
//     doubling program, or the doubling-and-addition one, for each bit, and
//     no branch diverges between lanes.
//
// Shared memory holds the lane state for the whole loop: f (12 slots), T (6),
// xP, yP, Qx, Qy (6), the BN tail's constants (8), and the programs' values,
// each slot NW x G words (and G more when G < 32, which spreads the workers
// of a warp over the banks).  A program takes its slot count from its
// values' lifetimes: at BLS12-381 142 slots for G = 32 (218 KB a block, 1 a
// SM), 140 for G = 16 (116 KB), 143 for G = 8 (59 KB); dynamic shared
// memory, above the 48 KB default.  Where a curve's programs would not fit
// a block (BLS12-377 at G = 32: 169 slots), the launcher takes the next
// smaller group (180 slots at G = 16, 146 KB).
//
// The interpreter (SlotMem, run_phases, the launch shape) is
// prog_interp.cuh, shared with the final-exp kernels (fexp_split_kernels.cu).
// A thread holds acc and one operand in registers: no call, no stack, no
// spill (ptxas' report is on chip_smoke.py's build lines).  What holds the
// kernels above their bound is the interpreter's latency (prog_interp.cuh
// has its costs), and each phase ends at a barrier.
//
// The addition step alone (one program: add_step then the sparse product,
// 83 products at the M-twist) runs the same way: f, T, xP, yP, Qx and Qy
// into their loop slots, the program, f and T out.
//
// The launchers run on the caller's stream, allocate nothing, never
// synchronise, and return cudaGetLastError() (or -1 for an unsupported L,
// group size or block).  The program and its host meta (G, K, slots, words
// a slot, then the phase ranges [begin, end) of the doubling,
// doubling-and-addition and tail programs, or of the addition step's) come
// after the lane arguments.
#include <cuda_runtime.h>

#include <cstdint>

#include "fp_rows.cuh"
#include "lanes.cuh"
#include "miller_state.cuh"
#include "prog_interp.cuh"

namespace mlt {

// the fixed slots are miller_state.cuh's
constexpr int kAddState = 24;  // the addition step's: f, T, xP, yP, Qx, Qy

// Lane i's Miller loop over the block's G lanes: state into shared memory,
// one program a loop bit (and the tail program when LANES), then f (and T
// when not LANES) out.  LANES: lanes >= nvalid are the f12 one and their
// inputs are never read.
template <int NW, int G, bool LANES>
__device__ __forceinline__ void miller_split(
    const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp,
    const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
    const uint8_t* __restrict__ bits, int nbits, int nvalid, uint32_t* __restrict__ f_out,
    uint32_t* __restrict__ t_out, int lanes, const FieldConsts& k, const TowerConsts& tc,
    const int32_t* __restrict__ prog, const ProgMeta& m) {
  extern __shared__ uint32_t smem[];
  const int t = threadIdx.x % G, wk = threadIdx.x / G, K = m.workers;
  const int64_t i = (int64_t)blockIdx.x * G + t;
  const bool real = i < nvalid;
  const SlotMem<NW, G> S{smem + t, m.stride};
  uint32_t acc[NW];
  miller_state<NW, G>(xp, yp, qx, qy, real, i, lanes, wk, K, S, acc, k, tc);
  __syncthreads();
  for (int b = 0; b < nbits; ++b) {  // a select, not an index into the parameter
    const bool add = bits[b] != 0;
    run_phases<NW, G>(prog, add ? m.range[1][0] : m.range[0][0],
                      add ? m.range[1][1] : m.range[0][1], K, wk, S, acc, k);
  }
  if (LANES) run_phases<NW, G>(prog, m.range[2][0], m.range[2][1], K, wk, S, acc, k);
  if (i >= lanes) return;
  for (int q = wk; q < (LANES ? 12 : 18); q += K) {
    if (LANES && !real) {
#pragma unroll
      for (int j = 0; j < NW; ++j) acc[j] = q == 0 ? k.one[j] : 0u;
    } else {
      S.get(acc, q);
    }
    if (q < kSlotT) {
      store_fp<NW>(f_out, acc, q, lanes, i);
    } else {
      store_fp<NW>(t_out, acc, q - kSlotT, lanes, i);
    }
  }
}

template <int NW, int G>
__global__ void __launch_bounds__(kProgMaxThreads)
    miller_lanes_split_kernel(const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp,
                              const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
                              const uint8_t* __restrict__ bits, int nbits, int nvalid,
                              uint32_t* __restrict__ out, int lanes, FieldConsts k,
                              TowerConsts tc, const int32_t* __restrict__ prog, ProgMeta m) {
  miller_split<NW, G, true>(xp, yp, qx, qy, bits, nbits, nvalid, out, nullptr, lanes, k, tc,
                            prog, m);
}

template <int NW, int G>
__global__ void __launch_bounds__(kProgMaxThreads)
    miller_ft_split_kernel(const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp,
                           const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
                           const uint8_t* __restrict__ bits, int nbits,
                           uint32_t* __restrict__ f_out, uint32_t* __restrict__ t_out, int lanes,
                           FieldConsts k, TowerConsts tc, const int32_t* __restrict__ prog,
                           ProgMeta m) {
  miller_split<NW, G, false>(xp, yp, qx, qy, bits, nbits, lanes, f_out, t_out, lanes, k, tc,
                             prog, m);
}

// (f, T) <- (f l_{T,Q}(P), T + Q) per lane over the block's G lanes: the
// state into its loop slots, the program, f and T out.  Pad lanes run on
// zeros and are never stored.
template <int NW, int G>
__global__ void __launch_bounds__(kProgMaxThreads)
    add_step_split_kernel(const uint32_t* __restrict__ f_in, const uint32_t* __restrict__ t_in,
                          const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
                          const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp,
                          uint32_t* __restrict__ f_out, uint32_t* __restrict__ t_out,
                          int lanes, FieldConsts k, const int32_t* __restrict__ prog,
                          ProgMeta m) {
  extern __shared__ uint32_t smem[];
  const int t = threadIdx.x % G, wk = threadIdx.x / G, K = m.workers;
  const int64_t i = (int64_t)blockIdx.x * G + t;
  const SlotMem<NW, G> S{smem + t, m.stride};
  uint32_t acc[NW];
  for (int q = wk; q < kAddState; q += K) {
    if (i < lanes) {
      const uint32_t* src = q < kSlotT    ? f_in
                            : q < kSlotXP ? t_in
                            : q == kSlotXP ? xp
                            : q == kSlotYP ? yp
                            : q < kSlotQy  ? qx
                                           : qy;
      const int c = q < kSlotT ? q : q < kSlotXP ? q - kSlotT : q < kSlotQx ? 0 : q % 2;
      load_fp<NW>(acc, src, c, lanes, i);
    } else {
#pragma unroll
      for (int j = 0; j < NW; ++j) acc[j] = 0;
    }
    S.put(q, acc);
  }
  __syncthreads();
  run_phases<NW, G>(prog, m.range[0][0], m.range[0][1], K, wk, S, acc, k);
  if (i >= lanes) return;
  for (int q = wk; q < kSlotXP; q += K) {
    S.get(acc, q);
    if (q < kSlotT) {
      store_fp<NW>(f_out, acc, q, lanes, i);
    } else {
      store_fp<NW>(t_out, acc, q - kSlotT, lanes, i);
    }
  }
}

}  // namespace mlt

using namespace mlt;

MLT_LAUNCHER(mlt_pairing_miller_lanes, const uint32_t* xp, const uint32_t* yp, const uint32_t* qx,
             const uint32_t* qy, const uint8_t* bits, int nbits, int nvalid, uint32_t* out,
             int lanes, int L, const uint32_t* consts, const int32_t* tower_ints,
             const uint32_t* tail, const int32_t* prog, const int32_t* meta, cudaStream_t stream) {
  MLT_TO_NW9(mlt_pairing_miller_lanes, xp, yp, qx, qy, bits, nbits, nvalid, out, lanes, L, consts,
             tower_ints, tail, prog, meta, stream)
  const ProgMeta m = prog_meta(meta, 3);
  MLT_PAIR_DISPATCH(L, MLT_PROG_GROUPS(m.group, {
    dim3 grid, block;
    size_t smem;
    if (!prog_launch_shape<NW, G>(miller_lanes_split_kernel<NW, G>, m, kStateSlots, lanes,
                                  grid, block, smem))
      return -1;
    miller_lanes_split_kernel<NW, G><<<grid, block, smem, stream>>>(
        xp, yp, qx, qy, bits, nbits, nvalid, out, lanes, make_consts(consts, NW),
        tower_consts(tower_ints, tail, NW), prog, m);
  }))
}

MLT_LAUNCHER(mlt_pairing_miller_ft, const uint32_t* xp, const uint32_t* yp, const uint32_t* qx,
             const uint32_t* qy, const uint8_t* bits, int nbits, uint32_t* f_out, uint32_t* t_out,
             int lanes, int L, const uint32_t* consts, const int32_t* tower_ints,
             const uint32_t* tail, const int32_t* prog, const int32_t* meta, cudaStream_t stream) {
  MLT_TO_NW9(mlt_pairing_miller_ft, xp, yp, qx, qy, bits, nbits, f_out, t_out, lanes, L, consts,
             tower_ints, tail, prog, meta, stream)
  const ProgMeta m = prog_meta(meta, 3);
  MLT_PAIR_DISPATCH(L, MLT_PROG_GROUPS(m.group, {
    dim3 grid, block;
    size_t smem;
    if (!prog_launch_shape<NW, G>(miller_ft_split_kernel<NW, G>, m, kStateSlots, lanes, grid,
                                  block, smem))
      return -1;
    miller_ft_split_kernel<NW, G><<<grid, block, smem, stream>>>(
        xp, yp, qx, qy, bits, nbits, f_out, t_out, lanes, make_consts(consts, NW),
        tower_consts(tower_ints, tail, NW), prog, m);
  }))
}

MLT_LAUNCHER(mlt_pairing_add_step, const uint32_t* f_in, const uint32_t* t_in, const uint32_t* qx,
             const uint32_t* qy, const uint32_t* xp, const uint32_t* yp, uint32_t* f_out,
             uint32_t* t_out, int lanes, int L, const uint32_t* consts, const int32_t* prog,
             const int32_t* meta, cudaStream_t stream) {
  MLT_TO_NW9(mlt_pairing_add_step, f_in, t_in, qx, qy, xp, yp, f_out, t_out, lanes, L, consts, prog,
             meta, stream)
  const ProgMeta m = prog_meta(meta, 1);
  MLT_PAIR_DISPATCH(L, MLT_PROG_GROUPS(m.group, {
    dim3 grid, block;
    size_t smem;
    if (!prog_launch_shape<NW, G>(add_step_split_kernel<NW, G>, m, kAddState, lanes, grid,
                                  block, smem))
      return -1;
    add_step_split_kernel<NW, G><<<grid, block, smem, stream>>>(
        f_in, t_in, qx, qy, xp, yp, f_out, t_out, lanes, make_consts(consts, NW), prog, m);
  }))
}
