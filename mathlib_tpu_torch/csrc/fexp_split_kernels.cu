// The final exponentiation, the Fp12 power chain and the product tree for
// Hopper (sm_90a), one lane's chain spread over the workers of a block: port
// of mathlib_tpu/ops/kernels/pairing_pallas.py
//
//   f12_pow_split_kernel   <- _f12_pow_kernel (:828): f^e per lane, e's
//                             MSB-first bits, cyclotomic or plain squaring
//   final_exp_split_kernel <- _final_exp_kernel (:914): the whole BLS12 final
//                             exponentiation (factor-3 chain) per lane; on
//                             BN curves the whole final exponentiation (the
//                             easy part around _fp_pow_kernel (:1291) and one
//                             _f12_pow_kernel a base-p digit) by a BN script
//   f12_tree_split_kernel  <- _product_all_positions (:971), the product of
//                             _pairing_prod_kernel (:1188) and
//                             _pairing_prod_seg_kernel (:1244): several
//                             levels of the product tree a launch
//
// They compute what the plain versions (pairing_cuda.f12_pow_plain,
// final_exp_plain, final_exp_bn_plain, f12_seg_product_plain on
// ops/kernels/tower_rows.py) compute, add for add and product for product,
// so the relaxed [0, 2p) limbs that come out are theirs.
//
// What bounds them on an H100 is the integer multiply rate: a BLS12-381
// final exp is 8,675 field products of 588 32-bit multiply-adds a lane (the
// inverse chain over p - 2: 610; five x-chains of 64 cyclotomic squarings of
// 18 products, 6 multiplies of 54 each), for 576 bytes in and 576 out; a
// BN254 digit chain ~64 cyclotomic squarings and ~30 multiplies at 8 words.
// Each chain is serial, so one thread a lane (the design before) ran them
// latency-bound at one warp an SM.  Here, as in the split Miller kernels
// (miller_split_kernels.cu), each step is a few layers of independent
// products run by K workers:
//
//   * ops/kernels/fexp_prog.py traces each step (a cyclotomic or plain
//     squaring, the squaring and the multiply by the base, the inverse's
//     halves, the Frobenius maps, the products between the x-chains) op for
//     op as the plain versions compute it, and schedules it with miller_prog's
//     scheduler: at BLS12-381 with K = 32 a cyclotomic squaring is one layer
//     of 18 products and 6 phases, a squaring and multiply 15 phases;
//   * a block owns G lanes (32, 16 or 8) and K = 32, 48 or 64 workers, as
//     the Miller kernels, chosen by pairing_cuda.fexp_shape from the lane
//     count and the slots the curve's programs need (144 at BLS12-381, so
//     218 KB for G = 32; BLS12-377 takes G = 16);
//   * a kernel runs a script (fexp_prog.py encode_steps): one row a step,
//     RUN a program's phases, ONE (the f12 one into acc), INV (the
//     base-field inverse) or CONST (a Frobenius constant into its slots, just
//     before the program that reads it).  The host writes one RUN row a bit
//     of the exponent (the squaring, or the squaring and multiply), and the
//     conjugations when x < 0: the bits are the same for every lane, so no
//     lane diverges, and one build serves every curve and exponent;
//   * the base-field inverse (fp_pow over the MSB-first bits of p - 2, a
//     device input) has no width: worker 0 runs its square-and-multiply in
//     registers with fp_mul_ptx, the others wait at the barrier.
//
// The product tree (ops/kernels/tree_prog.py) is one f12 product a lane and
// a level, so its depth, not its work, sets its time: a block of G lanes
// takes 2G input lanes and runs up to log2(2G) levels in shared memory, the
// f12 product program (one layer of 54 products at K = 64) and, between two
// levels, a PAIR row that moves lanes 2t and 2t + 1's products into lane t's
// operands.  A block owns 8 lanes and 64 workers, so the 54 products are
// one layer (a level is 8 phases at BLS12-381, against 11 for 16 and 32
// lanes, which also ran slower on an H100: PERF.md section 6), and runs 4
// levels a launch: a 4,096-lane tree in 3 launches, not 12.
//
// The interpreter is prog_interp.cuh's, one call site a kernel: a thread holds
// acc and one operand in registers, no call, no stack, no spill (ptxas'
// report is on chip_smoke.py's build lines).
//
// The launchers run on the caller's stream, allocate nothing, never
// synchronise, and return cudaGetLastError() (or -1 for an unsupported L,
// group size or block).
#include <cuda_runtime.h>

#include <cstdint>

#include "fp_rows.cuh"
#include "lanes.cuh"
#include "prog_interp.cuh"

namespace mlt {

// fixed slots (fexp_prog.py, tree_prog.py): f12_pow's acc and base,
// final_exp's input and output, the tree's operands A and B (the product
// over A), and the state slots of each
constexpr int kPowAcc = 0, kPowBase = 12, kPowState = 24;
constexpr int kFexpF = 0, kFexpState = 70;
constexpr int kTreeA = 0, kTreeState = 24, kTreeGroup = 8;

// script rows (fexp_prog.py, tree_prog.py): (op, a, b)
enum ScriptOp { kRun, kOne, kInv, kConst, kPair };

// Lane i's chain over the block's G lanes: its 12 input values into slots
// in_slot.., the script, then the 12 values at out_slot.. out.  Pad lanes
// (i >= lanes) run on zeros and are never stored.
template <int NW, int G>
__device__ __forceinline__ void run_script(
    const uint32_t* __restrict__ in, int in_slot, uint32_t* __restrict__ out, int out_slot,
    int lanes, const int32_t* __restrict__ script, int nsteps,
    const uint8_t* __restrict__ inv_bits, int inv_nbits, const uint32_t* __restrict__ consts,
    const FieldConsts& k, const int32_t* __restrict__ prog, const ProgMeta& m) {
  extern __shared__ uint32_t smem[];
  const int t = threadIdx.x % G, wk = threadIdx.x / G, K = m.workers;
  const int64_t i = (int64_t)blockIdx.x * G + t;
  const SlotMem<NW, G> S{smem + t, m.stride};
  uint32_t acc[NW];
  for (int q = wk; q < 12; q += K) {
    if (i < lanes) {
      load_fp<NW>(acc, in, q, lanes, i);
    } else {
#pragma unroll
      for (int j = 0; j < NW; ++j) acc[j] = 0;
    }
    S.put(in_slot + q, acc);
  }
  __syncthreads();
  for (int s = 0; s < nsteps; ++s) {
    const int op = __ldg(script + 3 * s), a = __ldg(script + 3 * s + 1),
              b = __ldg(script + 3 * s + 2);
    if (op == kRun) {  // ends at the program's last barrier
      run_phases<NW, G>(prog, a, b, K, wk, S, acc, k);
      continue;
    }
    if (op == kInv) {  // S[b] = S[a]^(p - 2): fp_pow's products, in its order
      if (wk == 0) {
        uint32_t v[NW];
        fp_copy<NW>(acc, k.one);
        for (int e = 0; e < inv_nbits; ++e) {
          fp_mul_ptx<NW>(acc, acc, acc, k);
          if (__ldg(inv_bits + e)) {
            S.get(v, a);
            fp_mul_ptx<NW>(acc, acc, v, k);
          }
        }
        S.put(b, acc);
      }
    } else {  // kOne, kConst: 12 values into slots a..
      for (int q = wk; q < 12; q += K) {
#pragma unroll
        for (int j = 0; j < NW; ++j)
          acc[j] = op == kOne ? (q == 0 ? k.one[j] : 0u) : __ldg(consts + (b + q) * NW + j);
        S.put(a + q, acc);
      }
    }
    __syncthreads();
  }
  if (i >= lanes) return;
  for (int q = wk; q < 12; q += K) {
    S.get(acc, out_slot + q);
    store_fp<NW>(out, acc, q, lanes, i);
  }
}

template <int NW, int G>
__global__ void __launch_bounds__(kProgMaxThreads)
    f12_pow_split_kernel(const uint32_t* __restrict__ base, uint32_t* __restrict__ out,
                         int lanes, const int32_t* __restrict__ script, int nsteps,
                         FieldConsts k, const int32_t* __restrict__ prog, ProgMeta m) {
  run_script<NW, G>(base, kPowBase, out, kPowAcc, lanes, script, nsteps, nullptr, 0, nullptr, k,
                    prog, m);
}

template <int NW, int G>
__global__ void __launch_bounds__(kProgMaxThreads)
    final_exp_split_kernel(const uint32_t* __restrict__ f_in, uint32_t* __restrict__ out,
                           int lanes, const int32_t* __restrict__ script, int nsteps,
                           const uint8_t* __restrict__ inv_bits, int inv_nbits,
                           const uint32_t* __restrict__ gammas, FieldConsts k,
                           const int32_t* __restrict__ prog, ProgMeta m) {
  run_script<NW, G>(f_in, kFexpF, out, kFexpF, lanes, script, nsteps, inv_bits, inv_nbits,
                    gammas, k, prog, m);
}

// `levels` levels of the product tree over each aligned run of 2G input
// lanes: lane t's A and B are input lanes 2t and 2t + 1 (pad lanes zero),
// the script alternates the product program (RUN) and PAIR rows, and lanes
// t < 2G >> levels end with the products of the block's runs of 2^levels
// input lanes, stored to out's lanes >> levels lanes.  PAIR a b: slots
// a..a+23 of lane t <- slots b..b+11 of lanes 2t and 2t + 1, worker q < 24
// moving value q; every worker reads, then all write (K >= 24).
template <int NW, int G>
__global__ void __launch_bounds__(kProgMaxThreads)
    f12_tree_split_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int lanes,
                          int levels, const int32_t* __restrict__ script, int nsteps,
                          FieldConsts k, const int32_t* __restrict__ prog, ProgMeta m) {
  extern __shared__ uint32_t smem[];
  const int t = threadIdx.x % G, wk = threadIdx.x / G, K = m.workers;
  const SlotMem<NW, G> S{smem + t, m.stride};
  uint32_t acc[NW];
  for (int q = wk; q < kTreeState; q += K) {
    const int64_t i = (int64_t)blockIdx.x * 2 * G + 2 * t + q / 12;
    if (i < lanes) {
      load_fp<NW>(acc, in, q % 12, lanes, i);
    } else {
#pragma unroll
      for (int j = 0; j < NW; ++j) acc[j] = 0;
    }
    S.put(q, acc);
  }
  __syncthreads();
  for (int s = 0; s < nsteps; ++s) {
    const int op = __ldg(script + 3 * s), a = __ldg(script + 3 * s + 1),
              b = __ldg(script + 3 * s + 2);
    if (op == kRun) {  // ends at the program's last barrier
      run_phases<NW, G>(prog, a, b, K, wk, S, acc, k);
      continue;
    }
    const int src = 2 * t + wk / 12;  // kPair
    const bool moves = wk < kTreeState && src < G;
    if (moves) {
      const SlotMem<NW, G> from{smem + src, m.stride};
      from.get(acc, b + wk % 12);
    }
    __syncthreads();
    if (moves) S.put(a + wk, acc);
    __syncthreads();
  }
  const int nout = (2 * G) >> levels;
  const int64_t o = (int64_t)blockIdx.x * nout + t, n_out = lanes >> levels;
  if (t >= nout || o >= n_out) return;
  for (int q = wk; q < 12; q += K) {
    S.get(acc, kTreeA + q);
    store_fp<NW>(out, acc, q, n_out, o);
  }
}

}  // namespace mlt

using namespace mlt;

// The program and its host meta (G, K, slots, words a slot) come last; the
// script's RUN rows hold the programs' phase ranges.
MLT_LAUNCHER(mlt_f12_pow, const uint32_t* base, const int32_t* script, int nsteps, uint32_t* out,
             int lanes, int L, const uint32_t* consts, const int32_t* prog, const int32_t* meta,
             cudaStream_t stream) {
  MLT_TO_NW9(mlt_f12_pow, base, script, nsteps, out, lanes, L, consts, prog, meta, stream)
  const ProgMeta m = prog_meta(meta, 0);
  MLT_PAIR_DISPATCH(L, MLT_PROG_GROUPS(m.group, {
    dim3 grid, block;
    size_t smem;
    if (!prog_launch_shape<NW, G>(f12_pow_split_kernel<NW, G>, m, kPowState, lanes, grid,
                                  block, smem))
      return -1;
    f12_pow_split_kernel<NW, G><<<grid, block, smem, stream>>>(
        base, out, lanes, script, nsteps, make_consts(consts, NW), prog, m);
  }))
}

MLT_LAUNCHER(mlt_final_exp, const uint32_t* f_in, const int32_t* script, int nsteps,
             const uint8_t* inv_bits, int inv_nbits, const uint32_t* gammas, uint32_t* out,
             int lanes, int L, const uint32_t* consts, const int32_t* prog, const int32_t* meta,
             cudaStream_t stream) {
  MLT_TO_NW9(mlt_final_exp, f_in, script, nsteps, inv_bits, inv_nbits, gammas, out, lanes, L,
             consts, prog, meta, stream)
  const ProgMeta m = prog_meta(meta, 0);
  MLT_PAIR_DISPATCH(L, MLT_PROG_GROUPS(m.group, {
    dim3 grid, block;
    size_t smem;
    if (!prog_launch_shape<NW, G>(final_exp_split_kernel<NW, G>, m, kFexpState, lanes, grid,
                                  block, smem))
      return -1;
    final_exp_split_kernel<NW, G><<<grid, block, smem, stream>>>(
        f_in, out, lanes, script, nsteps, inv_bits, inv_nbits, gammas, make_consts(consts, NW),
        prog, m);
  }))
}

// lanes: the input's; its lanes >> levels products go to out.  The tree
// runs in 8-lane blocks only (pairing_cuda.tree_shape).
MLT_LAUNCHER(mlt_f12_tree, const uint32_t* in, uint32_t* out, int lanes, int levels,
             const int32_t* script, int nsteps, int L, const uint32_t* consts, const int32_t* prog,
             const int32_t* meta, cudaStream_t stream) {
  MLT_TO_NW9(mlt_f12_tree, in, out, lanes, levels, script, nsteps, L, consts, prog, meta, stream)
  constexpr int G = kTreeGroup;
  const ProgMeta m = prog_meta(meta, 0);
  if (m.group != G || m.workers < kTreeState || levels < 1 || (1 << levels) > 2 * G ||
      lanes % (1 << levels))
    return -1;
  MLT_PAIR_DISPATCH(L, {
    dim3 grid, block;
    size_t smem;
    if (!prog_launch_shape<NW, G>(f12_tree_split_kernel<NW, G>, m, kTreeState, lanes / 2, grid,
                                  block, smem))
      return -1;
    f12_tree_split_kernel<NW, G><<<grid, block, smem, stream>>>(
        in, out, lanes, levels, script, nsteps, make_consts(consts, NW), prog, m);
  })
}
