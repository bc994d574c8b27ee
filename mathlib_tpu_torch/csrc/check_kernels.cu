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
// Bound on this card: integer multiplies.  A BLS12-381 lane runs 7,786 field
// products in its Miller loop, the tree 54 a lane, the final exp 8,675 once,
// each of 588 32-bit multiply-adds; bytes are 288 a lane in, 580 out.  The
// Miller loops spread over the card; the final exp is one serial chain after
// every Miller loop has ended, so at 4,096 lanes the check takes about one
// block's Miller loops, the tree's levels and one lane's final exp.
//
// Hopper runs blocks in no order, so nothing carries across a grid.  The
// kernel runs the split kernels' programs (ops/kernels/miller_prog.py,
// tree_prog.py, fexp_prog.py) on their interpreter (prog_interp.cuh), as a
// script the host builds once per curve, block and tree width
// (ops/kernels/check_prog.py has the rows):
//
//   part 1, a block of G lanes and K workers (the split Miller kernels'
//   block: 32 x 32 at 4,096 BLS12-381 lanes, 218 KB of slots):
//     1. each lane's Miller loop, one program a loop bit and the tail, as
//        miller_lanes_split_kernel runs it, f left in slots 0-11 (the tree's
//        A); a block with no lane below nvalid skips it;
//     2. lanes >= nvalid, the pad lanes up to the tree's width W among them,
//        take the f12 one (MASK);
//     3. the block's product: log2(min(G, W)) levels of the tree's program,
//        a PAIR row before each (lane t's A, B <- lanes 2t and 2t + 1's A);
//     4. lane 0 stores the block's product to its scratch slot (__stcg),
//        fences and takes a ticket (atomicAdd); every block but the last to
//        take one leaves;
//     5. the last block loads the partials 2G at a time (lane t's A and B
//        <- partials 2t and 2t + 1, __ldcg), runs the tree's levels and
//        stores each chunk's product back, round after round, until one is
//        left (at 4,096 lanes and G = 32: 128 partials, two chunks of 64
//        through 6 levels, then one level), and writes it to prod_out.
//        Every level pairs lanes 2i and 2i + 1, so the product is
//        f12_seg_product's over the W lanes, bit for bit;
//   part 2, after a barrier, the same block as 8 lanes of 64 workers (the
//   final-exp kernel's block for one lane; its 189 slots at BLS12-381 take
//   8-lane slots, 78 KB), the threads past 512 meeting the barriers only:
//     6. the product into lane 0's input slots, the BLS12 final-exp script
//        (RUN, ONE, INV, CONST rows, as final_exp_split_kernel runs them),
//        the canonical unity test, ok_out, and the ticket back to 0.
//
// One row loop (check_rows) runs both parts, a template per slot layout, so
// the interpreter has one call site a layout.  A thread holds acc and one
// operand in registers: no stack, no spill (ptxas' report is on
// chip_smoke.py's build lines).  The one-thread design before it ran a lane
// a thread with the Miller loop, the product and the final exp on its stack
// (255 registers, 7,840 bytes of stack): 45 ms at 4,096 lanes, 40 times its
// bound, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6).
//
// The scratch and the ticket are the caller's (pairing_cuda.py keeps one pair
// per device and stream, the ticket zeroed once at allocation): calls that
// share them are serialised on the caller's stream, so no two launches ever
// race on the ticket, and no memset runs per call.
//
// The launcher runs on the caller's stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (or -1 for an unsupported L,
// group size or block).
#include <cuda_runtime.h>

#include <cstdint>

#include "fp_rows.cuh"
#include "lanes.cuh"
#include "miller_state.cuh"
#include "prog_interp.cuh"

namespace mlt {

// part 2's lanes (check_prog.FEXP_GROUP) and the final exp's fixed input
// and output slot (fexp_prog.F)
constexpr int kCheckFexpGroup = 8, kCheckFexpF = 0;

// script rows (check_prog.py): (op, a, b)
enum CheckOp { kCkRun, kCkOne, kCkInv, kCkConst, kCkPair, kCkSkip, kCkMask, kCkPublish,
               kCkLoad, kCkStore, kCkProd };

// the host meta: part 1's block (G lanes, K workers, slots, words a slot),
// part 2's (its workers, slots, words a slot), and the offsets into the one
// code array of part 2's programs and of the two scripts, with their rows
// (part 1's programs start at 0)
struct CheckMeta {
  int group, workers, slots, stride;
  int workers2, slots2, stride2;
  int prog2, script1, rows1, script2, rows2;
};

struct CheckIO {
  const uint32_t* xp;
  const uint32_t* yp;
  const uint32_t* qx;
  const uint32_t* qy;
  const uint8_t* inv_bits;
  int inv_nbits;
  const uint32_t* gammas;
  uint32_t* ok_out;
  uint32_t* prod_out;
  uint32_t* scratch;  // the partials: [block][12][NW] words
  unsigned int* ticket;
  int nvalid, lanes;
};

// Rows [0, nrows) of a script on a layout of GS lanes (words a slot:
// stride): this thread is lane t, worker wk of K (IDLE: threads past the K
// workers meet the barriers only); lane0 is the block's first lane of the
// check.  Returns false where the block leaves (PUBLISH in every block but
// the last).  Laid out as the final-exp and tree kernels' row loops: the
// same rows as a switch gave wrong products after a PAIR row on an H100.
template <int NW, int GS, bool IDLE>
__device__ __forceinline__ bool check_rows(const int32_t* __restrict__ script, int nrows,
                                           const int32_t* __restrict__ prog, int K, int wk,
                                           int t, int stride, uint32_t* acc, const CheckIO& io,
                                           int64_t lane0, const FieldConsts& k) {
  extern __shared__ uint32_t smem[];
  __shared__ bool last;
  const SlotMem<NW, GS> S{smem + t, stride};
  for (int s = 0; s < nrows; ++s) {
    const int op = __ldg(script + 3 * s), a = __ldg(script + 3 * s + 1),
              b = __ldg(script + 3 * s + 2);
    if (op == kCkRun) {  // ends at the program's last barrier
      run_phases<NW, GS, IDLE>(prog, a, b, K, wk, S, acc, k);
      continue;
    }
    if (op == kCkSkip) {  // the block's Miller rows, where no lane is real
      if (lane0 >= io.nvalid) s += a;
      continue;
    }
    if (op == kCkPair) {  // slots a..a+23 of lane t <- slots b..b+11 of lanes 2t, 2t + 1
      const int src = 2 * t + wk / 12;
      const bool moves = wk < 24 && src < GS;
      if (moves) {
        const SlotMem<NW, GS> from{smem + src, stride};
        from.get(acc, b + wk % 12);
      }
      __syncthreads();
      if (moves) S.put(a + wk, acc);
      __syncthreads();
      continue;
    }
    if (op == kCkPublish) {  // the block's product to its partial; the ticket
      if (t == 0) {
        for (int q = wk; q < 12; q += K) {
          S.get(acc, q);
          uint32_t* dst = io.scratch + ((int64_t)blockIdx.x * 12 + q) * NW;
#pragma unroll
          for (int j = 0; j < NW; ++j) __stcg(dst + j, acc[j]);
        }
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) last = atomicAdd(io.ticket, 1u) == gridDim.x - 1;
      __syncthreads();
      if (!last) return false;
      __threadfence();
      continue;
    }
    if (op == kCkInv) {  // S[b] = S[a]^(p - 2): fp_pow's products, in its order
      if (wk == 0) {
        uint32_t v[NW];
        fp_copy<NW>(acc, k.one);
        for (int e = 0; e < io.inv_nbits; ++e) {
          fp_mul_ptx<NW>(acc, acc, acc, k);
          if (__ldg(io.inv_bits + e)) {
            S.get(v, a);
            fp_mul_ptx<NW>(acc, acc, v, k);
          }
        }
        S.put(b, acc);
      }
    } else if (op == kCkOne || op == kCkConst) {  // 12 values into slots a..
      for (int q = wk; q < 12; q += K) {
#pragma unroll
        for (int j = 0; j < NW; ++j)
          acc[j] = op == kCkOne ? (q == 0 ? k.one[j] : 0u) : __ldg(io.gammas + (b + q) * NW + j);
        S.put(a + q, acc);
      }
    } else if (op == kCkMask) {  // lanes at or past nvalid: f = the f12 one
      if (lane0 + t >= io.nvalid) {
        for (int q = wk; q < 12; q += K) {
#pragma unroll
          for (int j = 0; j < NW; ++j) acc[j] = q == 0 ? k.one[j] : 0u;
          S.put(q, acc);
        }
      }
    } else if (op == kCkLoad) {  // lane t's A, B <- partials a + 2t, a + 2t + 1 (below a + b)
      for (int q = wk; q < 24; q += K) {
        const int src = 2 * t + q / 12;
        if (src < b) {
          const uint32_t* from = io.scratch + ((int64_t)(a + src) * 12 + q % 12) * NW;
#pragma unroll
          for (int j = 0; j < NW; ++j) acc[j] = __ldcg(from + j);
          S.put(q, acc);
        }
      }
    } else if (t == 0) {  // STORE: lane 0's A -> partial a; PROD: -> the product
      for (int q = wk; q < 12; q += K) {
        S.get(acc, q);
        if (op == kCkStore) {
          uint32_t* dst = io.scratch + ((int64_t)a * 12 + q) * NW;
#pragma unroll
          for (int j = 0; j < NW; ++j) __stcg(dst + j, acc[j]);
        } else {
          store_fp<NW>(io.prod_out, acc, q, 1, 0);
        }
      }
    }
    __syncthreads();
  }
  return true;
}

// ok_out[0] = prod_i e(P_i, Q_i) == 1 over lanes i < nvalid; prod_out
// (12, L, 1) = the unreduced product.  The grid is W / G blocks (one when
// W <= G), W the next power of two >= lanes; scratch holds a partial a block.
template <int NW, int G>
__global__ void __launch_bounds__(kProgMaxThreads)
    pairing_check_kernel(CheckIO io, FieldConsts k, TowerConsts tc,
                         const int32_t* __restrict__ code, CheckMeta m) {
  extern __shared__ uint32_t smem[];
  uint32_t acc[NW];
  {  // part 1: the Miller loops, the block's tree, the partials' rounds
    const int t = threadIdx.x % G, wk = threadIdx.x / G;
    const int64_t lane0 = (int64_t)blockIdx.x * G, i = lane0 + t;
    const SlotMem<NW, G> S{smem + t, m.stride};
    miller_state<NW, G>(io.xp, io.yp, io.qx, io.qy, i < io.nvalid, i, io.lanes, wk, m.workers, S,
                        acc, k, tc);
    __syncthreads();
    if (!check_rows<NW, G, false>(code + m.script1, m.rows1, code, m.workers, wk, t, m.stride,
                                  acc, io, lane0, k))
      return;
  }
  // part 2: the final exp of the product on lane 0 of 8, and the unity test
  const int t = threadIdx.x % kCheckFexpGroup, wk = threadIdx.x / kCheckFexpGroup;
  const SlotMem<NW, kCheckFexpGroup> S{smem + t, m.stride2};
  for (int q = wk; q < 12; q += m.workers2) {
    if (t == 0) {
      load_fp<NW>(acc, io.prod_out, q, 1, 0);
    } else {
#pragma unroll
      for (int j = 0; j < NW; ++j) acc[j] = 0;
    }
    S.put(kCheckFexpF + q, acc);
  }
  __syncthreads();
  check_rows<NW, kCheckFexpGroup, true>(code + m.script2, m.rows2, code + m.prog2, m.workers2,
                                        wk, t, m.stride2, acc, io, 0, k);
  // every coefficient canonical against the f12 one's: a flag in shared
  // memory (__syncthreads_and here met an illegal instruction on the card)
  __shared__ int one;
  if (threadIdx.x == 0) one = 1;
  __syncthreads();
  if (t == 0 && wk < 12) {
    S.get(acc, kCheckFexpF + wk);
    fp_canon<NW>(acc, acc, k);
    bool eq = true;
#pragma unroll
    for (int j = 0; j < NW; ++j) eq = eq && acc[j] == (wk == 0 ? k.one[j] : 0u);
    if (!eq) one = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    io.ok_out[0] = one ? 1u : 0u;
    *io.ticket = 0u;
  }
}

inline CheckMeta check_meta(const int32_t* meta) {
  CheckMeta m;
  m.group = meta[0];
  m.workers = meta[1];
  m.slots = meta[2];
  m.stride = meta[3];
  m.workers2 = meta[4];
  m.slots2 = meta[5];
  m.stride2 = meta[6];
  m.prog2 = meta[7];
  m.script1 = meta[8];
  m.rows1 = meta[9];
  m.script2 = meta[10];
  m.rows2 = meta[11];
  return m;
}

}  // namespace mlt

using namespace mlt;

// blocks: W / G (one when W <= G); the code array holds part 1's programs,
// part 2's, then the two scripts, at the meta's offsets.
extern "C" int mlt_pairing_check(const uint32_t* xp, const uint32_t* yp, const uint32_t* qx,
                                 const uint32_t* qy, int nvalid, const uint8_t* inv_bits,
                                 int inv_nbits, const uint32_t* gammas, uint32_t* ok_out,
                                 uint32_t* prod_out, uint32_t* scratch, unsigned int* ticket,
                                 int lanes, int blocks, int L, const uint32_t* consts,
                                 const int32_t* tower_ints, const uint32_t* tail,
                                 const int32_t* code, const int32_t* meta, cudaStream_t stream) {
  const CheckMeta m = check_meta(meta);
  const int valid = nvalid < 0 ? 0 : (nvalid > lanes ? lanes : nvalid);
  const CheckIO io = {xp,       yp,      qx,      qy,     inv_bits, inv_nbits, gammas,
                      ok_out,   prod_out, scratch, ticket, valid,    lanes};
  if (blocks < 1 || m.workers < 24) return -1;  // PAIR and LOAD move 24 values a lane
  MLT_PAIR_DISPATCH(L, MLT_PROG_GROUPS(m.group, {
    const int threads = m.workers * G;
    const size_t words1 = (size_t)m.slots * m.stride, words2 = (size_t)m.slots2 * m.stride2;
    const size_t smem = (words1 > words2 ? words1 : words2) * sizeof(uint32_t);
    if (threads > kProgMaxThreads || m.workers2 * kCheckFexpGroup > threads ||
        m.slots < kStateSlots || m.stride < NW * G || m.stride2 < NW * kCheckFexpGroup ||
        cudaFuncSetAttribute(pairing_check_kernel<NW, G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess)
      return -1;
    pairing_check_kernel<NW, G><<<blocks, threads, smem, stream>>>(
        io, make_consts(consts, NW), tower_consts(tower_ints, tail, NW), code, m);
  }))
}
