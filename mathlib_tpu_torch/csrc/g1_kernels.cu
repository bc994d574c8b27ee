// G1 group-law kernels for Hopper (sm_90a): port of
// mathlib_tpu/ops/kernels/g1_pallas.py.
//
//   g1_smul_kernel    <- g1_pallas.py:_smul_kernel    (smul_pallas)
//   g1_dbladd_kernel  <- g1_pallas.py:_dbladd_kernel  (dbladd_pallas)
//   g1_smul_static_kernel <- g1_pallas.py:_smul_static_kernel (smul_static_pallas)
//
// The point formulas, the lane layout and the operation order that keeps
// the relaxed limbs the reference's are in g1_rows.cuh (shared with the
// hash-to-G1 kernel).  The add, addsel, double and the MSM's signed and
// mixed scan combiners (g1_pallas.py:_add_kernel, _addsel_kernel,
// _double_kernel, _addselneg_kernel, _maddsel_kernel, _maddselneg_kernel)
// spread one formula over the warps of a block: g1_split_kernels.cu.
//
// What bounds these kernels on an H100 is the integer multiply issue rate
// and registers, not bytes: an RCB add is 12 field muls (3,456 32x32->64
// products and 144 low products, 7,056 32-bit multiply-adds at NW = 12)
// for 288 bytes in and 144 out.  The design keeps
// every operand in registers, with one lane per thread and no shared memory;
// a point is 36 words, and the add holds two points plus temporaries, so
// spills to local memory are accepted here.  Later work: the ladders (smul,
// dbladd, smul_static) over the warps of a block.
//
// Every launcher runs on the caller's stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (or -1 for an unsupported L).
#include <cuda_runtime.h>

#include <cstdint>

#include "g1_rows.cuh"

namespace mlt {

// out = sel ? 2P + Q : 2P -- one step of a double-and-add ladder
template <int NW>
__global__ void g1_dbladd_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                                 const uint8_t* __restrict__ sel, uint32_t* __restrict__ out,
                                 int n, FieldConsts k, int b3) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point<NW> a;
  load_point<NW>(a, P, n, i);
  rcb_dbl<NW>(a, a, k, b3);
  if (sel[i]) {
    Point<NW> b;
    load_point<NW>(b, Q, n, i);
    rcb_add<NW>(a, a, b, k, b3);
  }
  store_point<NW>(out, a, n, i);
}

// out = [k]Q per lane: MSB-first double, add, select from infinity; the
// accumulator stays in registers across all nbits steps
template <int NW>
__global__ void g1_smul_kernel(const uint32_t* __restrict__ Q, const uint32_t* __restrict__ s,
                               uint32_t* __restrict__ out, int n, int nbits, FieldConsts k,
                               int b3) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point<NW> q, acc, A;
  load_point<NW>(q, Q, n, i);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    acc.x[j] = 0;
    acc.y[j] = k.one[j];
    acc.z[j] = 0;
  }
  for (int b = nbits - 1; b >= 0; --b) {
    rcb_dbl<NW>(acc, acc, k, b3);
    rcb_add<NW>(A, acc, q, k, b3);
    const bool bit = (s[(int64_t)(b >> 4) * n + i] >> (b & 15)) & 1u;
    select_point<NW>(acc, bit, A, acc);
  }
  store_point<NW>(out, acc, n, i);
}

// out = [k]Q for ONE scalar shared by every lane, its MSB-first bits in a
// device array (one build serves every static scalar): a double at every
// bit, the complete add only at one-bits, from infinity -- the cofactor
// clearing of HashG1Ctx.clear_cofactor.  The branch on a bit is uniform
// across the warp.
template <int NW>
__global__ void g1_smul_static_kernel(const uint32_t* __restrict__ Q,
                                      const uint8_t* __restrict__ bits, int nbits,
                                      uint32_t* __restrict__ out, int n, FieldConsts k, int b3) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point<NW> q, acc;
  load_point<NW>(q, Q, n, i);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    acc.x[j] = 0;
    acc.y[j] = k.one[j];
    acc.z[j] = 0;
  }
  for (int b = 0; b < nbits; ++b) {
    rcb_dbl<NW>(acc, acc, k, b3);
    if (bits[b]) rcb_add<NW>(acc, acc, q, k, b3);
  }
  store_point<NW>(out, acc, n, i);
}

constexpr int kThreads = 128;
// 32 threads a block for the ladders of one static scalar: 4,096 lanes then
// spread over 128 SMs instead of 32 blocks of 128 lanes on 32 SMs.
constexpr int kLadderThreads = 32;

inline dim3 grid_for(int n, int threads = kThreads) {
  return dim3((unsigned)((n + threads - 1) / threads));
}

}  // namespace mlt

using namespace mlt;

// instantiate for L = 16 (BN254's p) and L = 24 (BLS12-381's and BLS12-377's p)
#define MLT_DISPATCH(L, ...)             \
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

extern "C" int mlt_g1_smul(const uint32_t* Q, const uint32_t* s, uint32_t* out, int n, int L,
                           int S, int nbits, const uint32_t* consts, int b3,
                           cudaStream_t stream) {
  if (nbits > 16 * S) return -1;
  MLT_DISPATCH(L, g1_smul_kernel<NW><<<grid_for(n), kThreads, 0, stream>>>(
                      Q, s, out, n, nbits, make_consts(consts, NW), b3))
}

extern "C" int mlt_g1_dbladd(const uint32_t* P, const uint32_t* Q, const uint8_t* sel,
                             uint32_t* out, int n, int L, const uint32_t* consts, int b3,
                             cudaStream_t stream) {
  MLT_DISPATCH(L, g1_dbladd_kernel<NW><<<grid_for(n), kThreads, 0, stream>>>(
                      P, Q, sel, out, n, make_consts(consts, NW), b3))
}

extern "C" int mlt_g1_smul_static(const uint32_t* Q, const uint8_t* bits, int nbits, uint32_t* out,
                                  int n, int L, const uint32_t* consts, int b3,
                                  cudaStream_t stream) {
  MLT_DISPATCH(L, g1_smul_static_kernel<NW>
               <<<grid_for(n, kLadderThreads), kLadderThreads, 0, stream>>>(
                   Q, bits, nbits, out, n, make_consts(consts, NW), b3))
}
