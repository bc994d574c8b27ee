// The G1 group-law kernel for Hopper (sm_90a) that runs one lane a thread:
// port of mathlib_tpu/ops/kernels/g1_pallas.py.
//
//   g1_dbladd_kernel  <- g1_pallas.py:_dbladd_kernel  (dbladd_pallas)
//
// The point formulas, the lane layout and the operation order that keeps
// the relaxed limbs the reference's are in g1_rows.cuh (shared with the
// hash-to-G1 kernel).  The add, addsel, double, the MSM's signed and mixed
// scan combiners and the ladders smul and smul_static (g1_pallas.py:
// _add_kernel, _addsel_kernel, _double_kernel, _addselneg_kernel,
// _maddsel_kernel, _maddselneg_kernel, _smul_kernel, _smul_static_kernel)
// spread one formula over the warps of a block: g1_split_kernels.cu.
//
// What bounds these kernels on an H100 is the integer multiply issue rate
// and registers, not bytes: an RCB add is 12 field muls (3,456 32x32->64
// products and 144 low products, 7,056 32-bit multiply-adds at NW = 12)
// for 288 bytes in and 144 out.  The design keeps
// every operand in registers, with one lane per thread and no shared memory;
// a point is 36 words, and the add holds two points plus temporaries, so
// spills to local memory are accepted here.  The ladder step here (dbladd)
// can run on the layers of g1_split_kernels.cu, as the ladders do.
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

constexpr int kThreads = 128;

inline dim3 grid_for(int n) { return dim3((unsigned)((n + kThreads - 1) / kThreads)); }

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

extern "C" int mlt_g1_dbladd(const uint32_t* P, const uint32_t* Q, const uint8_t* sel,
                             uint32_t* out, int n, int L, const uint32_t* consts, int b3,
                             cudaStream_t stream) {
  MLT_DISPATCH(L, g1_dbladd_kernel<NW><<<grid_for(n), kThreads, 0, stream>>>(
                      P, Q, sel, out, n, make_consts(consts, NW), b3))
}
