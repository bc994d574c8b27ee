// Row gathers for Hopper (sm_90a): port of
// mathlib_tpu/ops/kernels/gather_pallas.py
//
//   gather_rows_kernel    <- _build (:31, gather_rows_pallas :141):
//                            out[m, :] = table[idx[m], :]
//   gather_rows_t_kernel  <- _build_t (:79, gather_rows_t_pallas :133):
//                            out[:, m] = table[idx[m], :], the gather and the
//                            point-major -> lane-major relayout in one pass
//
// The TPU kernels issue one DMA a row from HBM, the indices in SMEM.  Here a
// row of the table is contiguous (72 words for a projective BLS12-381 point,
// 48 for an affine one), so:
//   * gather_rows: one warp a row, its lanes copying consecutive words;
//   * gather_rows_t: a block takes a tile of 32 indices.  Its threads read
//     the tile's rows with consecutive threads on consecutive words of a row
//     into shared memory (tile[word][row], rows padded to 33 words so that
//     neither side conflicts on a bank), then write the tile's columns with
//     consecutive threads on consecutive lanes m of one output row: every
//     warp stores 128 contiguous bytes.  Wider rows go through the tile 128
//     words at a time.
// No bounds check on the indices (the wrapper checks device, dtype and
// shape); any M, the ragged last tile masked.
//
// Bound on this card: bytes.  Each gathered row is read once and written
// once (M * Wr * 4 bytes each way) and the indices read once; no arithmetic.
//
// Every launcher runs on the caller's stream, allocates nothing, never
// synchronises, and returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

namespace mlt {

constexpr int kGatherTile = 32;     // indices a block of gather_rows_t
constexpr int kGatherCols = 128;    // words of a row a pass through the tile
constexpr int kGatherThreads = 256;

template <typename Idx>
__global__ void gather_rows_kernel(const uint32_t* __restrict__ table, const Idx* __restrict__ idx,
                                   uint32_t* __restrict__ out, int64_t m_rows, int wr) {
  const int64_t m = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (m >= m_rows) return;
  const uint32_t* src = table + (int64_t)idx[m] * wr;
  uint32_t* dst = out + m * wr;
  for (int w = threadIdx.x % 32; w < wr; w += 32) dst[w] = src[w];
}

template <typename Idx>
__global__ void gather_rows_t_kernel(const uint32_t* __restrict__ table,
                                     const Idx* __restrict__ idx, uint32_t* __restrict__ out,
                                     int64_t m_rows, int wr) {
  __shared__ uint32_t tile[kGatherCols][kGatherTile + 1];
  __shared__ int64_t rows[kGatherTile];
  const int64_t m0 = (int64_t)blockIdx.x * kGatherTile;
  const int nt = m_rows - m0 < kGatherTile ? (int)(m_rows - m0) : kGatherTile;
  if (threadIdx.x < nt) rows[threadIdx.x] = (int64_t)idx[m0 + threadIdx.x];
  __syncthreads();
  for (int w0 = 0; w0 < wr; w0 += kGatherCols) {
    const int nw = wr - w0 < kGatherCols ? wr - w0 : kGatherCols;
    for (int e = threadIdx.x; e < nt * nw; e += blockDim.x) {
      const int r = e / nw, w = e % nw;
      tile[w][r] = table[rows[r] * wr + w0 + w];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nw * kGatherTile; e += blockDim.x) {
      const int w = e / kGatherTile, r = e % kGatherTile;
      if (r < nt) out[(int64_t)(w0 + w) * m_rows + m0 + r] = tile[w][r];
    }
    __syncthreads();
  }
}

}  // namespace mlt

using namespace mlt;

// idx64: the indices are int64 (else int32)
extern "C" int mlt_gather_rows(const uint32_t* table, const void* idx, int idx64, uint32_t* out,
                               int64_t m_rows, int wr, cudaStream_t stream) {
  const int rows_a_block = kGatherThreads / 32;
  const dim3 grid((unsigned)((m_rows + rows_a_block - 1) / rows_a_block));
  if (idx64)
    gather_rows_kernel<int64_t><<<grid, kGatherThreads, 0, stream>>>(
        table, (const int64_t*)idx, out, m_rows, wr);
  else
    gather_rows_kernel<int32_t><<<grid, kGatherThreads, 0, stream>>>(
        table, (const int32_t*)idx, out, m_rows, wr);
  return (int)cudaGetLastError();
}

extern "C" int mlt_gather_rows_t(const uint32_t* table, const void* idx, int idx64,
                                 uint32_t* out, int64_t m_rows, int wr, cudaStream_t stream) {
  const dim3 grid((unsigned)((m_rows + kGatherTile - 1) / kGatherTile));
  if (idx64)
    gather_rows_t_kernel<int64_t><<<grid, kGatherThreads, 0, stream>>>(
        table, (const int64_t*)idx, out, m_rows, wr);
  else
    gather_rows_t_kernel<int32_t><<<grid, kGatherThreads, 0, stream>>>(
        table, (const int32_t*)idx, out, m_rows, wr);
  return (int)cudaGetLastError();
}
