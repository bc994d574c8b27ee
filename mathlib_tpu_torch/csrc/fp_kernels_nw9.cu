// fp_kernels.cu at nine words (NW = 9, L = 18: FP256BN's p on the card): mont_mul_kernel and
// fp_pow_kernel, the one-thread bodies (nine words do not split into the group bodies' four
// slices). An nvcc process of its own beside fp_kernels.cu. The namespace mlt is mlt_nw9 here, and
// the launchers are fp_kernels.cu's names with the suffix _nw9, which fp_kernels.cu's own
// launchers call at L = 18 (words.cuh).
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#define MLT_NW9
#define mlt mlt_nw9
#include "fp_kernels.cu"
