// g2_dblsel_kernels.cu at nine words (NW = 9, L = 18: FP256BN's p on the card): g2_dblsel. An nvcc
// process of its own beside g2_dblsel_kernels.cu. The namespace mlt is mlt_nw9 here, and the
// launchers are g2_dblsel_kernels.cu's names with the suffix _nw9, which g2_dblsel_kernels.cu's
// own launchers call at L = 18 (words.cuh).
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#define MLT_NW9
#define mlt mlt_nw9
#include "g2_dblsel_kernels.cu"
