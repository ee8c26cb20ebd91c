// K2 and K3 on NaKL in float32: the kernels, their notes
// and the entries' arguments are row_solve.cuh's.

#include <cuda_runtime.h>

#include "row_solve.cuh"

extern "C" {

VA_ROW_SOLVE_ENTRIES(NaKL, float, nakl, f32)

}  // extern "C"
