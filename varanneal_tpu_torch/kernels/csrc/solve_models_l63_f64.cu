// K2 and K3 on Lorenz-63 in float64: the kernels, their notes
// and the entries' arguments are row_solve.cuh's.

#include <cuda_runtime.h>

#include "row_solve.cuh"

extern "C" {

VA_ROW_SOLVE_ENTRIES(L63, double, l63, f64)

}  // extern "C"
