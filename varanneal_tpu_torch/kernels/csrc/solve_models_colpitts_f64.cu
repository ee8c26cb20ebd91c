// K2 and K3 on Colpitts in float64: the kernels, their notes
// and the entries' arguments are row_solve.cuh's.

#include <cuda_runtime.h>

#include "row_solve.cuh"

extern "C" {

VA_ROW_SOLVE_ENTRIES(Colpitts, double, colpitts, f64)

}  // extern "C"
