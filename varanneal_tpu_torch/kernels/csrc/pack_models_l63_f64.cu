// K8 on Lorenz-63 in float64: the kernel at G = 64 and 32, its notes and the
// entries' arguments are pack_kernels.cuh's and pack_kernel.cu's; each
// evaluation is row_ag_block.cuh's walk by thread over the group.

#include <cuda_runtime.h>

#include "pack_kernels.cuh"

extern "C" {

VA_ROW_PACK_ENTRIES(L63, double, l63, f64)

}  // extern "C"
