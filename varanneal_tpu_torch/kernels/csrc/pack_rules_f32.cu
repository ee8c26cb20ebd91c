// K8 under Lorenz-96's other rules and the (N-1, D) rf in float, in groups
// of G = 64 or 32 threads: the entries are pack_kernels.cuh's
// VA_RULE_PACK_ENTRIES, the kernel and its notes pack_kernels.cuh's and
// pack_kernel.cu's, each evaluation l96_rule_block over the group (K2's
// under these rules, l96_solve_rules.cuh).

#include <cuda_runtime.h>

#include "l96_solve_rules.cuh"
#include "pack_kernels.cuh"

extern "C" {

VA_RULE_PACK_ENTRIES(float, f32)

}  // extern "C"
