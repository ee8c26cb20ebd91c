// K2 and K3 on Hopper under Lorenz-96's other rules: the whole L-BFGS rung
// solve (K2; unbounded, or bounded by the projection algorithm) under
// Euler, the forward map, Hermite-Simpson or the trapezoid rule with a
// scalar rf or an (N-1, D) one, and the whole warm-started ladder (K3)
// under those rules with a scalar rf, each in one launch, one thread
// block per member.
//
// Replaces varanneal_tpu/kernels/solve_pallas.py::_solve_kernel and
// ::_ladder_kernel for those rules (rf_mode 'scalar', 'diag' and 'diag_sh'
// there; the reference's ladder takes a scalar rf only). The trapezoid
// rule with a scalar rf is solve_kernel.cu's. The kernels, their layouts
// and their solve body are solve_kernel.cu's (l96_solve_kernels.cuh,
// l96_solve.cuh), instantiated on L96RuleProblem: the problem carries the
// rule and the (N-1, D) rf's rows, and each evaluation is l96_rule_block
// (l96_ag_block.cuh), the body of K1's rules' entries (ag_rules_kernel.cu),
// which takes the rule and the rf kind at run time. So one instantiation
// of each kernel serves every rule, and the build adds solve_kernel.cu's
// twelve kernels once, not once a rule.
//
// What bounds it on the card: as K2 and K3 (solve_kernel.cu), the serial
// depth of a member's chain of evaluations and group reductions, one
// block per member; the rule changes only the evaluation's walk
// (Hermite-Simpson: a walk by steps of two rows, l96_ag_block.cuh), and
// an (N-1, D) rf adds one read of its N*D values an evaluation. Sums are
// reduced in a fixed order with no atomics: repeated launches give
// bit-identical results.
//
// This header holds the launches; solve_rules_f32.cu and
// solve_rules_f64.cu, one library each, hold the entries of one dtype
// and six of the kernels, so that the build runs their two nvcc in
// parallel (one source with both dtypes was the build's longest
// compile by far).

#pragma once

#include <cuda_runtime.h>

#include "l96_solve_kernels.cuh"

namespace {

// The problem of VA_SOLVE_ARGS under the rule disc and the rf rows rfd.
template <typename T>
L96RuleProblem<T> rule_problem(const L96Problem<T>& base, int disc,
                               const void* rfd) {
    L96RuleProblem<T> p;
    static_cast<L96Problem<T>&>(p) = base;
    p.disc = disc;
    p.rfd = static_cast<const T*>(rfd);
    return p;
}

template <typename T, int kChunk>
const void* rule_fn(int ladder, int bounded) {
    using P = L96RuleProblem<T>;
    if (ladder) return (const void*)l96_ladder_kernel<P, T, kChunk>;
    return bounded ? (const void*)l96_solve_kernel<P, T, true, kChunk>
                   : (const void*)l96_solve_kernel<P, T, false, kChunk>;
}

// The attributes of the kernel a launch of (ladder, bounded) under
// `layout` runs, as va_l96_solve_attrs gives them.
template <typename T>
int rule_attrs(int ladder, int bounded, int layout, int* out) {
    cudaFuncAttributes a;
    const void* fn = chunk_of(layout) == 1
                         ? rule_fn<T, 1>(ladder, bounded)
                         : rule_fn<T, kChunkGlobal>(ladder, bounded);
    const cudaError_t e = cudaFuncGetAttributes(&a, fn);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = a.maxThreadsPerBlock;
    out[3] = kThreads;
    return 0;
}

}  // namespace
