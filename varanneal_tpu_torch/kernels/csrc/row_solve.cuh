// K2 and K3 on Hopper on the built-in row-level models (NaKL with or
// without its stimulus, Colpitts, Lorenz-63): the whole L-BFGS rung solve
// (K2; unbounded, or bounded by the projection algorithm) under the four
// rules with a scalar or (N-1, D) rf, and the whole warm-started ladder
// (K3) at a scalar rf, each in one launch, one thread block per member.
//
// Replaces varanneal_tpu/kernels/solve_pallas.py::_solve_kernel and
// ::_ladder_kernel on those models (the reference traces the model into
// its K1 forward with jax.vjp). The kernels, their layouts and their
// solve body are solve_kernel.cu's (l96_solve_kernels.cuh, l96_solve.cuh),
// instantiated on RowProblem<Model, T>: each evaluation is
// row_ag_block.cuh's walk by thread, the body of K1 on these models
// (ag_models_kernel.cu), which takes the rule and the rf kind at run time,
// its partials and parameter row in the group's ring area (ring_cols). So
// one instantiation of each kernel serves every rule.
//
// What bounds it on the card: as K2 and K3 (solve_kernel.cu), the serial
// depth of a member's chain of evaluations and group reductions, one
// block a member; an evaluation walks ~N/256 rows a thread. Sums are
// reduced in a fixed order with no atomics: repeated launches give
// bit-identical results.
//
// One source a model and dtype (solve_models_<model>_<f32|f64>.cu), each
// one library, so that the build runs their six nvcc in parallel; each
// holds VA_ROW_SOLVE_ENTRIES of its model and dtype.
#pragma once

#include <cuda_runtime.h>

#include "l96_solve_kernels.cuh"

namespace {

template <typename Model, typename T, int kChunk>
const void* row_solve_fn(int ladder, int bounded) {
    using P = RowProblem<Model, T>;
    if (ladder) return (const void*)l96_ladder_kernel<P, T, kChunk>;
    return bounded ? (const void*)l96_solve_kernel<P, T, true, kChunk>
                   : (const void*)l96_solve_kernel<P, T, false, kChunk>;
}

// The attributes of the kernel a launch of (ladder, bounded) under
// `layout` runs, as va_l96_solve_attrs gives them.
template <typename Model, typename T>
int row_solve_attrs(int ladder, int bounded, int layout, int* out) {
    cudaFuncAttributes a;
    const void* fn = chunk_of(layout) == 1
                         ? row_solve_fn<Model, T, 1>(ladder, bounded)
                         : row_solve_fn<Model, T, kChunkGlobal>(ladder,
                                                                bounded);
    const cudaError_t e = cudaFuncGetAttributes(&a, fn);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = a.maxThreadsPerBlock;
    out[3] = kThreads;
    return 0;
}

}  // namespace

// The entries of MODEL in T (name, sfx: their names' parts). Arguments:
// ag_models_kernel.cu's problem (VA_ROW_ARGS), the options as
// solve_kernel.cu's entries take them, the layout's flags, then K2: rf
// (a scalar, or rfd in the problem), the box (lo/hi NULL when unbounded,
// bnd_stride 0 when shared by the members), the workspace and the outputs
// (X_out, G_out (B, n_dof), fp_out (B, 2) [f, pgnorm], cnt_out (B, 3)
// int32 [niter, nfev, status]); K3: the (k,) rung values rfs (rfd NULL),
// the workspace and the outputs (X_out, rec (B, k, 3) [A, ME, pgnorm],
// rec_i (B, k, 3) int32 [niter, nfev, status]). Each returns the
// cudaError_t of the launch.
#define VA_ROW_SOLVE_ENTRIES(MODEL, T, name, sfx)                           \
    int va_##name##_solve_##sfx(                                            \
            const void* XP, int B, VA_ROW_ARGS, int m, int maxiter,         \
            int maxls, double c1, double c2, double pgtol, double ftol,     \
            int layout, double rf, const void* lo, const void* hi,          \
            int bnd_stride, void* work, void* X_out, void* G_out,           \
            void* fp_out, void* cnt_out, void* stream) {                    \
        if (!row_ok<MODEL>(disc, N, n_dof, n_est))                          \
            return (int)cudaErrorInvalidValue;                              \
        return launch_solve(row_problem<MODEL, T>(VA_ROW_PASS), VA_OPTS(T), \
                            B, layout, rf, XP, lo, hi, bnd_stride, work,    \
                            X_out, G_out, fp_out, cnt_out, stream);         \
    }                                                                       \
    int va_##name##_ladder_##sfx(                                           \
            const void* XP, int B, VA_ROW_ARGS, int m, int maxiter,         \
            int maxls, double c1, double c2, double pgtol, double ftol,     \
            int layout, const void* rfs, int k_rungs, void* work,           \
            void* X_out, void* rec, void* rec_i, void* stream) {            \
        if (!row_ok<MODEL>(disc, N, n_dof, n_est) || rfd != nullptr)        \
            return (int)cudaErrorInvalidValue;                              \
        return launch_ladder(row_problem<MODEL, T>(VA_ROW_PASS),            \
                             VA_OPTS(T), B, layout, rfs, k_rungs, XP, work, \
                             X_out, rec, rec_i, stream);                    \
    }                                                                       \
    int va_##name##_solve_attrs_##sfx(int ladder, int bounded, int layout,  \
                                      int* out) {                           \
        return row_solve_attrs<MODEL, T>(ladder, bounded, layout, out);     \
    }                                                                       \
    const char* va_cuda_error_string(int code) {                            \
        return cudaGetErrorString((cudaError_t)code);                       \
    }
