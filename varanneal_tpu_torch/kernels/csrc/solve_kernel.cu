// K2 and K3 on Hopper: the whole unbounded L-BFGS rung solve (K2) and a
// whole warm-started ladder of rungs (K3) inside one launch, one thread
// block per ensemble member.
//
// Replaces varanneal_tpu/kernels/solve_pallas.py::_solve_kernel (K2,
// launched by _solve_batched) and ::_ladder_kernel (K3, launched by
// _ladder_batched), whose shared body _solve_one is transcribed here as
// solve_one: the two-loop direction over a circular m-history, the
// strong-Wolfe bracket/zoom line search with cubic interpolation, the
// curvature-gated history write and the statuses 0 pgtol, 1 ftol,
// 2 maxiter, 3 line-search failure. Each evaluation is the block routine
// l96_ag_block (l96_ag_block.cuh), the body of K1, so the solve computes
// K1's function.
//
// K2's bounded branch (solve_one<T, true>, _solve_one with bnd_vals set:
// the projection algorithm of opt/lbfgs.py) takes box bounds lo/hi (+-inf
// for a free side) from global memory, per member or shared: the start
// projected into the box; components at a bound (within 1e-12, added in
// T) whose gradient pushes out frozen out of the direction (the two-loop
// recursion on the masked gradient, the direction masked, -g_free on
// non-descent); Armijo backtracking along the projected path P(x + a d)
// against g0·(P(x + a d) - x), halving, nfev = trials, strict decrease,
// the step rejected on failure; pgtol on the projected gradient
// x - P(x - g). K3 stays unbounded, as in the JAX package.
//
// The port's flat layout: a member's decision vector is its n_dof =
// N*D (+1 when F is estimated) values, as K1 reads them. The TPU kernel's
// (N_pad, D_pad) + (1, NP_pad) tiles and its parameter mask have no
// counterpart: a frozen parameter is not in the vector at all.
//
// Control flow is block-uniform. Every scalar of the solve (the line
// search's 18-field carry, the history head and length, the counts) is
// computed redundantly by every thread from sums that every thread reads
// back after a fixed-order block reduction, so every thread takes every
// branch together and no __syncthreads() inside an evaluation is reached
// by part of the block. Vector passes touch only the thread's own strided
// entries; only the evaluation reads neighbours, after a barrier.
//
// Memory: a member's vectors (x, g, d, the trial x and g), its m-pair
// history (S, Y and the pairs' s.y, y.y) and, bounded, its box go to
// shared memory where they fit, each group whole or not at all, in that
// order of priority; the rest lives in a per-member global workspace.
// The wrapper's planner (kernels/solve.py::plan_layout) chooses the
// layout from the shape, the dtype and the batch and passes it as an
// argument: at the main shape in f32 (n_dof = 3,221, m = 5) everything is
// on chip, 196 KB of the 227 KB a block may have (221 KB with the box, the
// facade's Quick start); in f64 the vectors and the box, not the history.
// Above one member per SM the planner keeps the global layout (a rule
// set when that layout ran two blocks an SM; with the evaluation's walk
// every layout takes one block's registers, PERF.md §6). Shared
// memory also holds the group's
// own area: two reduction-partials areas, which the evaluation's partials
// share, the two-loop's alpha and the evaluation's rings of rows, 3 rows
// of D a warp (l96_solve.cuh; the rings go to the workspace, layout flag
// 8, where they do not fit on chip). Each
// layout runs its own instantiation: with everything on chip the vector
// passes load one entry at a time; where they read global memory they
// load kChunkGlobal entries together (more registers, one latency a
// chunk).
//
// What bounds it on the card: per member the solve is a chain of
// thousands of evaluations and group reductions, each dependent on the
// last. The bytes and operations are far below the card's rates; one
// block per member on B of the 132 SMs makes the kernel bound by that
// serial depth: the latency of the vector passes (shared memory where the
// layout puts the vectors on chip, else L1/L2) and of the barriers, 15 an
// iteration at m = 5 against the first port's 31 (l96_solve.cuh says
// which went), of which the evaluation keeps 2. The evaluation itself is
// K1's walk in time (l96_ag_block.cuh), one warp a range of rows.
//
// Sums are reduced in a fixed order with no atomics: a repeated launch on
// the same inputs gives bit-identical outputs, whatever the layout.
// solve_one is not inlined, so K2 and K3 run the same machine code for a
// rung.
//
// The body (solve_one and what it calls) lives in l96_solve.cuh, generic
// over the group of threads that solves a member; K2 and K3 instantiate
// it with the whole block (BlockGroup), K8 (pack_kernel.cu) with a
// warp-aligned group.

// The kernels and their launches are in l96_solve_kernels.cuh, shared
// with the rules' entries (l96_solve_rules.cuh).

#include <cuda_runtime.h>

#include "l96_solve_kernels.cuh"

namespace {

template <int kChunk>
const void* solve_fn(int ladder, int f64, int bounded) {
    using P32 = L96Problem<float>;
    using P64 = L96Problem<double>;
    if (ladder)
        return f64 ? (const void*)l96_ladder_kernel<P64, double, kChunk>
                   : (const void*)l96_ladder_kernel<P32, float, kChunk>;
    if (f64)
        return bounded
            ? (const void*)l96_solve_kernel<P64, double, true, kChunk>
            : (const void*)l96_solve_kernel<P64, double, false, kChunk>;
    return bounded ? (const void*)l96_solve_kernel<P32, float, true, kChunk>
                   : (const void*)l96_solve_kernel<P32, float, false, kChunk>;
}

// The kernel a launch of (ladder, f64, bounded) under `layout` runs: K3
// or K2, in the layout's instantiation.
const void* solve_fn(int ladder, int f64, int bounded, int layout) {
    return chunk_of(layout) == 1 ? solve_fn<1>(ladder, f64, bounded)
                                 : solve_fn<kChunkGlobal>(ladder, f64,
                                                          bounded);
}

}  // namespace

extern "C" {

// Each launch returns the cudaError_t of the launch (0 = cudaSuccess).
// Pointers are device pointers. XP, X_out, G_out are (B, n_dof)
// row-major; Y/W (N_data, L); lidx (L,) and lpos (D,) int32; layout the
// flags of the groups kept on chip (1 vectors, 2 history, 4 box) and 8,
// the evaluation's rings in the workspace (see l96_solve.cuh); lo/hi
// (n_dof,) or (B, n_dof) box bounds (bnd_stride 0 or n_dof), both NULL
// for an unbounded solve; work (B, work_elems(n_dof, m, D, layout))
// scratch (l96_solve.cuh); fp_out (B, 2) [f, pgnorm] and cnt_out
// (B, 3) int32 [niter, nfev, status]; rfs (k,); rec (B, k, 3) [A, ME,
// pgnorm] and rec_i (B, k, 3) int32 [niter, nfev, status].
int va_l96_solve_f32(VA_SOLVE_ARGS, int layout, double rf, const void* lo,
                     const void* hi, int bnd_stride, void* work, void* X_out,
                     void* G_out, void* fp_out, void* cnt_out,
                     void* stream) {
    return launch_solve(VA_PROBLEM(float), VA_OPTS(float), B, layout, rf,
                        XP, lo, hi, bnd_stride, work, X_out, G_out, fp_out,
                        cnt_out, stream);
}

int va_l96_solve_f64(VA_SOLVE_ARGS, int layout, double rf, const void* lo,
                     const void* hi, int bnd_stride, void* work, void* X_out,
                     void* G_out, void* fp_out, void* cnt_out,
                     void* stream) {
    return launch_solve(VA_PROBLEM(double), VA_OPTS(double), B, layout, rf,
                        XP, lo, hi, bnd_stride, work, X_out, G_out, fp_out,
                        cnt_out, stream);
}

int va_l96_ladder_f32(VA_SOLVE_ARGS, int layout, const void* rfs,
                      int k_rungs, void* work, void* X_out, void* rec,
                      void* rec_i, void* stream) {
    return launch_ladder(VA_PROBLEM(float), VA_OPTS(float), B, layout, rfs,
                         k_rungs, XP, work, X_out, rec, rec_i, stream);
}

int va_l96_ladder_f64(VA_SOLVE_ARGS, int layout, const void* rfs,
                      int k_rungs, void* work, void* X_out, void* rec,
                      void* rec_i, void* stream) {
    return launch_ladder(VA_PROBLEM(double), VA_OPTS(double), B, layout,
                         rfs, k_rungs, XP, work, X_out, rec, rec_i, stream);
}

// A launch's dynamic shared memory in bytes under `layout`, as the
// launches compute it.
long long va_l96_solve_smem(int D, int n_dof, int m, int layout, int f64) {
    return (long long)(layout_smem_elems(D, n_dof, m, layout)
                       * (f64 ? sizeof(double) : sizeof(float)));
}

// The attributes of the built kernel that a launch of (ladder, f64,
// bounded) under `layout` runs: out = [registers a thread, local memory a
// thread in bytes (spills and stack), the most threads a block can
// launch with, the threads a launch takes].
int va_l96_solve_attrs(int ladder, int f64, int bounded, int layout,
                       int* out) {
    cudaFuncAttributes a;
    const cudaError_t e =
        cudaFuncGetAttributes(&a, solve_fn(ladder, f64, bounded, layout));
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = a.maxThreadsPerBlock;
    out[3] = kThreads;
    return 0;
}

const char* va_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

#ifdef VA_COUNT_BARRIERS
// The measuring build's count (l96_ag_block.cuh) into *out, after the
// device's work so far; reset: start it again from 0.
int va_barriers_read(unsigned long long* out, int reset) {
    cudaError_t e = cudaDeviceSynchronize();
    if (e == cudaSuccess)
        e = cudaMemcpyFromSymbol(out, va_barriers, sizeof *out);
    const unsigned long long zero = 0;
    if (e == cudaSuccess && reset)
        e = cudaMemcpyToSymbol(va_barriers, &zero, sizeof zero);
    return (int)e;
}
#endif

}  // extern "C"
