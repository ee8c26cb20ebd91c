// The kernels of K2 and K3 and their launches, generic over the problem
// type Prob: L96Problem<T> (the trapezoid rule with a scalar rf;
// solve_kernel.cu's entries), L96RuleProblem<T> (the problem's rule and
// rf kind; l96_solve_rules.cuh's) or RowProblem<Model, T> (a row-level
// model; row_solve.cuh's). solve_kernel.cu's notes say what they
// compute, what bounds them and how; the body is l96_solve.cuh's
// solve_one. A problem's evaluation area is sized by ring_cols(p).

#pragma once

#include <cuda_runtime.h>

#include "l96_solve.cuh"

namespace {

constexpr int kThreads = kAgThreads;

// K2: one rung, one block per member. Writes x, g, fp = [f, pgnorm] and
// cnt = [niter, nfev, status] per member. Bounded: lo/hi hold the bounds,
// bnd_stride apart per member (0: shared by every member).
// Each chunk a layout takes is its own instantiation: 1 all on chip,
// kChunkGlobal otherwise. Every instantiation has the registers of one
// block an SM: held to 128 for two blocks an SM (the global layout's
// shared memory would allow two), the evaluation's walk and the solver
// spilled, and the global layout ran slower at B = 264 (PERF.md §6).
template <typename Prob, typename T, bool kBounded, int kChunk>
__global__ void __launch_bounds__(kThreads) l96_solve_kernel(
        Prob p, SolveOpts<T> o, T rf, int layout,
        const T* __restrict__ XP, const T* __restrict__ lo,
        const T* __restrict__ hi, int bnd_stride, T* __restrict__ work,
        T* __restrict__ X_out, T* __restrict__ G_out,
        T* __restrict__ fp_out, int* __restrict__ cnt_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    const int n = p.n_dof;
    const int b = blockIdx.x;
    const int cols = ring_cols(p);
    T* work_b = work + (size_t)b * work_elems(n, o.m, cols, layout);
    const Smem<T> sm = group_smem(s, work_b, n, o.m, cols, layout);
    T* chip = s + solve_smem_elems(cols, kAgWarps, !(layout & kRingOffChip));
    Bufs<T> w = member_bufs(chip, work_b, n, o.m, layout);
    Box<T> bx{nullptr, nullptr};
    if (kBounded) {
        const T* lo_b = lo + (size_t)b * bnd_stride;
        const T* hi_b = hi + (size_t)b * bnd_stride;
        if (layout & kBoundsOnChip) {      // each thread its own entries
            T* lc = chip_bounds(chip, n, o.m, layout);
            for (int k = threadIdx.x; k < n; k += kThreads) {
                lc[k] = lo_b[k];
                lc[n + k] = hi_b[k];
            }
            bx = Box<T>{lc, lc + n};
        } else {
            bx = Box<T>{lo_b, hi_b};
        }
    }
    for (int k = threadIdx.x; k < n; k += kThreads)
        w.x[k] = XP[(size_t)b * n + k];
    const SolveResult<T> r =
        solve_one<BlockGroup, kBounded, kChunk>(p, rf, o, w, bx, sm);
    for (int k = threadIdx.x; k < n; k += kThreads) {
        X_out[(size_t)b * n + k] = w.x[k];
        G_out[(size_t)b * n + k] = w.g[k];
    }
    if (threadIdx.x == 0) {
        fp_out[2 * b] = r.f;
        fp_out[2 * b + 1] = r.pgnorm;
        cnt_out[3 * b] = r.niter;
        cnt_out[3 * b + 1] = r.nfev;
        cnt_out[3 * b + 2] = r.status;
    }
}

// K3: k warm-started rungs at rfs[0..k), one block per member. Writes the
// final x and per rung rec = [A, ME, pgnorm], rec_i = [niter, nfev,
// status], each (B, k, 3).
template <typename Prob, typename T, int kChunk>
__global__ void __launch_bounds__(kThreads) l96_ladder_kernel(
        Prob p, SolveOpts<T> o, int layout,
        const T* __restrict__ rfs, int k_rungs, const T* __restrict__ XP,
        T* __restrict__ work, T* __restrict__ X_out, T* __restrict__ rec,
        int* __restrict__ rec_i) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    const int n = p.n_dof;
    const int b = blockIdx.x;
    const int cols = ring_cols(p);
    T* work_b = work + (size_t)b * work_elems(n, o.m, cols, layout);
    const Smem<T> sm = group_smem(s, work_b, n, o.m, cols, layout);
    Bufs<T> w = member_bufs(
        s + solve_smem_elems(cols, kAgWarps, !(layout & kRingOffChip)),
        work_b, n, o.m, layout);
    for (int k = threadIdx.x; k < n; k += kThreads)
        w.x[k] = XP[(size_t)b * n + k];
    const Box<T> none{nullptr, nullptr};
    for (int j = 0; j < k_rungs; ++j) {
        const SolveResult<T> r =
            solve_one<BlockGroup, false, kChunk>(p, rfs[j], o, w, none, sm);
        if (threadIdx.x == 0) {
            const size_t row = ((size_t)b * k_rungs + j) * 3;
            rec[row] = r.f;
            rec[row + 1] = r.me;
            rec[row + 2] = r.pgnorm;
            rec_i[row] = r.niter;
            rec_i[row + 1] = r.nfev;
            rec_i[row + 2] = r.status;
        }
    }
    for (int k = threadIdx.x; k < n; k += kThreads)
        X_out[(size_t)b * n + k] = w.x[k];
}

template <typename T, bool kBounded, int kChunk, typename Prob>
int launch_solve_kernel(const Prob& p, const SolveOpts<T>& o,
                        double rf, int layout, const void* XP,
                        const void* lo, const void* hi, int bnd_stride,
                        void* work, void* X_out, void* G_out, void* fp_out,
                        void* cnt_out, int B, size_t smem, void* stream) {
    const cudaError_t e =
        opt_in(l96_solve_kernel<Prob, T, kBounded, kChunk>, smem);
    if (e != cudaSuccess) return (int)e;
    l96_solve_kernel<Prob, T, kBounded, kChunk>
        <<<B, kThreads, smem, (cudaStream_t)stream>>>(
            p, o, (T)rf, layout, static_cast<const T*>(XP),
            static_cast<const T*>(lo), static_cast<const T*>(hi),
            bnd_stride, static_cast<T*>(work), static_cast<T*>(X_out),
            static_cast<T*>(G_out), static_cast<T*>(fp_out),
            static_cast<int*>(cnt_out));
    return (int)cudaGetLastError();
}

template <typename T, bool kBounded, typename Prob>
int launch_solve_kernel(const Prob& p, const SolveOpts<T>& o,
                        double rf, int layout, const void* XP,
                        const void* lo, const void* hi, int bnd_stride,
                        void* work, void* X_out, void* G_out, void* fp_out,
                        void* cnt_out, int B, size_t smem, void* stream) {
    if (chunk_of(layout) == 1)
        return launch_solve_kernel<T, kBounded, 1>(
            p, o, rf, layout, XP, lo, hi, bnd_stride, work, X_out, G_out,
            fp_out, cnt_out, B, smem, stream);
    return launch_solve_kernel<T, kBounded, kChunkGlobal>(
        p, o, rf, layout, XP, lo, hi, bnd_stride, work, X_out, G_out,
        fp_out, cnt_out, B, smem, stream);
}

// The layout's flags are known ones, and the box on chip only with a box.
bool layout_ok(int layout, bool bounded) {
    return (layout & ~kLayoutFlags) == 0
           && (bounded || !(layout & kBoundsOnChip));
}

// K2 on the problem p (L96Problem<T> or L96RuleProblem<T>) under the
// options o; the arguments past them as the entries take them.
template <typename T, typename Prob>
int launch_solve(const Prob& p, const SolveOpts<T>& o, int B, int layout,
                 double rf, const void* XP, const void* lo,
                 const void* hi, int bnd_stride, void* work, void* X_out,
                 void* G_out, void* fp_out, void* cnt_out, void* stream) {
    if (o.m < 1 || o.m > kMaxM || (lo == nullptr) != (hi == nullptr)
            || !layout_ok(layout, lo != nullptr))
        return (int)cudaErrorInvalidValue;
    const size_t smem =
        layout_smem_elems(ring_cols(p), p.n_dof, o.m, layout) * sizeof(T);
    return lo ? launch_solve_kernel<T, true>(p, o, rf, layout, XP, lo, hi,
                                             bnd_stride, work, X_out,
                                             G_out, fp_out, cnt_out, B,
                                             smem, stream)
              : launch_solve_kernel<T, false>(p, o, rf, layout, XP, lo, hi,
                                              bnd_stride, work, X_out,
                                              G_out, fp_out, cnt_out, B,
                                              smem, stream);
}

template <typename T, int kChunk, typename Prob>
int launch_ladder_kernel(const Prob& p, const SolveOpts<T>& o,
                         int layout, const void* rfs, int k_rungs,
                         const void* XP, void* work, void* X_out, void* rec,
                         void* rec_i, int B, size_t smem, void* stream) {
    const cudaError_t e = opt_in(l96_ladder_kernel<Prob, T, kChunk>, smem);
    if (e != cudaSuccess) return (int)e;
    l96_ladder_kernel<Prob, T, kChunk>
        <<<B, kThreads, smem, (cudaStream_t)stream>>>(
            p, o, layout, static_cast<const T*>(rfs), k_rungs,
            static_cast<const T*>(XP), static_cast<T*>(work),
            static_cast<T*>(X_out), static_cast<T*>(rec),
            static_cast<int*>(rec_i));
    return (int)cudaGetLastError();
}

// K3 on the problem p under the options o.
template <typename T, typename Prob>
int launch_ladder(const Prob& p, const SolveOpts<T>& o, int B, int layout,
                  const void* rfs, int k_rungs, const void* XP, void* work,
                  void* X_out, void* rec, void* rec_i, void* stream) {
    if (o.m < 1 || o.m > kMaxM || !layout_ok(layout, false))
        return (int)cudaErrorInvalidValue;
    const size_t smem =
        layout_smem_elems(ring_cols(p), p.n_dof, o.m, layout) * sizeof(T);
    if (chunk_of(layout) == 1)
        return launch_ladder_kernel<T, 1>(p, o, layout, rfs, k_rungs, XP,
                                          work, X_out, rec, rec_i, B, smem,
                                          stream);
    return launch_ladder_kernel<T, kChunkGlobal>(
        p, o, layout, rfs, k_rungs, XP, work, X_out, rec, rec_i, B, smem,
        stream);
}

}  // namespace

// The problem and the options of an entry's VA_SOLVE_ARGS, in T.
#define VA_PROBLEM(T)                                                       \
    problem<T>(n_dof, N, D, pslot, F_fixed, Y, W, lidx, lpos, N_data, L,   \
               obs_stride, h, me_norm, fe_norm)
#define VA_OPTS(T) solve_opts<T>(m, maxiter, maxls, c1, c2, pgtol, ftol)
