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
// Memory: a member's vectors (x, g, d, the trial x and g) and its m-pair
// history live in a per-member global workspace that the wrapper
// allocates: (5 + 2m) * n_dof values, 193 KB in f32 at the main shape
// (n_dof = 3,221, m = 5), which stays in the 50 MB L2. Shared memory holds
// only the evaluation's residuals and the reduction partials (K1's
// layout); the bounds too stay in global memory, so the bounded branch
// needs no more shared memory than the unbounded one. Keeping the vectors
// on chip, or spreading a member over a cluster of blocks, is later work.
//
// What bounds it on the card: per member the solve is a chain of
// thousands of evaluations and block reductions, each dependent on the
// last. The bytes (every vector pass re-reads n_dof values from L2) and
// operations are far below the card's rates; one block per member on
// B of the 132 SMs makes the kernel bound by that serial depth (latency
// of L2 loads and __syncthreads), not by bytes or operations.
//
// Sums are reduced in a fixed order with no atomics: a repeated launch on
// the same inputs gives bit-identical outputs. solve_one is not inlined,
// so K2 and K3 run the same machine code for a rung.
//
// The body (solve_one and what it calls) lives in l96_solve.cuh, generic
// over the group of threads that solves a member; K2 and K3 instantiate
// it with the whole block (BlockGroup), K8 (pack_kernel.cu) with a
// warp-aligned group.

#include <cuda_runtime.h>

#include "l96_solve.cuh"

namespace {

constexpr int kThreads = kAgThreads;

template <typename T>
__device__ Bufs<T> member_bufs(T* work, int n, int m) {
    T* base = work + (size_t)blockIdx.x * (5 + 2 * m) * n;
    return Bufs<T>{base, base + n, base + 2 * n, base + 3 * n, base + 4 * n,
                   base + 5 * n, base + (5 + (size_t)m) * n};
}

template <typename T>
__device__ Smem<T> carve_smem(unsigned char* raw, int N, int D) {
    T* s = reinterpret_cast<T*>(raw);
    T* red = s + l96_ag_smem_elems(N, D);
    return Smem<T>{s, red, red + kMaxRed * kAgWarps};
}

// K2: one rung, one block per member. Writes x, g, fp = [f, pgnorm] and
// cnt = [niter, nfev, status] per member. Bounded: lo/hi hold the bounds,
// bnd_stride apart per member (0: shared by every member).
template <typename T, bool kBounded>
__global__ void __launch_bounds__(kThreads) l96_solve_kernel(
        L96Problem<T> p, SolveOpts<T> o, T rf, const T* __restrict__ XP,
        const T* __restrict__ lo, const T* __restrict__ hi, int bnd_stride,
        T* __restrict__ work, T* __restrict__ X_out, T* __restrict__ G_out,
        T* __restrict__ fp_out, int* __restrict__ cnt_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const Smem<T> sm = carve_smem<T>(smem_raw, p.N, p.D);
    const int n = p.n_dof;
    const int b = blockIdx.x;
    Bufs<T> w = member_bufs(work, n, o.m);
    const Box<T> bx = kBounded
        ? Box<T>{lo + (size_t)b * bnd_stride, hi + (size_t)b * bnd_stride}
        : Box<T>{nullptr, nullptr};
    for (int k = threadIdx.x; k < n; k += kThreads)
        w.x[k] = XP[(size_t)b * n + k];
    const SolveResult<T> r =
        solve_one<BlockGroup, kBounded>(p, rf, o, w, bx, sm);
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
template <typename T>
__global__ void __launch_bounds__(kThreads) l96_ladder_kernel(
        L96Problem<T> p, SolveOpts<T> o, const T* __restrict__ rfs, int k_rungs,
        const T* __restrict__ XP, T* __restrict__ work,
        T* __restrict__ X_out, T* __restrict__ rec,
        int* __restrict__ rec_i) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const Smem<T> sm = carve_smem<T>(smem_raw, p.N, p.D);
    const int n = p.n_dof;
    const int b = blockIdx.x;
    Bufs<T> w = member_bufs(work, n, o.m);
    for (int k = threadIdx.x; k < n; k += kThreads)
        w.x[k] = XP[(size_t)b * n + k];
    const Box<T> none{nullptr, nullptr};
    for (int j = 0; j < k_rungs; ++j) {
        const SolveResult<T> r =
            solve_one<BlockGroup, false>(p, rfs[j], o, w, none, sm);
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

template <typename T, bool kBounded>
int launch_solve_kernel(const L96Problem<T>& p, const SolveOpts<T>& o,
                        double rf, const void* XP, const void* lo,
                        const void* hi, int bnd_stride, void* work,
                        void* X_out, void* G_out, void* fp_out,
                        void* cnt_out, int B, size_t smem, void* stream) {
    const cudaError_t e = opt_in(l96_solve_kernel<T, kBounded>, smem);
    if (e != cudaSuccess) return (int)e;
    l96_solve_kernel<T, kBounded>
        <<<B, kThreads, smem, (cudaStream_t)stream>>>(
            p, o, (T)rf, static_cast<const T*>(XP),
            static_cast<const T*>(lo), static_cast<const T*>(hi),
            bnd_stride, static_cast<T*>(work), static_cast<T*>(X_out),
            static_cast<T*>(G_out), static_cast<T*>(fp_out),
            static_cast<int*>(cnt_out));
    return (int)cudaGetLastError();
}

template <typename T>
int launch_solve(const void* XP, int B, int n_dof, int N, int D, int pslot,
                 double F_fixed, const void* Y, const void* W,
                 const void* lidx, const void* lpos, int N_data, int L,
                 int obs_stride, double h, double me_norm, double fe_norm,
                 int m, int maxiter, int maxls, double c1, double c2,
                 double pgtol, double ftol, double rf, const void* lo,
                 const void* hi, int bnd_stride, void* work, void* X_out,
                 void* G_out, void* fp_out, void* cnt_out, void* stream) {
    if (m < 1 || m > kMaxM) return (int)cudaErrorInvalidValue;
    if ((lo == nullptr) != (hi == nullptr))
        return (int)cudaErrorInvalidValue;
    const size_t smem = solve_smem_elems(N, D) * sizeof(T);
    const L96Problem<T> p = problem<T>(n_dof, N, D, pslot, F_fixed, Y, W,
                                       lidx, lpos, N_data, L, obs_stride, h,
                                       me_norm, fe_norm);
    const SolveOpts<T> o = solve_opts<T>(m, maxiter, maxls, c1, c2, pgtol,
                                         ftol);
    return lo ? launch_solve_kernel<T, true>(p, o, rf, XP, lo, hi,
                                             bnd_stride, work, X_out, G_out,
                                             fp_out, cnt_out, B, smem,
                                             stream)
              : launch_solve_kernel<T, false>(p, o, rf, XP, lo, hi,
                                              bnd_stride, work, X_out, G_out,
                                              fp_out, cnt_out, B, smem,
                                              stream);
}

template <typename T>
int launch_ladder(const void* XP, int B, int n_dof, int N, int D, int pslot,
                  double F_fixed, const void* Y, const void* W,
                  const void* lidx, const void* lpos, int N_data, int L,
                  int obs_stride, double h, double me_norm, double fe_norm,
                  int m, int maxiter, int maxls, double c1, double c2,
                  double pgtol, double ftol, const void* rfs, int k_rungs,
                  void* work, void* X_out, void* rec, void* rec_i,
                  void* stream) {
    if (m < 1 || m > kMaxM) return (int)cudaErrorInvalidValue;
    const size_t smem = solve_smem_elems(N, D) * sizeof(T);
    const cudaError_t e = opt_in(l96_ladder_kernel<T>, smem);
    if (e != cudaSuccess) return (int)e;
    l96_ladder_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
        problem<T>(n_dof, N, D, pslot, F_fixed, Y, W, lidx, lpos, N_data,
                   L, obs_stride, h, me_norm, fe_norm),
        solve_opts<T>(m, maxiter, maxls, c1, c2, pgtol, ftol),
        static_cast<const T*>(rfs), k_rungs, static_cast<const T*>(XP),
        static_cast<T*>(work), static_cast<T*>(X_out),
        static_cast<T*>(rec), static_cast<int*>(rec_i));
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess). Pointers
// are device pointers. XP, X_out, G_out are (B, n_dof) row-major; Y/W
// (N_data, L); lidx (L,) and lpos (D,) int32; lo/hi (n_dof,) or
// (B, n_dof) box bounds (bnd_stride 0 or n_dof), both NULL for an
// unbounded solve; work (B, (5 + 2m) n_dof) scratch; fp_out (B, 2)
// [f, pgnorm] and cnt_out (B, 3) int32 [niter, nfev, status]; rfs (k,);
// rec (B, k, 3) [A, ME, pgnorm] and rec_i (B, k, 3) int32 [niter, nfev,
// status].
int va_l96_solve_f32(VA_SOLVE_ARGS, double rf, const void* lo,
                     const void* hi, int bnd_stride, void* work, void* X_out,
                     void* G_out, void* fp_out, void* cnt_out,
                     void* stream) {
    return launch_solve<float>(VA_SOLVE_PASS, rf, lo, hi, bnd_stride, work,
                               X_out, G_out, fp_out, cnt_out, stream);
}

int va_l96_solve_f64(VA_SOLVE_ARGS, double rf, const void* lo,
                     const void* hi, int bnd_stride, void* work, void* X_out,
                     void* G_out, void* fp_out, void* cnt_out,
                     void* stream) {
    return launch_solve<double>(VA_SOLVE_PASS, rf, lo, hi, bnd_stride, work,
                                X_out, G_out, fp_out, cnt_out, stream);
}

int va_l96_ladder_f32(VA_SOLVE_ARGS, const void* rfs, int k_rungs,
                      void* work, void* X_out, void* rec, void* rec_i,
                      void* stream) {
    return launch_ladder<float>(VA_SOLVE_PASS, rfs, k_rungs, work, X_out,
                                rec, rec_i, stream);
}

int va_l96_ladder_f64(VA_SOLVE_ARGS, const void* rfs, int k_rungs,
                      void* work, void* X_out, void* rec, void* rec_i,
                      void* stream) {
    return launch_ladder<double>(VA_SOLVE_PASS, rfs, k_rungs, work, X_out,
                                 rec, rec_i, stream);
}

const char* va_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
