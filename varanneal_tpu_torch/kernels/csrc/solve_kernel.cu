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

#include <cfloat>
#include <cuda_runtime.h>

#include "l96_ag_block.cuh"

namespace {

constexpr int kThreads = kAgThreads;
constexpr int kWarps = kAgWarps;
constexpr int kMaxRed = 5;     // most values one block reduction carries
constexpr int kMaxM = 16;      // largest history (the wrapper's envelope)

// CONV_GRAD, CONV_FTOL, MAXITER, LS_FAIL of opt/lbfgs.py
constexpr int kConvGrad = 0, kConvFtol = 1, kMaxIter = 2, kLsFail = 3;

template <typename T> __device__ __forceinline__ T big_value();
template <> __device__ __forceinline__ float big_value<float>() {
    return FLT_MAX;
}
template <> __device__ __forceinline__ double big_value<double>() {
    return DBL_MAX;
}

// jnp.maximum / jnp.minimum: a NaN operand gives NaN.
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
    return (a != a || a > b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nanmin(T a, T b) {
    return (a != a || a < b) ? a : b;
}
// Finite: false for NaN and for +-inf.
template <typename T>
__device__ __forceinline__ bool is_finite(T x) {
    return fabs(x) <= big_value<T>();
}
template <typename T>
__device__ __forceinline__ T sign_of(T x) {       // jnp.sign
    return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {   // jnp.clip
    return nanmin(nanmax(x, lo), hi);
}

// Box bounds of one member (n_dof values each), or nullptr when unbounded.
template <typename T>
struct Box {
    const T* lo;
    const T* hi;
};

// The projection algorithm's active set: at a bound (within 1e-12, added
// in T, as _solve_one's eps_b) with the gradient pushing out of the box.
template <typename T>
__device__ __forceinline__ bool frozen(T x, T g, T lo, T hi) {
    const T eps = T(1e-12);
    return ((x <= lo + eps) && (g > T(0))) || ((x >= hi - eps) && (g < T(0)));
}

// x - P(x - g), SciPy's projected gradient component.
template <typename T>
__device__ __forceinline__ T proj_grad(T x, T g, T lo, T hi) {
    return x - clip(x - g, lo, hi);
}

template <typename T>
struct SolveOpts {
    int m, maxiter, maxls;
    T c1, c2, pgtol, ftol;
};

// Shared memory of the solve kernels: the evaluation's area, the solver's
// reduction partials and the evaluation's two outputs (A, ME).
template <typename T>
struct Smem {
    T* ag;
    T* red;
    T* out;
};

__host__ __device__ inline size_t solve_smem_elems(int N, int D) {
    return l96_ag_smem_elems(N, D) + kMaxRed * kWarps + 2;
}

// A member's vectors in its workspace. x/xt and g/gt swap roles when a
// step is taken, so the pointers travel with the solve.
template <typename T>
struct Bufs {
    T* x;
    T* g;
    T* d;
    T* xt;      // trial point
    T* gt;      // gradient at the trial point
    T* S;       // (m, n) steps
    T* Y;       // (m, n) gradient differences
};

// 1 where entry k of the member's current point is free, 0 where frozen
// (the mask _solve_one multiplies by).
template <typename T>
__device__ __forceinline__ T free_of(const Bufs<T>& w, const Box<T>& bx,
                                     int k) {
    return frozen(w.x[k], w.g[k], bx.lo[k], bx.hi[k]) ? T(0) : T(1);
}

// Block-wide fixed-order reduction of K values: entries [0, first_max)
// are sums, the rest NaN-propagating maxima. Every thread gets the totals.
template <typename T, int K>
__device__ void block_reduce(T (&v)[K], int first_max, T* red) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        for (int o = 16; o > 0; o >>= 1) {
            const T u = __shfl_down_sync(0xffffffffu, v[k], o);
            v[k] = k < first_max ? v[k] + u : nanmax(v[k], u);
        }
        if (lane == 0) red[k * kWarps + warp] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
        T t = red[k * kWarps];
        for (int w = 1; w < kWarps; ++w)
            t = k < first_max ? t + red[k * kWarps + w]
                              : nanmax(t, red[k * kWarps + w]);
        v[k] = t;
    }
    __syncthreads();      // partials read: the next reduction may write
}

template <typename T>
__device__ __forceinline__ T block_dot(const T* a, const T* b, int n,
                                       T* red) {
    T v[1] = {T(0)};
    for (int i = threadIdx.x; i < n; i += kThreads) v[0] += a[i] * b[i];
    block_reduce(v, 1, red);
    return v[0];
}

// f and ME at x, gradient into g. The leading barrier makes every
// thread's writes to x visible (the routine reads neighbours) and frees
// the shared areas; the trailing one publishes g[pslot] and the outputs.
template <typename T>
__device__ void evaluate(const L96Problem<T>& p, const T* x, T rf, T* g,
                         const Smem<T>& sm, T& f, T& me) {
    __syncthreads();
    l96_ag_block<T, true>(p, x, rf, g, sm.ag, sm.out);
    __syncthreads();
    f = sm.out[0];
    me = sm.out[1];
}

// _cubic_min: minimizer of the cubic Hermite interpolant on [a, b], with
// the NaN-safe fall back to bisection.
template <typename T>
__device__ T cubic_min(T a, T fa, T dfa, T b, T fb, T dfb) {
    const T d1 = dfa + dfb - T(3) * (fa - fb) / (a - b);
    const T arg = d1 * d1 - dfa * dfb;
    const T d2 = sqrt(nanmax(arg, T(0))) * sign_of(b - a);
    const T denom = dfb - dfa + T(2) * d2;
    const T t = b - (b - a) * (dfb + d2 - d1) / denom;
    const bool bad = (arg < T(0)) || !is_finite(t) || (denom == T(0));
    return bad ? T(0.5) * (a + b) : t;
}

template <typename T>
struct LineSearch {
    T a, f, me;     // accepted step, f and ME there
    int nfev;
    bool ok;        // a step was taken: x + a d is in xt, its g in gt
};

// The strong-Wolfe bracket/zoom line search of _solve_one.line_search
// (solve_pallas.py), one evaluation per step, along d from x.
template <typename T>
__device__ LineSearch<T> line_search(const L96Problem<T>& p, T rf,
                                     const SolveOpts<T>& o, const Bufs<T>& w,
                                     T f0, T me0, T dphi0, T a_init,
                                     const Smem<T>& sm) {
    const int n = p.n_dof;
    const T big = big_value<T>();
    int stage = 0, i = 0;
    bool done = false, failed = false;
    T a = nanmin(a_init, big);
    T a_prev = T(0), f_prev = f0, d_prev = dphi0;
    T a_lo = T(0), f_lo = f0, d_lo = dphi0;
    T a_hi = T(0), f_hi = f0, d_hi = dphi0;
    T a_star = T(0), f_star = f0, me_star = me0;

    while (!(done || failed) && i < o.maxls) {
        for (int k = threadIdx.x; k < n; k += kThreads)
            w.xt[k] = w.x[k] + a * w.d[k];
        T f_a, me_a;
        evaluate(p, w.xt, rf, w.gt, sm, f_a, me_a);
        const T dphi_a = block_dot(w.gt, w.d, n, sm.red);
        i += 1;
        const bool armijo_fail = f_a > f0 + o.c1 * a * dphi0;
        const bool nan_bad = !is_finite(f_a);
        const bool curv_ok = fabs(dphi_a) <= -o.c2 * dphi0;
        const bool in_br = stage == 0;

        // bracket stage; at the step cap Armijo alone accepts
        const bool at_cap = a >= big;
        const bool hi_b = armijo_fail || ((i > 1) && (f_a >= f_prev))
                          || nan_bad;
        const bool accept_b = !hi_b && (curv_ok || at_cap);
        const bool to_zoom_rev = !hi_b && !curv_ok && !at_cap
                                 && (dphi_a >= T(0));
        const bool enter_zoom = hi_b || to_zoom_rev;
        const T a_lo_b = hi_b ? a_prev : a;
        const T f_lo_b = hi_b ? f_prev : f_a;
        const T d_lo_b = hi_b ? d_prev : dphi_a;
        const T a_hi_b = hi_b ? a : a_prev;
        const T f_hi_b = hi_b ? f_a : f_prev;
        const T d_hi_b = hi_b ? dphi_a : d_prev;

        // zoom stage
        const bool hi_z = armijo_fail || (f_a >= f_lo) || nan_bad;
        const bool accept_z = !hi_z && curv_ok;
        const bool swap = !hi_z && !curv_ok
                          && (dphi_a * (a_hi - a_lo) >= T(0));
        const T a_hi_z = hi_z ? a : (swap ? a_lo : a_hi);
        const T f_hi_z = hi_z ? f_a : (swap ? f_lo : f_hi);
        const T d_hi_z = hi_z ? dphi_a : (swap ? d_lo : d_hi);
        const T a_lo_z = hi_z ? a_lo : a;
        const T f_lo_z = hi_z ? f_lo : f_a;
        const T d_lo_z = hi_z ? d_lo : dphi_a;

        const T a_lo_n = in_br ? a_lo_b : a_lo_z;
        const T f_lo_n = in_br ? f_lo_b : f_lo_z;
        const T d_lo_n = in_br ? d_lo_b : d_lo_z;
        const T a_hi_n = in_br ? a_hi_b : a_hi_z;
        const T f_hi_n = in_br ? f_hi_b : f_hi_z;
        const T d_hi_n = in_br ? d_hi_b : d_hi_z;
        const T width = fabs(a_hi_n - a_lo_n);
        T a_interp = cubic_min(a_lo_n, f_lo_n, d_lo_n, a_hi_n, f_hi_n,
                               d_hi_n);
        a_interp = clip(a_interp, nanmin(a_lo_n, a_hi_n) + T(0.1) * width,
                        nanmax(a_lo_n, a_hi_n) - T(0.1) * width);
        const T a_expand = nanmin(T(2) * a, big);
        const T a_next = (in_br && !enter_zoom) ? a_expand : a_interp;
        const bool tiny = width <= T(1e-14) * nanmax(T(1), fabs(a_lo_n));
        const bool accept = in_br ? accept_b : accept_z;
        failed = in_br ? (nan_bad && (i >= o.maxls)) : (tiny && !accept);
        stage = (in_br && !enter_zoom) ? 0 : 1;
        done = accept;
        if (in_br) {
            f_prev = f_a;
            d_prev = dphi_a;
        }
        a_prev = a;
        a_lo = a_lo_n; f_lo = f_lo_n; d_lo = d_lo_n;
        a_hi = a_hi_n; f_hi = f_hi_n; d_hi = d_hi_n;
        if (accept) {
            a_star = a;
            f_star = f_a;
            me_star = me_a;
        }
        a = a_next;
    }

    // no Wolfe point, but the bracket's lo end improves on f0 (Armijo
    // holds there by construction): take it, one more evaluation
    LineSearch<T> r;
    const bool have_lo = (a_lo > T(0)) && (f_lo < f0);
    r.ok = done || have_lo;
    r.nfev = i;
    r.a = T(0);
    r.f = f0;
    r.me = me0;
    if (done) {
        r.a = a_star;
        r.f = f_star;
        r.me = me_star;
    } else if (have_lo) {
        for (int k = threadIdx.x; k < n; k += kThreads)
            w.xt[k] = w.x[k] + a_lo * w.d[k];
        evaluate(p, w.xt, rf, w.gt, sm, r.f, r.me);
        r.a = a_lo;
        r.nfev = i + 1;
    }
    return r;
}

// _solve_one.proj_ls: Armijo backtracking along the projected path from
// w.x along w.d, the trial point P(x + a d) in w.xt and its gradient in
// w.gt. ok: the last trial decreased f enough (it is then the new
// point); nfev counts every trial, the first included.
template <typename T>
__device__ LineSearch<T> proj_line_search(const L96Problem<T>& p, T rf,
                                          const SolveOpts<T>& o,
                                          const Bufs<T>& w, const Box<T>& bx,
                                          T f0, T me0, T a_init,
                                          const Smem<T>& sm) {
    const int n = p.n_dof;
    T a = a_init;
    T f_a, me_a, gdx;
    int i = 0;
    bool ok = false;
    do {
        if (i > 0) a = T(0.5) * a;
        for (int k = threadIdx.x; k < n; k += kThreads)
            w.xt[k] = clip(w.x[k] + a * w.d[k], bx.lo[k], bx.hi[k]);
        evaluate(p, w.xt, rf, w.gt, sm, f_a, me_a);
        T v[1] = {T(0)};
        for (int k = threadIdx.x; k < n; k += kThreads)
            v[0] += w.g[k] * (w.xt[k] - w.x[k]);
        block_reduce(v, 1, sm.red);
        gdx = v[0];
        i += 1;
        ok = (f_a <= f0 + o.c1 * gdx) && is_finite(f_a) && (f_a < f0);
    } while (!ok && i < o.maxls);
    LineSearch<T> r;
    r.ok = ok;
    r.nfev = i;
    r.a = a;
    r.f = ok ? f_a : f0;
    r.me = ok ? me_a : me0;
    return r;
}

// The two-loop recursion over the circular history, newest to oldest,
// into d, with the fall back to -g on a non-descent direction. Slots
// k >= hlen are skipped: _solve_one weights them by valid = 0 and they
// hold zeros, so they change nothing. Bounded: the recursion runs on the
// masked gradient g_free = g * free, d is masked the same way, and the
// descent test and the fall back use g_free.
template <typename T, bool kBounded>
__device__ void direction(const Bufs<T>& w, const Box<T>& bx, int n, int m,
                          int head, int hlen, T* red) {
    T* q = w.d;
    for (int k = threadIdx.x; k < n; k += kThreads)
        q[k] = kBounded ? w.g[k] * free_of(w, bx, k) : w.g[k];
    T alpha[kMaxM], rho[kMaxM];
    T sy_n = T(0), yy_n = T(0);
    for (int j = 0; j < hlen; ++j) {
        const int idx = ((head - 1 - j) % m + m) % m;
        const T* s = w.S + (size_t)idx * n;
        const T* y = w.Y + (size_t)idx * n;
        T v[3] = {T(0), T(0), T(0)};
        for (int k = threadIdx.x; k < n; k += kThreads) {
            v[0] += s[k] * y[k];
            v[1] += s[k] * q[k];
            v[2] += y[k] * y[k];
        }
        block_reduce(v, 3, red);
        rho[j] = T(1) / nanmax(v[0], T(1e-30));
        alpha[j] = rho[j] * v[1];
        if (j == 0) {
            sy_n = v[0];
            yy_n = v[2];
        }
        for (int k = threadIdx.x; k < n; k += kThreads)
            q[k] = q[k] - alpha[j] * y[k];
    }
    const T gamma = hlen > 0 ? sy_n / nanmax(yy_n, T(1e-30)) : T(1);
    for (int k = threadIdx.x; k < n; k += kThreads) q[k] = gamma * q[k];
    for (int j = hlen - 1; j >= 0; --j) {
        const int idx = ((head - 1 - j) % m + m) % m;
        const T* s = w.S + (size_t)idx * n;
        const T* y = w.Y + (size_t)idx * n;
        const T beta = rho[j] * block_dot(y, q, n, red);
        for (int k = threadIdx.x; k < n; k += kThreads)
            q[k] = q[k] + (alpha[j] - beta) * s[k];
    }
    T v[1] = {T(0)};
    for (int k = threadIdx.x; k < n; k += kThreads) {
        if (kBounded) {
            const T fr = free_of(w, bx, k);
            q[k] = -q[k] * fr;
            v[0] += q[k] * (w.g[k] * fr);
        } else {
            q[k] = -q[k];
            v[0] += q[k] * w.g[k];
        }
    }
    block_reduce(v, 1, red);
    if (v[0] >= T(0) || !is_finite(v[0]))
        for (int k = threadIdx.x; k < n; k += kThreads)
            w.d[k] = kBounded ? -(w.g[k] * free_of(w, bx, k)) : -w.g[k];
}

template <typename T>
struct SolveResult {
    T f, me, pgnorm;
    int niter, nfev, status;
};

// _solve_one (solve_pallas.py): minimize the action at rf from w.x,
// leaving the minimizer in w.x and its gradient in w.g (the pointers may
// swap on the way), inside the box bx when kBounded. A fresh history
// every call.
template <typename T, bool kBounded>
__device__ __noinline__ SolveResult<T> solve_one(const L96Problem<T>& p,
                                                 T rf, const SolveOpts<T>& o,
                                                 Bufs<T>& w, const Box<T>& bx,
                                                 const Smem<T>& sm) {
    const int n = p.n_dof;
    const int m = o.m;
    SolveResult<T> r;
    if (kBounded) {                    // a feasible start
        for (int k = threadIdx.x; k < n; k += kThreads)
            w.x[k] = clip(w.x[k], bx.lo[k], bx.hi[k]);
    }
    evaluate(p, w.x, rf, w.g, sm, r.f, r.me);
    // sum g^2 (unbounded), sum |g|, max |projected g|
    T v0[3] = {T(0), T(0), T(0)};
    for (int k = threadIdx.x; k < n; k += kThreads) {
        const T gk = w.g[k];
        if (kBounded) {
            w.d[k] = -gk * free_of(w, bx, k);
            v0[2] = nanmax(v0[2], fabs(proj_grad(w.x[k], gk, bx.lo[k],
                                                 bx.hi[k])));
        } else {
            w.d[k] = -gk;
            v0[0] += gk * gk;
            v0[2] = nanmax(v0[2], fabs(gk));
        }
        v0[1] += fabs(gk);
    }
    block_reduce(v0, 2, sm.red);
    T dphi0 = -v0[0];
    T gnorm1 = v0[1];
    r.pgnorm = v0[2];
    bool done = r.pgnorm <= o.pgtol;
    r.status = done ? kConvGrad : kMaxIter;
    r.niter = 0;
    r.nfev = 1;
    int head = 0, hlen = 0;

    while (!done && r.niter < o.maxiter) {
        const T a_init = hlen == 0
            ? nanmin(T(1), T(1) / nanmax(gnorm1, T(1e-30))) : T(1);
        const LineSearch<T> ls =
            kBounded ? proj_line_search(p, rf, o, w, bx, r.f, r.me, a_init,
                                        sm)
                     : line_search(p, rf, o, w, r.f, r.me, dphi0, a_init,
                                   sm);
        // the new point: the trial buffers when a step was taken
        const T* xn = ls.ok ? w.xt : w.x;
        const T* gn = ls.ok ? w.gt : w.g;
        T v[5] = {T(0), T(0), T(0), T(0), T(0)};  // sy s2 y2 |gn|_1 |gn|_max
        for (int k = threadIdx.x; k < n; k += kThreads) {
            const T s = xn[k] - w.x[k];
            const T y = gn[k] - w.g[k];
            v[0] += s * y;
            v[1] += s * s;
            v[2] += y * y;
            v[3] += fabs(gn[k]);
            v[4] = nanmax(v[4], fabs(kBounded ? proj_grad(xn[k], gn[k],
                                                          bx.lo[k], bx.hi[k])
                                              : gn[k]));
        }
        block_reduce(v, 4, sm.red);
        const T sy = v[0];
        const bool good = ls.ok && (sy > T(1e-10) * sqrt(v[1] * v[2]))
                          && (sy > T(0));
        if (good) {
            T* S = w.S + (size_t)head * n;
            T* Y = w.Y + (size_t)head * n;
            for (int k = threadIdx.x; k < n; k += kThreads) {
                S[k] = xn[k] - w.x[k];
                Y[k] = gn[k] - w.g[k];
            }
            head = (head + 1) % m;
            hlen = min(hlen + 1, m);
        }
        const T pgn = v[4];
        const T df = r.f - ls.f;
        const T fden = nanmax(nanmax(fabs(r.f), fabs(ls.f)), T(1));
        const bool conv_g = pgn <= o.pgtol;
        const bool conv_f = df <= o.ftol * fden;
        const bool fail = !ls.ok;
        done = conv_g || conv_f || fail;
        r.status = conv_g ? kConvGrad
                   : (fail ? kLsFail : (conv_f ? kConvFtol : kMaxIter));
        if (!fail) {           // keep the old point on line-search failure
            T* t = w.x; w.x = w.xt; w.xt = t;
            t = w.g; w.g = w.gt; w.gt = t;
            r.f = ls.f;
            r.me = ls.me;
        }
        r.pgnorm = pgn;
        gnorm1 = v[3];
        r.niter += 1;
        r.nfev += ls.nfev;
        if (!done && r.niter < o.maxiter) {
            direction<T, kBounded>(w, bx, n, m, head, hlen, sm.red);
            if (!kBounded) dphi0 = block_dot(w.g, w.d, n, sm.red);
        }
    }
    return r;
}

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
    return Smem<T>{s, red, red + kMaxRed * kWarps};
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
    const SolveResult<T> r = solve_one<T, kBounded>(p, rf, o, w, bx, sm);
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
        const SolveResult<T> r = solve_one<T, false>(p, rfs[j], o, w, none,
                                                     sm);
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

template <typename T>
L96Problem<T> problem(int n_dof, int N, int D, int pslot, double F_fixed,
                      const void* Y, const void* W, const void* lidx,
                      const void* lpos, int N_data, int L, int obs_stride,
                      double h, double me_norm, double fe_norm) {
    return L96Problem<T>{n_dof, N, D, pslot, (T)F_fixed,
                         static_cast<const T*>(Y), static_cast<const T*>(W),
                         static_cast<const int*>(lidx),
                         static_cast<const int*>(lpos), N_data, L,
                         obs_stride, (T)h, (T)me_norm, (T)fe_norm};
}

template <typename T>
SolveOpts<T> solve_opts(int m, int maxiter, int maxls, double c1, double c2,
                        double pgtol, double ftol) {
    return SolveOpts<T>{m, maxiter, maxls, (T)c1, (T)c2, (T)pgtol, (T)ftol};
}

// Dynamic shared memory above 48 KB needs the opt-in; a launch without it
// is refused and never runs.
template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
#define VA_SOLVE_ARGS                                                       \
    const void *XP, int B, int n_dof, int N, int D, int pslot,             \
        double F_fixed, const void *Y, const void *W, const void *lidx,    \
        const void *lpos, int N_data, int L, int obs_stride, double h,     \
        double me_norm, double fe_norm, int m, int maxiter, int maxls,     \
        double c1, double c2, double pgtol, double ftol
#define VA_SOLVE_PASS                                                       \
    XP, B, n_dof, N, D, pslot, F_fixed, Y, W, lidx, lpos, N_data, L,       \
        obs_stride, h, me_norm, fe_norm, m, maxiter, maxls, c1, c2, pgtol, \
        ftol

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
