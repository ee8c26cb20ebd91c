// The whole L-BFGS rung solve of one member by one group of threads, the
// body of K2 and K3 (solve_kernel.cu, the group being the whole block) and
// of K8 (pack_kernel.cu, a warp-aligned group of the block a member). It
// transcribes varanneal_tpu/kernels/solve_pallas.py::_solve_one; the notes
// at the top of solve_kernel.cu say what it computes and how.
//
// Every function here is generic over the group policy Grp of
// l96_ag_block.cuh: the thread's rank and the group's size stand where
// threadIdx.x and the block's size stood, and Grp::sync() where
// __syncthreads() stood, so that a whole-block instantiation is the code
// K2 and K3 had before groups existed. Control flow is group-uniform:
// every thread of a group takes every branch together, and groups never
// wait for each other (a member that finishes early leaves its group's
// threads idle, not the pack's).

#pragma once

#include <cfloat>
#include <cuda_runtime.h>

#include "l96_ag_block.cuh"

namespace {

constexpr int kMaxRed = 5;     // most values one group reduction carries
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

// Shared memory of one solving group: the evaluation's area, the solver's
// reduction partials and the evaluation's two outputs (A, ME).
template <typename T>
struct Smem {
    T* ag;
    T* red;
    T* out;
};

__host__ __device__ inline size_t solve_smem_elems(int N, int D,
                                                   int warps = kAgWarps) {
    return l96_ag_smem_elems(N, D, false, warps) + kMaxRed * warps + 2;
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

// Group-wide fixed-order reduction of K values: entries [0, first_max)
// are sums, the rest NaN-propagating maxima. Every thread of the group
// gets the totals.
template <typename Grp, typename T, int K>
__device__ void block_reduce(T (&v)[K], int first_max, T* red) {
    const int lane = Grp::rank() & 31;
    const int warp = Grp::rank() >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        for (int o = 16; o > 0; o >>= 1) {
            const T u = __shfl_down_sync(0xffffffffu, v[k], o);
            v[k] = k < first_max ? v[k] + u : nanmax(v[k], u);
        }
        if (lane == 0) red[k * Grp::kWarps + warp] = v[k];
    }
    Grp::sync();
#pragma unroll
    for (int k = 0; k < K; ++k) {
        T t = red[k * Grp::kWarps];
        for (int w = 1; w < Grp::kWarps; ++w)
            t = k < first_max ? t + red[k * Grp::kWarps + w]
                              : nanmax(t, red[k * Grp::kWarps + w]);
        v[k] = t;
    }
    Grp::sync();          // partials read: the next reduction may write
}

template <typename Grp, typename T>
__device__ __forceinline__ T block_dot(const T* a, const T* b, int n,
                                       T* red) {
    T v[1] = {T(0)};
    for (int i = Grp::rank(); i < n; i += Grp::kSize) v[0] += a[i] * b[i];
    block_reduce<Grp>(v, 1, red);
    return v[0];
}

// f and ME at x, gradient into g. The leading barrier makes every
// thread's writes to x visible (the routine reads neighbours) and frees
// the shared areas; the trailing one publishes g[pslot] and the outputs.
template <typename Grp, typename T>
__device__ void evaluate(const L96Problem<T>& p, const T* x, T rf, T* g,
                         const Smem<T>& sm, T& f, T& me) {
    Grp::sync();
    l96_ag_block<T, true, false, Grp>(p, x, rf, g, sm.ag, sm.out);
    Grp::sync();
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
template <typename Grp, typename T>
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
        for (int k = Grp::rank(); k < n; k += Grp::kSize)
            w.xt[k] = w.x[k] + a * w.d[k];
        T f_a, me_a;
        evaluate<Grp>(p, w.xt, rf, w.gt, sm, f_a, me_a);
        const T dphi_a = block_dot<Grp>(w.gt, w.d, n, sm.red);
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
        for (int k = Grp::rank(); k < n; k += Grp::kSize)
            w.xt[k] = w.x[k] + a_lo * w.d[k];
        evaluate<Grp>(p, w.xt, rf, w.gt, sm, r.f, r.me);
        r.a = a_lo;
        r.nfev = i + 1;
    }
    return r;
}

// _solve_one.proj_ls: Armijo backtracking along the projected path from
// w.x along w.d, the trial point P(x + a d) in w.xt and its gradient in
// w.gt. ok: the last trial decreased f enough (it is then the new
// point); nfev counts every trial, the first included.
template <typename Grp, typename T>
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
        for (int k = Grp::rank(); k < n; k += Grp::kSize)
            w.xt[k] = clip(w.x[k] + a * w.d[k], bx.lo[k], bx.hi[k]);
        evaluate<Grp>(p, w.xt, rf, w.gt, sm, f_a, me_a);
        T v[1] = {T(0)};
        for (int k = Grp::rank(); k < n; k += Grp::kSize)
            v[0] += w.g[k] * (w.xt[k] - w.x[k]);
        block_reduce<Grp>(v, 1, sm.red);
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
template <typename Grp, bool kBounded, typename T>
__device__ void direction(const Bufs<T>& w, const Box<T>& bx, int n, int m,
                          int head, int hlen, T* red) {
    T* q = w.d;
    for (int k = Grp::rank(); k < n; k += Grp::kSize)
        q[k] = kBounded ? w.g[k] * free_of(w, bx, k) : w.g[k];
    T alpha[kMaxM], rho[kMaxM];
    T sy_n = T(0), yy_n = T(0);
    for (int j = 0; j < hlen; ++j) {
        const int idx = ((head - 1 - j) % m + m) % m;
        const T* s = w.S + (size_t)idx * n;
        const T* y = w.Y + (size_t)idx * n;
        T v[3] = {T(0), T(0), T(0)};
        for (int k = Grp::rank(); k < n; k += Grp::kSize) {
            v[0] += s[k] * y[k];
            v[1] += s[k] * q[k];
            v[2] += y[k] * y[k];
        }
        block_reduce<Grp>(v, 3, red);
        rho[j] = T(1) / nanmax(v[0], T(1e-30));
        alpha[j] = rho[j] * v[1];
        if (j == 0) {
            sy_n = v[0];
            yy_n = v[2];
        }
        for (int k = Grp::rank(); k < n; k += Grp::kSize)
            q[k] = q[k] - alpha[j] * y[k];
    }
    const T gamma = hlen > 0 ? sy_n / nanmax(yy_n, T(1e-30)) : T(1);
    for (int k = Grp::rank(); k < n; k += Grp::kSize) q[k] = gamma * q[k];
    for (int j = hlen - 1; j >= 0; --j) {
        const int idx = ((head - 1 - j) % m + m) % m;
        const T* s = w.S + (size_t)idx * n;
        const T* y = w.Y + (size_t)idx * n;
        const T beta = rho[j] * block_dot<Grp>(y, q, n, red);
        for (int k = Grp::rank(); k < n; k += Grp::kSize)
            q[k] = q[k] + (alpha[j] - beta) * s[k];
    }
    T v[1] = {T(0)};
    for (int k = Grp::rank(); k < n; k += Grp::kSize) {
        if (kBounded) {
            const T fr = free_of(w, bx, k);
            q[k] = -q[k] * fr;
            v[0] += q[k] * (w.g[k] * fr);
        } else {
            q[k] = -q[k];
            v[0] += q[k] * w.g[k];
        }
    }
    block_reduce<Grp>(v, 1, red);
    if (v[0] >= T(0) || !is_finite(v[0]))
        for (int k = Grp::rank(); k < n; k += Grp::kSize)
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
template <typename Grp, bool kBounded, typename T>
__device__ __noinline__ SolveResult<T> solve_one(const L96Problem<T>& p,
                                                 T rf, const SolveOpts<T>& o,
                                                 Bufs<T>& w, const Box<T>& bx,
                                                 const Smem<T>& sm) {
    const int n = p.n_dof;
    const int m = o.m;
    SolveResult<T> r;
    if (kBounded) {                    // a feasible start
        for (int k = Grp::rank(); k < n; k += Grp::kSize)
            w.x[k] = clip(w.x[k], bx.lo[k], bx.hi[k]);
    }
    evaluate<Grp>(p, w.x, rf, w.g, sm, r.f, r.me);
    // sum g^2 (unbounded), sum |g|, max |projected g|
    T v0[3] = {T(0), T(0), T(0)};
    for (int k = Grp::rank(); k < n; k += Grp::kSize) {
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
    block_reduce<Grp>(v0, 2, sm.red);
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
            kBounded ? proj_line_search<Grp>(p, rf, o, w, bx, r.f, r.me,
                                             a_init, sm)
                     : line_search<Grp>(p, rf, o, w, r.f, r.me, dphi0,
                                        a_init, sm);
        // the new point: the trial buffers when a step was taken
        const T* xn = ls.ok ? w.xt : w.x;
        const T* gn = ls.ok ? w.gt : w.g;
        T v[5] = {T(0), T(0), T(0), T(0), T(0)};  // sy s2 y2 |gn|_1 |gn|_max
        for (int k = Grp::rank(); k < n; k += Grp::kSize) {
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
        block_reduce<Grp>(v, 4, sm.red);
        const T sy = v[0];
        const bool good = ls.ok && (sy > T(1e-10) * sqrt(v[1] * v[2]))
                          && (sy > T(0));
        if (good) {
            T* S = w.S + (size_t)head * n;
            T* Y = w.Y + (size_t)head * n;
            for (int k = Grp::rank(); k < n; k += Grp::kSize) {
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
            direction<Grp, kBounded>(w, bx, n, m, head, hlen, sm.red);
            if (!kBounded) dphi0 = block_dot<Grp>(w.g, w.d, n, sm.red);
        }
    }
    return r;
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

}  // namespace

// The problem's and the options' arguments of the solve kernels' extern "C"
// entries (solve_kernel.cu, pack_kernel.cu), and their pass-through.
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
