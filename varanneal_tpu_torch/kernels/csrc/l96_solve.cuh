// The whole L-BFGS rung solve of one member by one group of threads, the
// body of K2 and K3 (solve_kernel.cu, the group being the whole block) and
// of K8 (pack_kernel.cu, a warp-aligned group of the block a member). It
// transcribes varanneal_tpu/kernels/solve_pallas.py::_solve_one; the notes
// at the top of solve_kernel.cu say what it computes and how.
//
// Every function here is generic over the group policy Grp of
// l96_ag_block.cuh: the thread's rank and the group's size stand where
// threadIdx.x and the block's size stood, and Grp::sync() where
// __syncthreads() stood. Control flow is group-uniform: every thread of a
// group takes every branch together, and groups never wait for each other
// (a member that finishes early leaves its group's threads idle, not the
// pack's).
//
// The serial chain of an iteration, and what this body does about it. A
// member's solve is a chain of evaluations and group reductions, each
// waiting on the last; its time is the chain's latency, not bytes or
// operations. Per iteration (m = 5, a full history, one line-search
// trial) the chain holds 15 group barriers: 2 in the evaluation (the
// leading one, after other threads wrote x, and the routine's one, which
// publishes its partials), 1 for the trial's directional derivative, 1
// for the post-step sums, and 11 in the two-loop direction (one reduction
// a pair and loop, one for the descent test). To get there from the 31 of
// the first port:
//
// - one barrier per reduction: block_reduce alternates between two
//   partials areas, so a reduction never waits for the readers of the
//   last one (they have passed this reduction's barrier before the area
//   is written again);
// - the descent test's sum is the next line search's dphi0 (the same
//   products in the same order); on the fall back to -g, dphi0 = -sum g^2,
//   carried by the post-step reduction;
// - s.y and y.y of each history pair are the post-step reduction's, kept
//   per slot (Bufs::sy, yy) when the pair is written, so the two-loop's
//   first loop reduces s.q alone;
// - the evaluation's partials are a reduction's: they alternate with the
//   solver's between the same two areas, so no trailing barrier frees
//   them, and every thread gets f and ME from them in registers;
// - alpha lives in shared memory, not in thread-local arrays;
// - each pass over the vectors applies one pair's update to q and
//   accumulates the next pair's dot in the same loop;
// - where a pass reads global memory, it loads kChunkGlobal entries
//   before it stores any (chunked_pass).
//
// Every sum of the solver keeps the order and the reduction tree of the
// first port (per-thread strided partials, a warp shuffle tree, the warps
// in order). The evaluation's own sums (FE, sum r, ME) are summed along
// its walk in time (l96_ag_block.cuh), in another order than the first
// port's, so an f32 solve parts from the first port's by the rounding of
// those sums. The compact direction (all 2m dots in one reduction) would
// change every f32 sum of the solver and is not used.
// nvcc's FMA contraction is part of the arithmetic: beta is rounded apart
// from alpha - beta because the first port's loop rounded it apart.
// Where a member's vectors live (shared or global memory) is the kernels'
// layout argument.

#pragma once

#include <cfloat>
#include <cuda_runtime.h>

#include "l96_ag_block.cuh"

namespace {

constexpr int kMaxRed = 6;     // most values one group reduction carries
constexpr int kMaxM = 16;      // largest history (the wrapper's envelope)

// The layout's flags: the groups of a member's vectors kept in shared
// memory (kernels/solve.py::plan_layout chooses them); the rest lives in
// the member's global workspace (the bounds: in the caller's arrays). The
// evaluation's ring of rows is on chip unless kRingOffChip moves it to the
// workspace, where it does not fit in shared memory.
constexpr int kVectorsOnChip = 1;   // x, g, d, the trial x and g
constexpr int kHistoryOnChip = 2;   // S, Y and their s.y, y.y
constexpr int kBoundsOnChip = 4;    // lo, hi (K2 bounded)
constexpr int kRingOffChip = 8;     // the warps' rings (l96_ag_block.cuh)
constexpr int kLayoutFlags = 15;

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

// Shared memory of one solving group: `red`, two reduction-partials
// areas (kMaxRed values a warp each; the evaluation's partials take one
// as a reduction's do) and the two-loop's alpha (kMaxM values); `ring`,
// the evaluation's rings of rows (in shared memory, or in the member's
// workspace under kRingOffChip). `turn`: the partials area the group's
// next reduction writes.
template <typename T>
struct Smem {
    T* red;
    T* ring;
    int turn;
};

static_assert(kAgSums <= kMaxRed, "the evaluation's sums fit an area");

// The group's area in elements before its ring: the two partials areas
// and alpha.
__host__ __device__ inline size_t solve_base_elems(int warps = kAgWarps) {
    return (size_t)2 * kMaxRed * warps + kMaxM;
}

// A group's area in elements: the base and, on chip, its rings. It does
// not grow with N.
__host__ __device__ inline size_t solve_smem_elems(int D,
                                                   int warps = kAgWarps,
                                                   bool ring = true) {
    return solve_base_elems(warps)
           + (ring ? l96_ag_ring_elems(D, warps) : 0);
}

// A member's vectors. x/xt and g/gt swap roles when a step is taken, so
// the pointers travel with the solve.
template <typename T>
struct Bufs {
    T* x;
    T* g;
    T* d;
    T* xt;      // trial point
    T* gt;      // gradient at the trial point
    T* S;       // (m, n) steps
    T* Y;       // (m, n) gradient differences
    T* sy;      // (m,) s.y of each pair, as the post-step reduction summed it
    T* yy;      // (m,) y.y of each pair
};

// Elements of each group of a member's vectors.
__host__ __device__ inline size_t vectors_elems(int n) {
    return (size_t)5 * n;
}
__host__ __device__ inline size_t history_elems(int n, int m) {
    return (size_t)2 * m * n + 2 * m;
}
__host__ __device__ inline size_t bounds_elems(int n) {
    return (size_t)2 * n;
}

// A member's global workspace in elements: the groups `layout` leaves off
// chip, then, under kRingOffChip, the rings of its group of `warps` warps.
__host__ __device__ inline size_t work_elems(int n, int m, int D, int layout,
                                             int warps = kAgWarps) {
    return ((layout & kVectorsOnChip) ? 0 : vectors_elems(n))
           + ((layout & kHistoryOnChip) ? 0 : history_elems(n, m))
           + ((layout & kRingOffChip) ? l96_ag_ring_elems(D, warps) : 0);
}

// Shared memory of one member's group of `warps` warps (the whole block by
// default) in elements under `layout`: the group's area, then the groups
// on chip, in the order vectors, history, bounds.
__host__ __device__ inline size_t layout_smem_elems(int D, int n, int m,
                                                    int layout,
                                                    int warps = kAgWarps) {
    return solve_smem_elems(D, warps, !(layout & kRingOffChip))
           + ((layout & kVectorsOnChip) ? vectors_elems(n) : 0)
           + ((layout & kHistoryOnChip) ? history_elems(n, m) : 0)
           + ((layout & kBoundsOnChip) ? bounds_elems(n) : 0);
}

// The member's vectors, each group at `chip` (shared memory past the
// group's area, in layout_smem_elems' order) or in its workspace `work`,
// as `layout` says.
template <typename T>
__device__ Bufs<T> member_bufs(T* chip, T* work, int n, int m, int layout) {
    T* v = work;
    if (layout & kVectorsOnChip) {
        v = chip;
        chip += vectors_elems(n);
    } else {
        work += vectors_elems(n);
    }
    T* h = (layout & kHistoryOnChip) ? chip : work;
    T* sy = h + (size_t)2 * m * n;
    return Bufs<T>{v, v + n, v + 2 * n, v + 3 * n, v + 4 * n,
                   h, h + (size_t)m * n, sy, sy + m};
}

// The shared memory of a group of `warps` warps at s: its base area, then
// its rings there, or in the member's workspace `work` past the groups
// `layout` leaves off chip.
template <typename T>
__device__ Smem<T> group_smem(T* s, T* work, int n, int m, int D, int layout,
                              int warps = kAgWarps) {
    T* ring = (layout & kRingOffChip)
        ? work + work_elems(n, m, D, layout & ~kRingOffChip, warps)
        : s + solve_base_elems(warps);
    return Smem<T>{s, ring, 0};
}

// Where the bounds go on chip: past the vectors and history that are there.
template <typename T>
__device__ T* chip_bounds(T* chip, int n, int m, int layout) {
    return chip + ((layout & kVectorsOnChip) ? vectors_elems(n) : 0)
           + ((layout & kHistoryOnChip) ? history_elems(n, m) : 0);
}

// 1 where entry k of the member's current point is free, 0 where frozen
// (the mask _solve_one multiplies by).
template <typename T>
__device__ __forceinline__ T free_of(const Bufs<T>& w, const Box<T>& bx,
                                     int k) {
    return frozen(w.x[k], w.g[k], bx.lo[k], bx.hi[k]) ? T(0) : T(1);
}

// A vector pass over the thread's entries, kChunk at a time: every load
// of a chunk first (load(k), in the order of k), then apply(k, loaded) in
// the order of k, so the sums a pass carries see the entries in the order
// of a plain strided loop. A pass that stores (q, the trial point, the
// history) would otherwise wait for each entry's loads before the next
// entry's: the compiler does not move a load above a store through a
// pointer that may alias it. So the entries of a chunk wait one memory
// latency together. That pays where a pass reads global memory; where a
// member's vectors and history are all in shared memory the latency is
// short, and the chunk's registers cost more than it saves (chunk_of).
constexpr int kChunkGlobal = 4;

__host__ __device__ inline int chunk_of(int layout) {
    return ((layout & kVectorsOnChip) && (layout & kHistoryOnChip))
               ? 1 : kChunkGlobal;
}

template <typename Grp, int kChunk, typename Load, typename Apply>
__device__ __forceinline__ void chunked_pass(int n, Load load, Apply apply) {
    using L = decltype(load(0));
    for (int k0 = Grp::rank(); k0 < n; k0 += kChunk * Grp::kSize) {
        L got[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
            const int k = k0 + u * Grp::kSize;
            if (k < n) got[u] = load(k);
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
            const int k = k0 + u * Grp::kSize;
            if (k < n) apply(k, got[u]);
        }
    }
}

// The trial point x + a d into xt (clipped into the box when bounded).
template <typename Grp, bool kBounded, int kChunk, typename T>
__device__ __forceinline__ void trial_point(const Bufs<T>& w,
                                            const Box<T>& bx, int n, T a) {
    chunked_pass<Grp, kChunk>(
        n,
        [&](int k) {
            return Vals<T, 4>{{w.x[k], w.d[k], kBounded ? bx.lo[k] : T(0),
                               kBounded ? bx.hi[k] : T(0)}};
        },
        [&](int k, const Vals<T, 4>& l) {
            const T t = l.v[0] + a * l.v[1];
            w.xt[k] = kBounded ? clip(t, l.v[2], l.v[3]) : t;
        });
}

// Group-wide fixed-order reduction of K values: entries [0, first_max)
// are sums, the rest NaN-propagating maxima. Every thread of the group
// gets the totals. The partials go to the area of sm.turn, and the next
// reduction takes the other: a thread reads this area only before it
// reaches the group's next barrier, and nothing writes the area again
// before the barrier after that.
template <typename Grp, typename T, int K>
__device__ __forceinline__ void block_reduce(T (&v)[K], int first_max,
                                             Smem<T>& sm) {
    T* red = sm.red + sm.turn * (kMaxRed * Grp::kWarps);
    sm.turn ^= 1;
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
}

template <typename Grp, typename T>
__device__ __forceinline__ T block_dot(const T* a, const T* b, int n,
                                       Smem<T>& sm) {
    T v[1] = {T(0)};
    for (int i = Grp::rank(); i < n; i += Grp::kSize) v[0] += a[i] * b[i];
    block_reduce<Grp>(v, 1, sm);
    return v[0];
}

// f and ME at x, gradient into g. The leading barrier makes every
// thread's writes to x visible (the routine reads neighbours across
// threads) and ends every read of the rings; the routine's own barrier
// publishes its partials, which take the partials area of sm.turn as a
// reduction does. g[pslot] is written by the thread that owns it in the
// vector passes, so no trailing barrier is needed.
template <typename Grp, typename T>
__device__ __forceinline__ void evaluate(const L96Problem<T>& p, const T* x,
                                         T rf, T* g, Smem<T>& sm, T& f,
                                         T& me) {
    Grp::sync();
    T* red = sm.red + sm.turn * (kMaxRed * Grp::kWarps);
    sm.turn ^= 1;
    const AgSums<T> s =
        l96_ag_block<T, false, Grp>(p, x, rf, g, sm.ring, red);
    f = s.A;
    me = s.me;
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
template <typename Grp, int kChunk, typename T>
__device__ __forceinline__ LineSearch<T> line_search(
        const L96Problem<T>& p, T rf, const SolveOpts<T>& o,
        const Bufs<T>& w, T f0, T me0, T dphi0, T a_init, Smem<T>& sm) {
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
        trial_point<Grp, false, kChunk>(w, Box<T>{nullptr, nullptr}, n, a);
        T f_a, me_a;
        evaluate<Grp>(p, w.xt, rf, w.gt, sm, f_a, me_a);
        const T dphi_a = block_dot<Grp>(w.gt, w.d, n, sm);
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
        trial_point<Grp, false, kChunk>(w, Box<T>{nullptr, nullptr}, n, a_lo);
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
template <typename Grp, int kChunk, typename T>
__device__ __forceinline__ LineSearch<T> proj_line_search(
        const L96Problem<T>& p, T rf, const SolveOpts<T>& o,
        const Bufs<T>& w, const Box<T>& bx, T f0, T me0, T a_init,
        Smem<T>& sm) {
    const int n = p.n_dof;
    T a = a_init;
    T f_a, me_a, gdx;
    int i = 0;
    bool ok = false;
    do {
        if (i > 0) a = T(0.5) * a;
        trial_point<Grp, true, kChunk>(w, bx, n, a);
        evaluate<Grp>(p, w.xt, rf, w.gt, sm, f_a, me_a);
        T v[1] = {T(0)};
        for (int k = Grp::rank(); k < n; k += Grp::kSize)
            v[0] += w.g[k] * (w.xt[k] - w.x[k]);
        block_reduce<Grp>(v, 1, sm);
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

// Slot of the j-th newest pair of the circular history.
__device__ __forceinline__ int pair_slot(int head, int j, int m) {
    return ((head - 1 - j) % m + m) % m;
}

// The two-loop recursion over the circular history, newest to oldest,
// into d, with the fall back to -g on a non-descent direction. Slots
// k >= hlen are skipped: _solve_one weights them by valid = 0 and they
// hold zeros, so they change nothing. Bounded: the recursion runs on the
// masked gradient g_free = g * free, d is masked the same way, and the
// descent test and the fall back use g_free. Returns the descent test's
// sum d.g (d.g_free bounded) before any fall back.
//
// Each pass applies the last pair's update to q and sums the next pair's
// dot with the updated entry, in the same per-thread order as separate
// passes would: pass j of the first loop sets q (g, or q - alpha y of
// pair j-1) and sums s_j.q; the second loop's first pass finishes the
// first loop and scales by gamma, the next ones add (alpha - beta) s;
// the last pass negates q into d and sums the descent test. A pair's s.y
// is read before its pass, off the barrier's path: from `fresh_sy` for
// the pair written this iteration (`fresh`, at the newest slot; rank 0's
// copy of it is not yet visible), else from w.sy, written iterations and
// barriers ago. beta is rounded before alpha - beta, as the first port's
// loop rounded it (a product nvcc fused into the subtraction would
// change the bits).
template <typename Grp, bool kBounded, int kChunk, typename T>
__device__ __forceinline__ T direction(const Bufs<T>& w, const Box<T>& bx,
                                       int n, int m, int head, int hlen,
                                       bool fresh, T fresh_sy, T fresh_yy,
                                       Smem<T>& sm) {
    T* q = w.d;
    T* alpha = sm.red + 2 * kMaxRed * Grp::kWarps;  // written by rank 0
    // the pending update of q: q - a_up * y_up (first loop), or
    // q + a_up * y_up (second loop, y_up being s and a_up alpha - beta)
    T a_up = T(0);
    const T* y_up = nullptr;
    for (int j = 0; j < hlen; ++j) {
        const int sl = pair_slot(head, j, m);
        const T* s = w.S + (size_t)sl * n;
        const T sy = (j == 0 && fresh) ? fresh_sy : w.sy[sl];
        T v[1] = {T(0)};
        chunked_pass<Grp, kChunk>(
            n,
            [&](int k) {
                // j = 0: g (masked) in place of q
                return Vals<T, 3>{{
                    j == 0 ? (kBounded ? w.g[k] * free_of(w, bx, k) : w.g[k])
                           : q[k],
                    j == 0 ? T(0) : y_up[k], s[k]}};
            },
            [&](int k, const Vals<T, 3>& l) {
                const T qk = j == 0 ? l.v[0] : l.v[0] - a_up * l.v[1];
                q[k] = qk;
                v[0] += l.v[2] * qk;
            });
        block_reduce<Grp>(v, 1, sm);
        const T rho = T(1) / nanmax(sy, T(1e-30));
        a_up = rho * v[0];
        y_up = w.Y + (size_t)sl * n;
        if (Grp::rank() == 0) alpha[j] = a_up;
    }
    T gamma = T(1);
    if (hlen > 0) {
        const int sl = pair_slot(head, 0, m);
        gamma = (fresh ? fresh_sy : w.sy[sl])
                / nanmax(fresh ? fresh_yy : w.yy[sl], T(1e-30));
    }
    for (int j = hlen - 1; j >= 0; --j) {
        const int sl = pair_slot(head, j, m);
        const T* y = w.Y + (size_t)sl * n;
        const T sy = (j == 0 && fresh) ? fresh_sy : w.sy[sl];
        T v[1] = {T(0)};
        chunked_pass<Grp, kChunk>(
            n,
            [&](int k) { return Vals<T, 3>{{q[k], y_up[k], y[k]}}; },
            [&](int k, const Vals<T, 3>& l) {
                const T qk = j == hlen - 1
                    ? gamma * (l.v[0] - a_up * l.v[1])
                    : l.v[0] + a_up * l.v[1];
                q[k] = qk;
                v[0] += l.v[2] * qk;
            });
        block_reduce<Grp>(v, 1, sm);
        const T beta = mul_rn(T(1) / nanmax(sy, T(1e-30)), v[0]);
        a_up = alpha[j] - beta;
        y_up = w.S + (size_t)sl * n;
    }
    T v[1] = {T(0)};
    chunked_pass<Grp, kChunk>(
        n,
        [&](int k) {
            return Vals<T, 4>{{hlen > 0 ? q[k] : T(0),
                               hlen > 0 ? y_up[k] : T(0), w.g[k],
                               kBounded ? free_of(w, bx, k) : T(1)}};
        },
        [&](int k, const Vals<T, 4>& l) {
            const T g = l.v[2];
            T qk = hlen > 0 ? l.v[0] + a_up * l.v[1]
                            : gamma * (kBounded ? g * l.v[3] : g);
            if (kBounded) {
                qk = -qk * l.v[3];
                v[0] += qk * (g * l.v[3]);
            } else {
                qk = -qk;
                v[0] += qk * g;
            }
            q[k] = qk;
        });
    block_reduce<Grp>(v, 1, sm);
    if (v[0] >= T(0) || !is_finite(v[0]))
        for (int k = Grp::rank(); k < n; k += Grp::kSize)
            w.d[k] = kBounded ? -(w.g[k] * free_of(w, bx, k)) : -w.g[k];
    return v[0];
}

template <typename T>
struct SolveResult {
    T f, me, pgnorm;
    int niter, nfev, status;
};

// _solve_one (solve_pallas.py): minimize the action at rf from w.x,
// leaving the minimizer in w.x and its gradient in w.g (the pointers may
// swap on the way), inside the box bx when kBounded. A fresh history
// every call. kChunk: the entries a vector pass loads together
// (chunk_of the layout).
template <typename Grp, bool kBounded, int kChunk, typename T>
__device__ __noinline__ SolveResult<T> solve_one(const L96Problem<T>& p,
                                                 T rf, const SolveOpts<T>& o,
                                                 Bufs<T>& w, const Box<T>& bx,
                                                 Smem<T> sm) {
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
    block_reduce<Grp>(v0, 2, sm);
    T dphi0 = -v0[0];
    T gnorm1 = v0[1];
    r.pgnorm = v0[2];
    bool done = r.pgnorm <= o.pgtol;
    r.status = done ? kConvGrad : kMaxIter;
    r.niter = 0;
    r.nfev = 1;
    int head = 0, hlen = 0;
    // the post-step sums: sy s2 y2 |gn|_1, then gn.gn where the fall back
    // to -g takes dphi0 from it, then |gn|_max
    constexpr int kPost = kBounded ? 5 : 6;

    while (!done && r.niter < o.maxiter) {
        const T a_init = hlen == 0
            ? nanmin(T(1), T(1) / nanmax(gnorm1, T(1e-30))) : T(1);
        const LineSearch<T> ls =
            kBounded ? proj_line_search<Grp, kChunk>(p, rf, o, w, bx, r.f,
                                                     r.me, a_init, sm)
                     : line_search<Grp, kChunk>(p, rf, o, w, r.f, r.me,
                                                dphi0, a_init, sm);
        // the new point: the trial buffers when a step was taken
        const T* xn = ls.ok ? w.xt : w.x;
        const T* gn = ls.ok ? w.gt : w.g;
        T v[kPost];
#pragma unroll
        for (int i = 0; i < kPost; ++i) v[i] = T(0);
        for (int k = Grp::rank(); k < n; k += Grp::kSize) {
            const T s = xn[k] - w.x[k];
            const T y = gn[k] - w.g[k];
            v[0] += s * y;
            v[1] += s * s;
            v[2] += y * y;
            v[3] += fabs(gn[k]);
            if constexpr (!kBounded) v[4] += gn[k] * gn[k];
            v[kPost - 1] = nanmax(v[kPost - 1],
                                  fabs(kBounded ? proj_grad(xn[k], gn[k],
                                                            bx.lo[k],
                                                            bx.hi[k])
                                                : gn[k]));
        }
        block_reduce<Grp>(v, kPost - 1, sm);
        const T sy = v[0];
        const bool good = ls.ok && (sy > T(1e-10) * sqrt(v[1] * v[2]))
                          && (sy > T(0));
        if (good) {
            T* S = w.S + (size_t)head * n;
            T* Y = w.Y + (size_t)head * n;
            chunked_pass<Grp, kChunk>(
                n,
                [&](int k) {
                    return Vals<T, 4>{{xn[k], w.x[k], gn[k], w.g[k]}};
                },
                [&](int k, const Vals<T, 4>& l) {
                    S[k] = l.v[0] - l.v[1];
                    Y[k] = l.v[2] - l.v[3];
                });
            if (Grp::rank() == 0) {
                w.sy[head] = v[0];
                w.yy[head] = v[2];
            }
            head = (head + 1) % m;
            hlen = min(hlen + 1, m);
        }
        const T pgn = v[kPost - 1];
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
            const T dg = direction<Grp, kBounded, kChunk>(
                w, bx, n, m, head, hlen, good, v[0], v[2], sm);
            // d.g of the direction, or of -g: -sum g^2 rounds to the
            // negation of sum g.(-g), the same products and order
            if constexpr (!kBounded)
                dphi0 = (dg >= T(0) || !is_finite(dg)) ? -v[4] : dg;
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
// is refused and never runs. A refusal's error is read back here, or the
// next launch's cudaGetLastError would report it again.
template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) cudaGetLastError();
    return e;
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
