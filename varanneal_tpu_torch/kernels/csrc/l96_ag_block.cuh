// The Lorenz-96 trapezoid action and its full gradient for one ensemble
// member, computed by one group of threads: by default the whole thread
// block of kAgThreads threads (BlockGroup). K1 (ag_kernel.cu) is a thin
// __global__ around it; the whole-solve kernels (solve_kernel.cu) call it
// once per evaluation inside their L-BFGS loop; the packed solve kernel
// (pack_kernel.cu) gives each member of a pack a warp-aligned WarpGroup of
// the block, with its own named barrier.
//
//   r_n  = x_{n+1} - x_n - (h/2)(f(x_n) + f(x_{n+1})),  n < N-1
//   A    = me_norm * sum W (x_obs - Y)^2 + fe_norm * rf * sum r^2
//   gX_n = 2c [r_{n-1} - r_n - (h/2) J(x_n)^T (r_{n-1} + r_n)]
//          + 2 me_norm W (x_n - y) on observed entries,  c = fe_norm * rf
//   dA/dF = -2 c h sum r
//
// The walk. Each warp of the group owns a contiguous range of rows
// [n0, n1) of the member's path and walks it forward in time, its lanes
// over the columns d. The gradient of row n needs r_{n-1} and r_n only,
// so a warp that first computes its halo residual r_{n0-1} itself needs
// nothing from another warp: no (N-1)*D residual array, and no group
// barrier inside the walk. f is computed once per row, plus the halo
// row. The observed rows advance by a counter; at an observed row the
// misfit x_n - y is formed once and serves the ME sum and the gradient.
// Two walks share that plan:
//
// - D <= kRegWalkMaxD (the main path's D = 20): a lane's one column. It
//   loads x_n[d] kRowsAhead rows ahead and its observation's W and y
//   kObsAhead rows ahead, and takes the stencil's neighbours (x[d±1],
//   x[d±2], and v = r_{n-1} + r_n at e-1, e+1, e+2) from the other lanes
//   by shuffles: no shared memory, no __syncwarp, one memory latency
//   hidden behind several rows.
// - wider D: a lane's columns in chunks (a chunk's loads before its
//   stores); a ring of kRingRows
//   rows of D in memory (shared, where it fits; else the caller's
//   workspace): r_{n-1} and r_n, which the stencil reads at e-1, e+1,
//   e+2, f(x_n) at the lane's columns, and, where x lies in global
//   memory, the rows of x the stencil reads, copied in by cp.async a row
//   ahead; two __syncwarp a row.
//
// Sums are reduced in a fixed order (per-lane partials along the walk, a
// warp shuffle tree, then the warps in order, summed by every thread after
// the one group barrier that publishes the warps' partials), with no
// atomics: repeated calls give bit-identical results. Each gradient entry
// is computed by the expressions the first port used; the f32 sums FE,
// sum r and ME are summed in another order than the first port's (its
// strided partials over the flat index).
//
// With kComp (K4, ag_kernel.cu's compensated entry) the routine also
// returns the two-float (hi, lo) sums of the unweighted terms: the ME terms
// (W (x_obs - Y)) (x_obs - Y) and the FE terms r^2. The caller joins and
// scales them (rf, the norms) in a wider dtype. Every add and subtract of
// that arithmetic is an explicit round-to-nearest intrinsic and every
// product of a term one too, so that nvcc can neither contract a product
// into the following add (its default -fmad=true) nor reorder: TwoSum is
// exact only so. The plain value and the gradient are computed exactly as
// without kComp.
#pragma once

#include "l96_ag.cuh"

constexpr int kAgThreads = 256;
constexpr int kAgWarps = kAgThreads / 32;

// Rows of a warp's ring in the wide walk: two rows of residuals, the f
// row and three rows of x (the register walk keeps none).
constexpr int kRingRows = 6;
// The routine's sums: FE, sum r and ME; with kComp also the (hi, lo) pairs
// of the ME and FE terms.
constexpr int kAgSums = 3;
constexpr int kAgCompSums = 7;
// Widest D the register walk takes: one column a lane.
constexpr int kRegWalkMaxD = 32;
// Rows of x and of the observations the register walk loads ahead of use.
constexpr int kRowsAhead = 4;
constexpr int kObsAhead = 2;
// Columns a lane loads together in the wide walk: the residual pass (6
// values a column) and the gradient pass (13, so half as many in f64).
constexpr int kResChunk = 4;
template <typename T>
constexpr int kGradChunk = sizeof(T) == 4 ? 2 : 1;

// A measuring build (-DVA_COUNT_BARRIERS; chip_smoke.py builds
// solve_kernel.cu so to count the solve's barriers an iteration) counts
// every group barrier once, by the group's rank 0. The kernels as built
// for use count nothing.
#ifdef VA_COUNT_BARRIERS
__device__ unsigned long long va_barriers;
#define VA_COUNT_BARRIER(rank) \
    if ((rank) == 0) atomicAdd(&va_barriers, 1ull)
#else
#define VA_COUNT_BARRIER(rank)
#endif

// The threads that compute one member, as a policy of static members: the
// thread's rank in its group, the group's size and warps, and the barrier
// that synchronizes the group alone. The whole block is K1-K4's policy
// (the ranks are unsigned, as threadIdx.x is: as int, the warp index's
// shift turned arithmetic and nvcc gave K3 f32 one more register).
struct BlockGroup {
    static constexpr int kSize = kAgThreads;
    static constexpr int kWarps = kAgWarps;
    static __device__ __forceinline__ unsigned rank() { return threadIdx.x; }
    static __device__ __forceinline__ void sync() {
        VA_COUNT_BARRIER(threadIdx.x);
        __syncthreads();
    }
};

// G consecutive threads of the block (G a multiple of 32, so every warp
// lies in one group): group threadIdx.x / G, synchronized by the named
// barrier 1 + that index (barrier 0 is __syncthreads'), counting G
// threads; a group of one warp (G = 32) by __syncwarp, which orders the
// warp's shared and global memory accesses as the named barrier does.
// Groups never wait for each other.
template <int G>
struct WarpGroup {
    static_assert(G % 32 == 0 && G >= 32 && G <= 1024, "warp-aligned G");
    static constexpr int kSize = G;
    static constexpr int kWarps = G / 32;
    static __device__ __forceinline__ unsigned id() { return threadIdx.x / G; }
    static __device__ __forceinline__ unsigned rank() {
        return threadIdx.x % G;
    }
    static __device__ __forceinline__ void sync() {
        VA_COUNT_BARRIER(rank());
        if constexpr (G == 32)
            __syncwarp();
        else
            asm volatile("bar.sync %0, %1;" : : "r"(id() + 1), "n"(G)
                         : "memory");
    }
};

// The problem's constants, shared by every member.
template <typename T>
struct L96Problem {
    int n_dof, N, D, pslot;     // pslot: index of F in XP, or -1 (fixed)
    T F_fixed;
    const T* Y;                 // (N_data, L)
    const T* W;                 // (N_data, L) RM weights
    const int* lidx;            // (L,) observed columns
    const int* lpos;            // (D,) position in lidx, or -1
    int N_data, L, obs_stride;
    T h, me_norm, fe_norm;
};

// v_e = r_{n-1,e} + r_{n,e}, a missing row counting as zero.
template <typename T>
struct RowPairSum {
    const T* prev;
    const T* cur;
    __device__ __forceinline__ T operator()(int e) const {
        return (prev ? prev[e] : T(0)) + (cur ? cur[e] : T(0));
    }
};

// K values loaded together (a pass's chunk).
template <typename T, int K>
struct Vals {
    T v[K];
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// Round-to-nearest add, subtract and multiply that are never fused or
// reordered.
__device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
    return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
    return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
}

// (hi, lo) += (b, lo_b) by Knuth's TwoSum: s + e == hi + b exactly, and
// lo becomes (lo + lo_b) + e, the step of the reference's tree
// (varanneal_tpu/ops/action.py::comp_sum).
template <typename T>
__device__ __forceinline__ void two_join(T& hi, T& lo, T b, T lo_b) {
    const T s = add_rn(hi, b);
    const T bb = sub_rn(s, hi);
    const T e = add_rn(sub_rn(hi, sub_rn(s, bb)), sub_rn(b, bb));
    hi = s;
    lo = add_rn(add_rn(lo, lo_b), e);
}

// The warp's (hi, lo) pairs joined down a shuffle tree into lane 0.
template <typename T>
__device__ __forceinline__ void warp_two_sum(T& hi, T& lo) {
    for (int o = 16; o > 0; o >>= 1) {
        const T h2 = __shfl_down_sync(0xffffffffu, hi, o);
        const T l2 = __shfl_down_sync(0xffffffffu, lo, o);
        two_join(hi, lo, h2, l2);
    }
}

// The rings of a group's warps, in elements of T.
__host__ __device__ inline size_t l96_ag_ring_elems(int D,
                                                    int warps = kAgWarps) {
    return (size_t)kRingRows * D * warps;
}

// The warps' partials of the routine's sums, in elements of T.
__host__ __device__ inline size_t l96_ag_red_elems(bool comp = false,
                                                   int warps = kAgWarps) {
    return (size_t)(comp ? kAgCompSums : kAgSums) * warps;
}

// Shared memory of K1/K4 with the ring on chip: the partials, then the
// rings. It does not grow with N.
__host__ __device__ inline size_t l96_ag_smem_elems(int D, bool comp = false,
                                                    int warps = kAgWarps) {
    return l96_ag_red_elems(comp, warps) + l96_ag_ring_elems(D, warps);
}

// What the routine returns to every thread of the group.
template <typename T>
struct AgSums {
    T A;        // the action
    T me;       // me_norm * sum W (x_obs - Y)^2
};

// A lane's partial sums along its walk.
template <typename T, bool kComp>
struct AgPartials {
    T fe = T(0), sr = T(0), me = T(0);
    T me_hi = T(0), me_lo = T(0), fe_hi = T(0), fe_lo = T(0);

    __device__ __forceinline__ void residual(T rr) {
        fe += rr * rr;
        sr += rr;
        if constexpr (kComp) two_join(fe_hi, fe_lo, mul_rn(rr, rr), T(0));
    }
    __device__ __forceinline__ void misfit(T w, T diff) {
        me += w * diff * diff;
        if constexpr (kComp) {
            two_join(me_hi, me_lo, mul_rn(mul_rn(w, diff), diff), T(0));
        }
    }
};

// What a walk needs besides its rows.
template <typename T>
struct WalkArgs {
    T F, hh, c2;
    int n0, n1;     // the warp's rows
    int rows;       // the most rows any warp of the group has
    unsigned lane;
};

// The observed rows from n0 on: the next one and its data row. One
// division a walk; the rows then advance by the counter.
struct ObsCursor {
    int next, k;
    __device__ __forceinline__ ObsCursor(int n0, int stride) {
        k = (n0 + stride - 1) / stride;
        next = k * stride;
    }
    __device__ __forceinline__ bool at(int n, int n_data) const {
        return n == next && k < n_data;
    }
    __device__ __forceinline__ void pass(int n, int stride) {
        if (n == next) {
            ++k;
            next += stride;
        }
    }
};

// The warp's rows [n0, n1) of N, split as evenly as the warps allow, and
// the most rows a warp has.
template <int kWarps>
__device__ __forceinline__ void warp_rows(int N, unsigned warp, int& n0,
                                          int& n1, int& rows) {
    const int q = N / kWarps;
    const int rem = N - q * kWarps;
    const int w = (int)warp;
    n0 = w * q + (w < rem ? w : rem);
    n1 = n0 + q + (w < rem ? 1 : 0);
    rows = q + (rem > 0 ? 1 : 0);
}

// l96_f (l96_ag.cuh) from x[d-2..d+2].
template <typename T>
__device__ __forceinline__ T f5(const T (&v)[5], T F) {
    return (v[3] - v[0]) * v[1] - v[2] + F;
}

// x_{row}[d] for lane d < D, else 0 (lanes past D read nothing).
template <typename T>
__device__ __forceinline__ T center(const T* x, int row, int d, int D,
                                    bool on) {
    return on ? x[(size_t)row * D + d] : T(0);
}

// x[d-2..d+2] of one row from its lanes' centers c (lane e holds x[e]).
template <typename T>
__device__ __forceinline__ void gather5(T c, const int (&src)[4],
                                        T (&v)[5]) {
    v[0] = __shfl_sync(0xffffffffu, c, src[0]);
    v[1] = __shfl_sync(0xffffffffu, c, src[1]);
    v[2] = c;
    v[3] = __shfl_sync(0xffffffffu, c, src[2]);
    v[4] = __shfl_sync(0xffffffffu, c, src[3]);
}

// The register walk, D <= kRegWalkMaxD: lane d's column. A lane loads one
// value a row, x_n[d], kRowsAhead rows ahead of its use, and its
// observation's W and y kObsAhead rows ahead; the stencil's neighbours
// x[d±1], x[d±2] and v[e-1], v[e+1], v[e+2] come from the other lanes by
// shuffles, so the walk touches no shared memory and needs no
// __syncwarp. Lanes past D shuffle values they never use. The rows go in
// groups of kRowsAhead, so that each load lands in a register of its own
// until its row comes (a queue shifted by one a row would wait on each
// load a row after issuing it). Every warp runs the same number of steps,
// a.rows, and a step past the warp's rows stores and sums nothing, so the
// loop around the shuffles has one trip count in the whole group and a
// warp without rows needs no case of its own.
template <typename T, bool kComp>
__device__ __forceinline__ void walk_regs(const L96Problem<T>& p,
                                          const T* x, T* g,
                                          const WalkArgs<T>& a,
                                          AgPartials<T, kComp>& s) {
    static_assert(kRowsAhead == 4 && kObsAhead == 2, "the unrolled group");
    const int N = p.N, D = p.D;
    const int d = (int)a.lane;
    const bool on = d < D;
    const int l = on ? p.lpos[d] : -1;
    const int src[4] = {l96_wrap(d - 2, D), l96_wrap(d - 1, D),
                        l96_wrap(d + 1, D), l96_wrap(d + 2, D)};
    T xa[5];                        // x_n[d-2..d+2]
    gather5(center(x, a.n0, d, D, on && a.n0 < N), src, xa);
    T fa = f5(xa, a.F);             // f(x_n)_d
    T xm[5];                        // the halo row, x_{n0-1}
    gather5(center(x, a.n0 - 1, d, D, on && a.n0 > 0), src, xm);
    T r_prev = a.n0 > 0                 // r_{n-1, d}: the halo residual
        ? xa[2] - xm[2] - a.hh * (f5(xm, a.F) + fa) : T(0);
    T q[kRowsAhead];                // x_{n0+1+j}[d], then kRowsAhead on
#pragma unroll
    for (int j = 0; j < kRowsAhead; ++j)
        q[j] = center(x, a.n0 + 1 + j, d, D, on && a.n0 + 1 + j < N);
    bool ob[kObsAhead];             // the rows' observations, in order
    T ow[kObsAhead], oy[kObsAhead];
    ObsCursor oc(a.n0, p.obs_stride);
    int orow = a.n0;
    auto obs_load = [&](int j) {
        ob[j] = l >= 0 && orow < a.n1 && oc.at(orow, p.N_data);
        ow[j] = ob[j] ? p.W[oc.k * p.L + l] : T(0);
        oy[j] = ob[j] ? p.Y[oc.k * p.L + l] : T(0);
        oc.pass(orow, p.obs_stride);
        ++orow;
    };
#pragma unroll
    for (int j = 0; j < kObsAhead; ++j) obs_load(j);

    // row n: x_{n+1} from q[jq] and the observation from slot jo, each
    // slot then loaded with the row kRowsAhead (kObsAhead) further on
    auto row = [&](int n, int jq, int jo) {
        const bool mine = on && n < a.n1;
        const bool has_next = n + 1 < N;
        T xb[5];                    // x_{n+1}[d-2..d+2]
        gather5(q[jq], src, xb);
        q[jq] = center(x, n + 1 + kRowsAhead, d, D,
                       on && n + 1 + kRowsAhead < N);
        const bool is_obs = ob[jo];
        const T wv = ow[jo], yv = oy[jo];
        obs_load(jo);
        const T fb = f5(xb, a.F);
        const T rr = has_next ? xb[2] - xa[2] - a.hh * (fa + fb) : T(0);
        if (mine && has_next) s.residual(rr);
        // v_e = r_{n-1,e} + r_{n,e}, a missing row counting as zero
        const T rp = n > 0 ? r_prev : T(0);
        const T v = rp + rr;
        const T v_m1 = __shfl_sync(0xffffffffu, v, src[1]);
        const T v_p1 = __shfl_sync(0xffffffffu, v, src[2]);
        const T v_p2 = __shfl_sync(0xffffffffu, v, src[3]);
        const T jt = xa[0] * v_m1 + (xa[4] - xa[1]) * v_p1 - xa[3] * v_p2
                     - v;
        T gx = a.c2 * (rp - rr - a.hh * jt);
        const T diff = xa[2] - yv;
        gx = is_obs ? gx + T(2) * p.me_norm * wv * diff : gx;
        if (mine && is_obs) s.misfit(wv, diff);
        if (mine) g[(size_t)n * D + d] = gx;
#pragma unroll
        for (int i = 0; i < 5; ++i) xa[i] = xb[i];
        fa = fb;
        r_prev = rr;
    };
    for (int j = 0; j < a.rows; j += kRowsAhead) {
        row(a.n0 + j, 0, 0);
        row(a.n0 + j + 1, 1, 1);
        row(a.n0 + j + 2, 2, 0);
        row(a.n0 + j + 3, 3, 1);
    }
}

// A pass over the lane's columns d = lane + 32 j, kC at a time: every load
// of a chunk first, then apply(d, loaded) in the order of d (a store
// through a pointer that may alias the loads keeps the compiler from
// moving the next loads above it).
template <int kC, typename Load, typename Apply>
__device__ __forceinline__ void lane_pass(int D, unsigned lane, Load load,
                                          Apply apply) {
    using L = decltype(load(0));
    for (int d0 = (int)lane; d0 < D; d0 += 32 * kC) {
        L got[kC];
#pragma unroll
        for (int u = 0; u < kC; ++u) {
            const int d = d0 + 32 * u;
            if (d < D) got[u] = load(d);
        }
#pragma unroll
        for (int u = 0; u < kC; ++u) {
            const int d = d0 + 32 * u;
            if (d < D) apply(d, got[u]);
        }
    }
}

// One row of D values from global memory into shared memory by cp.async,
// a lane's columns each; the copies complete in the background.
template <typename T>
__device__ __forceinline__ void copy_row_async(T* dst, const T* src, int D,
                                               unsigned lane) {
    const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
    for (int d = (int)lane; d < D; d += 32)
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
                     : : "r"(base + (unsigned)(d * sizeof(T))), "l"(src + d),
                       "n"(sizeof(T)) : "memory");
}
// The copies issued so far form a group; wait until at most kPending
// groups are still in flight.
__device__ __forceinline__ void async_commit() {
    asm volatile("cp.async.commit_group;" : : : "memory");
}
template <int kPending>
__device__ __forceinline__ void async_wait() {
    asm volatile("cp.async.wait_group %0;" : : "n"(kPending) : "memory");
}

// The wide walk, D > kRegWalkMaxD: the lane's columns in chunks; in the
// ring, two rows of residuals, the f row and, where x lies in global
// memory and the ring in shared memory, three rows of x: rows n and n+1,
// which the stencil reads, and row n+2, copied by cp.async while the warp
// works on row n. The stencil's many reads of a row then hit shared
// memory. Where x is in shared memory already (K2/K3 with the vectors on
// chip), or the ring is in global memory, the walk reads x where it lies.
template <typename T, bool kComp>
__device__ __forceinline__ void walk_wide(const L96Problem<T>& p,
                                          const T* x, T* g, T* ring,
                                          const WalkArgs<T>& a,
                                          AgPartials<T, kComp>& s) {
    const int N = p.N, D = p.D;
    T* rp = ring;                   // r_{n-1}
    T* rc = ring + D;               // r_n
    T* fr = ring + 2 * D;           // f(x_n) at the lane's columns
    const bool staged = __isGlobal(x) && __isShared(ring);
    // the ring's rows of x: n, n+1 and n+2 (the one being copied)
    T* xs0 = ring + 3 * D;
    T* xs1 = ring + 4 * D;
    T* xs2 = ring + 5 * D;
    if (staged) {                   // rows n0 and n0+1 now, n0+2 below
        copy_row_async(xs0, x + (size_t)a.n0 * D, D, a.lane);
        if (a.n0 + 1 < N)
            copy_row_async(xs1, x + (size_t)(a.n0 + 1) * D, D, a.lane);
        async_commit();
        async_wait<0>();
        __syncwarp();
    }
    {
        const T* x0 = staged ? xs0 : x + (size_t)a.n0 * D;
        const T* xm = x + (size_t)(a.n0 - 1) * D;   // the halo row
        for (int d = (int)a.lane; d < D; d += 32) {
            const T f0 = l96_f(x0, d, D, a.F);
            fr[d] = f0;
            if (a.n0 > 0)           // the halo residual r_{n0-1}
                rp[d] = x0[d] - xm[d] - a.hh * (l96_f(xm, d, D, a.F) + f0);
        }
    }
    ObsCursor obs(a.n0, p.obs_stride);
    for (int n = a.n0; n < a.n1; ++n) {
        const bool has_next = n + 1 < N;
        if (staged) {               // row n+2 in flight during row n
            if (n + 2 < N)
                copy_row_async(xs2, x + (size_t)(n + 2) * D, D, a.lane);
            async_commit();
        }
        const T* x0 = staged ? xs0 : x + (size_t)n * D;
        const T* x1 = staged ? xs1 : x0 + D;
        if (has_next) {
            lane_pass<kResChunk>(
                D, a.lane,
                [&](int d) {
                    return Vals<T, 6>{{x1[l96_wrap(d - 2, D)],
                                       x1[l96_wrap(d - 1, D)], x1[d],
                                       x1[l96_wrap(d + 1, D)], x0[d],
                                       fr[d]}};
                },
                [&](int d, const Vals<T, 6>& v) {
                    const T f1 = (v.v[3] - v.v[0]) * v.v[1] - v.v[2] + a.F;
                    const T rr = v.v[2] - v.v[4] - a.hh * (v.v[5] + f1);
                    rc[d] = rr;
                    fr[d] = f1;
                    s.residual(rr);
                });
        }
        __syncwarp();
        const T* rpn = n > 0 ? rp : nullptr;
        const T* rcn = has_next ? rc : nullptr;
        const RowPairSum<T> vs{rpn, rcn};
        const bool is_obs = obs.at(n, p.N_data);
        const int krow = obs.k * p.L;
        lane_pass<kGradChunk<T>>(
            D, a.lane,
            [&](int e) {
                // x_n[e-2..e+2], v at e-1, e+1, e+2, e, r_{n-1} - r_n at
                // e, and the observation's W and y
                const int l = is_obs ? p.lpos[e] : -1;
                return Vals<T, 13>{{
                    x0[l96_wrap(e - 2, D)], x0[l96_wrap(e - 1, D)], x0[e],
                    x0[l96_wrap(e + 1, D)], x0[l96_wrap(e + 2, D)],
                    vs(l96_wrap(e - 1, D)), vs(l96_wrap(e + 1, D)),
                    vs(l96_wrap(e + 2, D)), vs(e),
                    (rpn ? rpn[e] : T(0)) - (rcn ? rcn[e] : T(0)),
                    l >= 0 ? p.W[krow + l] : T(0),
                    l >= 0 ? p.Y[krow + l] : T(0), T(l >= 0)}};
            },
            [&](int e, const Vals<T, 13>& v) {
                const T jt = v.v[0] * v.v[5] + (v.v[4] - v.v[1]) * v.v[6]
                             - v.v[3] * v.v[7] - v.v[8];
                T gx = a.c2 * (v.v[9] - a.hh * jt);
                if (v.v[12] != T(0)) {
                    const T diff = v.v[2] - v.v[11];
                    gx += T(2) * p.me_norm * v.v[10] * diff;
                    s.misfit(v.v[10], diff);
                }
                g[(size_t)n * D + e] = gx;
            });
        obs.pass(n, p.obs_stride);
        if (staged) async_wait<0>();    // row n+2 in its slot
        __syncwarp();
        T* t = rp;
        rp = rc;
        rc = t;
        t = xs0;                    // row n's slot takes row n+3 next
        xs0 = xs1;
        xs1 = xs2;
        xs2 = t;
    }
}

// Action and gradient of the member at x (n_dof values) at scalar rf.
// Every thread of the group Grp calls it. Writes the gradient to g (n_dof
// values) and returns the action and the normalized measurement error to
// every thread. With kComp, rank 0 also writes comp[0..5] = [me_hi, me_lo,
// fe1_hi, fe1_lo, fe2_hi, fe2_lo], the two-float sums of the ME terms and
// of the unweighted FE terms (fe2, the Hermite plane of the reference's
// Simpson-Hermite layout, is zero for the trapezoid rule).
//
// ring: l96_ag_ring_elems(D, Grp::kWarps) elements, the group's own, in
// shared or global memory; red: l96_ag_red_elems(kComp, Grp::kWarps)
// elements of shared memory for the warps' partials. The routine's one
// group barrier publishes the partials: every thread reads them before it
// reaches the group's next barrier, so a caller may write red again only
// after that one. The caller synchronizes the group before the call when
// other threads wrote x. g[pslot] is written after the barrier, by the
// thread of rank pslot % Grp::kSize, the owner of that entry in the
// callers' strided passes; every other entry of g before it.
//
// Not inlined: the solver calls it from three or four places, and each
// inlined copy of the walk would add its registers to the solver's own
// (in the global layout, held to 128, they spilled) and its code to the
// instruction cache; one body for each (T, kComp, Grp) keeps the walk's
// registers its own and its arithmetic the same in every kernel.
//
// The problem is copied on entry: read through the caller's reference,
// each of its fields would be loaded again after every store of the walk
// (the compiler cannot tell that g and the ring do not alias it).
template <typename T, bool kComp = false, typename Grp = BlockGroup>
__device__ __noinline__ AgSums<T> l96_ag_block(const L96Problem<T>& problem,
                                               const T* x, T rf,
                                               T* __restrict__ g, T* ring,
                                               T* red, T* comp = nullptr) {
    const L96Problem<T> p = problem;
    constexpr int W = Grp::kWarps;
    const unsigned lane = Grp::rank() & 31u;
    const unsigned warp = Grp::rank() >> 5;
    WalkArgs<T> a;
    a.F = p.pslot >= 0 ? x[p.pslot] : p.F_fixed;
    a.hh = p.h / T(2);
    a.c2 = T(2) * p.fe_norm * rf;
    a.lane = lane;
    warp_rows<W>(p.N, warp, a.n0, a.n1, a.rows);
    T* wring = ring + (size_t)warp * kRingRows * p.D;
    AgPartials<T, kComp> s;
    if (p.D <= kRegWalkMaxD)
        walk_regs(p, x, g, a, s);   // a warp without rows stores nothing
    else if (a.n0 < a.n1)
        walk_wide(p, x, g, wring, a, s);

    // fixed-order reduction: the warp's tree, then the warps in order
    s.fe = warp_sum(s.fe);
    s.sr = warp_sum(s.sr);
    s.me = warp_sum(s.me);
    if (lane == 0) {
        red[warp] = s.fe;
        red[W + warp] = s.sr;
        red[2 * W + warp] = s.me;
    }
    if constexpr (kComp) {
        warp_two_sum(s.me_hi, s.me_lo);
        warp_two_sum(s.fe_hi, s.fe_lo);
        if (lane == 0) {
            T* cr = red + kAgSums * W;
            cr[warp] = s.me_hi;
            cr[W + warp] = s.me_lo;
            cr[2 * W + warp] = s.fe_hi;
            cr[3 * W + warp] = s.fe_lo;
        }
    }
    Grp::sync();   // the warps' partials (and every entry of g) complete
    T fe_t = red[0], sr_t = red[W], me_t = red[2 * W];
    for (int w = 1; w < W; ++w) {
        fe_t += red[w];
        sr_t += red[W + w];
        me_t += red[2 * W + w];
    }
    if (p.pslot >= 0 && Grp::rank() == (unsigned)p.pslot % Grp::kSize)
        g[p.pslot] = -a.c2 * p.h * sr_t;
    if constexpr (kComp) {
        if (Grp::rank() == 0) {
            // the warps' pairs joined in order
            const T* cr = red + kAgSums * W;
            T mh = cr[0], ml = cr[W];
            T fh = cr[2 * W], fl = cr[3 * W];
            for (int w = 1; w < W; ++w) {
                two_join(mh, ml, cr[w], cr[W + w]);
                two_join(fh, fl, cr[2 * W + w], cr[3 * W + w]);
            }
            comp[0] = mh;
            comp[1] = ml;
            comp[2] = fh;
            comp[3] = fl;
            comp[4] = T(0);
            comp[5] = T(0);
        }
    }
    // rounded apart, so that no kernel's contraction can fuse a product
    // into the sum: K1's A and the solvers' f are the same bits
    const T me = mul_rn(p.me_norm, me_t);
    return AgSums<T>{add_rn(me, mul_rn(p.fe_norm, mul_rn(rf, fe_t))), me};
}
