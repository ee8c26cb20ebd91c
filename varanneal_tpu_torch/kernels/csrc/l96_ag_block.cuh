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
// K5 (agt_kernel.cu) walks the same way under three one-step rules and
// two kinds of rf. With w_n = rf (a scalar) or row n of an (N-1, D) rf,
// q_n = w_n r_n, c = fe_norm, and the terms of a row outside
// 0 <= n <= N-2 absent:
//
//   rule        r_n                                  Jᵀv's operand v_n
//   trapezoid   x_{n+1} - x_n - (h/2)(f(x_n) + f(x_{n+1}))   q_{n-1} + q_n
//   euler       x_{n+1} - x_n - h f(x_n)                      q_n
//   forwardmap  x_{n+1} - f(x_n)                              q_n
//
//   gX_n  = 2c [q_{n-1} - q_n - k J(x_n)^T v_n]   (k = h/2, h), or
//           2c [q_{n-1} - J(x_n)^T v_n]            under the forward map
//   A     = me_norm sum W (x_obs - Y)^2 + c sum w r^2
//   dA/dF = -2c h sum q, or -2c sum q under the forward map
//
// (2c carries rf's factor only for a scalar rf). f is computed once a row
// under every rule: the residual of row n needs f(x_n) alone under Euler
// and the forward map, and f(x_{n+1}) is the next row's f(x_n). With an
// (N-1, D) rf each lane loads w_n with its row (in the register walk
// kRowsAhead rows ahead, like x). K1-K4 and K8 take the trapezoid rule
// with a scalar rf through l96_ag_block, whose code the rules leave as it
// was; K1-K4's other rules go through l96_rule_block.
//
// Hermite-Simpson (kWalkSimpsonHermite) lives on the doubled grid, N =
// 2M + 1 rows, interval k over rows 2k..2k+2 (ops/disc.py):
//
//   s_k = x_{2k+2} - x_{2k} - (h/6)(f_{2k} + 4 f_{2k+1} + f_{2k+2})
//   m_k = x_{2k+1} - (x_{2k} + x_{2k+2})/2 - (h/8)(f_{2k} - f_{2k+2})
//
// a_k = w_s s_k, b_k = w_m m_k with w_s = w_m = 1 for a scalar rf (rf
// in 2c) or rows 2k and 2k+1 of the (N-1, D) rf; a and b are zero
// outside 0 <= k <= M-1. With v_k = (h/6)(a_{k-1} + a_k) + (h/8)(b_k -
// b_{k-1}):
//
//   gX_{2k}   = 2c [a_{k-1} - a_k - (b_{k-1} + b_k)/2 - J(x_{2k})^T v_k]
//   gX_{2k+1} = 2c [b_k - (2h/3) J(x_{2k+1})^T a_k]
//   A         = me_norm sum W (x_obs - Y)^2 + c sum (a s + b m)
//   dA/dF     = -2c h sum a    (the Hermite terms cancel: df/dF = 1)
//
// The walk goes by steps, not rows: step k takes rows 2k and 2k+1 (row
// 2M alone at step M), and the warps split the M + 1 steps. A step forms
// interval k's residuals from f at rows 2k+1 and 2k+2 (f_{2k} is the last
// step's f_{2k+2}), then the two rows' gradients; interval k-1's a and b
// carry over from the last step, and a warp computes its first step's
// halo interval itself. f is computed once a row.
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
// of the ME and FE terms; under Hermite-Simpson also the Hermite plane's
// pair (kAgRuleCompSums, which the rules' entries allocate).
constexpr int kAgSums = 3;
constexpr int kAgCompSums = 7;
constexpr int kAgRuleCompSums = 9;
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

// The rules of the walk (ops/disc.py's names; K5's and the rules'
// entries' codes).
enum WalkDisc {
    kWalkTrapezoid = 0,
    kWalkEuler = 1,
    kWalkForwardMap = 2,
    kWalkSimpsonHermite = 3
};

// r_n of one column from x_n, x_{n+1} and f at both (hh = h/2).
template <int kDisc, typename T>
__device__ __forceinline__ T step_residual(T x0, T x1, T f0, T f1, T hh,
                                           T h) {
    if constexpr (kDisc == kWalkTrapezoid) {
        return x1 - x0 - hh * (f0 + f1);
    } else if constexpr (kDisc == kWalkEuler) {
        return x1 - x0 - h * f0;
    } else {
        return x1 - f0;
    }
}

// gX_n's model-error part from dq = q_{n-1} - q_n (q_{n-1} under the
// forward map) and jt = (J(x_n)^T v_n).
template <int kDisc, typename T>
__device__ __forceinline__ T step_grad(T c2, T dq, T jt, T hh, T h) {
    if constexpr (kDisc == kWalkTrapezoid) {
        return c2 * (dq - hh * jt);
    } else if constexpr (kDisc == kWalkEuler) {
        return c2 * (dq - h * jt);
    } else {
        return c2 * (dq - jt);
    }
}

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

// A lane's partial sums along its walk, FE, sum r and ME in Acc (T for
// K1-K4 and K8; K5 sums in double); with kComp the (hi, lo) pairs of the
// ME terms, the FE terms and (Hermite-Simpson) the Hermite plane's terms.
template <typename T, bool kComp, typename Acc = T>
struct AgPartials {
    Acc fe = Acc(0), sr = Acc(0), me = Acc(0);
    T me_hi = T(0), me_lo = T(0), fe_hi = T(0), fe_lo = T(0);
    T f2_hi = T(0), f2_lo = T(0);

    __device__ __forceinline__ void residual(T rr) {
        fe += Acc(rr) * Acc(rr);
        sr += Acc(rr);
        if constexpr (kComp) two_join(fe_hi, fe_lo, mul_rn(rr, rr), T(0));
    }
    // a residual weighted by its row of an (N-1, D) rf: q = w r (K4's
    // term the weighted q r, as the reference's diag mode sums it)
    __device__ __forceinline__ void weighted(T q, T rr) {
        fe += Acc(q) * Acc(rr);
        sr += Acc(q);
        if constexpr (kComp) two_join(fe_hi, fe_lo, mul_rn(q, rr), T(0));
    }
    // a Hermite-Simpson interval's column: a = w_s s, b = w_m m
    __device__ __forceinline__ void interval(T a, T sres, T b, T mres) {
        fe += Acc(a) * Acc(sres);
        fe += Acc(b) * Acc(mres);
        sr += Acc(a);
        if constexpr (kComp) {
            two_join(fe_hi, fe_lo, mul_rn(a, sres), T(0));
            two_join(f2_hi, f2_lo, mul_rn(b, mres), T(0));
        }
    }
    __device__ __forceinline__ void misfit(T w, T diff) {
        me += Acc(w) * Acc(diff) * Acc(diff);
        if constexpr (kComp) {
            two_join(me_hi, me_lo, mul_rn(mul_rn(w, diff), diff), T(0));
        }
    }
};

// What a walk needs besides its rows.
template <typename T>
struct WalkArgs {
    T F, hh, c2;
    const T* rfd;   // the (N-1, D) rf (K5's kDiag), else unread
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
template <typename T, bool kComp, int kDisc = kWalkTrapezoid,
          bool kDiag = false, typename Acc = T>
__device__ __forceinline__ void walk_regs(const L96Problem<T>& p,
                                          const T* x, T* g,
                                          const WalkArgs<T>& a,
                                          AgPartials<T, kComp, Acc>& s) {
    static_assert(kRowsAhead == 4 && kObsAhead == 2, "the unrolled group");
    const int N = p.N, D = p.D;
    const int d = (int)a.lane;
    const bool on = d < D;
    const int l = on ? p.lpos[d] : -1;
    const int src[4] = {l96_wrap(d - 2, D), l96_wrap(d - 1, D),
                        l96_wrap(d + 1, D), l96_wrap(d + 2, D)};
    // w_n[d] of the (N-1, D) rf, 0 past its rows
    auto weight = [&](int n) {
        return on && n >= 0 && n < N - 1 ? a.rfd[(size_t)n * D + d] : T(0);
    };
    T xa[5];                        // x_n[d-2..d+2]
    gather5(center(x, a.n0, d, D, on && a.n0 < N), src, xa);
    T fa = f5(xa, a.F);             // f(x_n)_d
    T xm[5];                        // the halo row, x_{n0-1}
    gather5(center(x, a.n0 - 1, d, D, on && a.n0 > 0), src, xm);
    T r_prev = a.n0 > 0                 // q_{n-1, d}: the halo residual
        ? step_residual<kDisc>(xm[2], xa[2], f5(xm, a.F), fa, a.hh, p.h)
        : T(0);
    if constexpr (kDiag) r_prev *= weight(a.n0 - 1);
    T q[kRowsAhead];                // x_{n0+1+j}[d], then kRowsAhead on
#pragma unroll
    for (int j = 0; j < kRowsAhead; ++j)
        q[j] = center(x, a.n0 + 1 + j, d, D, on && a.n0 + 1 + j < N);
    T qw[kDiag ? kRowsAhead : 1];   // w_{n0+j}[d], then kRowsAhead on
    if constexpr (kDiag) {
#pragma unroll
        for (int j = 0; j < kRowsAhead; ++j) qw[j] = weight(a.n0 + j);
    }
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

    // row n: x_{n+1} (and w_n) from slot jq and the observation from slot
    // jo, each slot then loaded with the row kRowsAhead (kObsAhead)
    // further on
    auto row = [&](int n, int jq, int jo) {
        const bool mine = on && n < a.n1;
        const bool has_next = n + 1 < N;
        T xb[5];                    // x_{n+1}[d-2..d+2]
        gather5(q[jq], src, xb);
        q[jq] = center(x, n + 1 + kRowsAhead, d, D,
                       on && n + 1 + kRowsAhead < N);
        T wn = T(0);
        if constexpr (kDiag) {
            wn = qw[jq];
            qw[jq] = weight(n + kRowsAhead);
        }
        const bool is_obs = ob[jo];
        const T wv = ow[jo], yv = oy[jo];
        obs_load(jo);
        const T fb = f5(xb, a.F);
        const T rr = has_next
            ? step_residual<kDisc>(xa[2], xb[2], fa, fb, a.hh, p.h) : T(0);
        const T qn = kDiag ? wn * rr : rr;      // q_n
        if (mine && has_next) {
            if constexpr (kDiag) {
                s.weighted(qn, rr);
            } else {
                s.residual(rr);
            }
        }
        // v_e of the rule, a missing row counting as zero
        const T rp = n > 0 ? r_prev : T(0);
        const T v = kDisc == kWalkTrapezoid ? rp + qn : qn;
        const T v_m1 = __shfl_sync(0xffffffffu, v, src[1]);
        const T v_p1 = __shfl_sync(0xffffffffu, v, src[2]);
        const T v_p2 = __shfl_sync(0xffffffffu, v, src[3]);
        const T jt = xa[0] * v_m1 + (xa[4] - xa[1]) * v_p1 - xa[3] * v_p2
                     - v;
        T gx = step_grad<kDisc>(
            a.c2, kDisc == kWalkForwardMap ? rp : rp - qn, jt, a.hh, p.h);
        const T diff = xa[2] - yv;
        gx = is_obs ? gx + T(2) * p.me_norm * wv * diff : gx;
        if (mine && is_obs) s.misfit(wv, diff);
        if (mine) g[(size_t)n * D + d] = gx;
#pragma unroll
        for (int i = 0; i < 5; ++i) xa[i] = xb[i];
        fa = fb;
        r_prev = qn;
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
template <typename T, bool kComp, int kDisc = kWalkTrapezoid,
          bool kDiag = false, typename Acc = T>
__device__ __forceinline__ void walk_wide(const L96Problem<T>& p,
                                          const T* x, T* g, T* ring,
                                          const WalkArgs<T>& a,
                                          AgPartials<T, kComp, Acc>& s) {
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
            if (a.n0 > 0) {         // the halo residual q_{n0-1}
                const T r = step_residual<kDisc>(
                    xm[d], x0[d], l96_f(xm, d, D, a.F), f0, a.hh, p.h);
                rp[d] = kDiag ? a.rfd[(size_t)(a.n0 - 1) * D + d] * r : r;
            }
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
            // x_{n+1}[d-2..d+1], x_n[d], f(x_n)_d and, with an (N-1, D)
            // rf, w_n[d]
            constexpr int kVals = kDiag ? 7 : 6;
            const T* wrow = kDiag ? a.rfd + (size_t)n * D : nullptr;
            lane_pass<kResChunk>(
                D, a.lane,
                [&](int d) {
                    Vals<T, kVals> v{{x1[l96_wrap(d - 2, D)],
                                      x1[l96_wrap(d - 1, D)], x1[d],
                                      x1[l96_wrap(d + 1, D)], x0[d],
                                      fr[d]}};
                    if constexpr (kDiag) v.v[6] = wrow[d];
                    return v;
                },
                [&](int d, const Vals<T, kVals>& v) {
                    const T f1 = (v.v[3] - v.v[0]) * v.v[1] - v.v[2] + a.F;
                    const T rr = step_residual<kDisc>(v.v[4], v.v[2], v.v[5],
                                                      f1, a.hh, p.h);
                    if constexpr (kDiag) {
                        const T qd = v.v[6] * rr;
                        rc[d] = qd;
                        fr[d] = f1;
                        s.weighted(qd, rr);
                    } else {
                        rc[d] = rr;
                        fr[d] = f1;
                        s.residual(rr);
                    }
                });
        }
        __syncwarp();
        const T* rpn = n > 0 ? rp : nullptr;
        const T* rcn = has_next ? rc : nullptr;
        // Jᵀv's operand: q_{n-1} + q_n (trapezoid), q_n (Euler, forward map)
        const RowPairSum<T> vs{kDisc == kWalkTrapezoid ? rpn : nullptr, rcn};
        const bool is_obs = obs.at(n, p.N_data);
        const int krow = obs.k * p.L;
        lane_pass<kGradChunk<T>>(
            D, a.lane,
            [&](int e) {
                // x_n[e-2..e+2], v at e-1, e+1, e+2, e, q_{n-1} - q_n at
                // e (q_{n-1} under the forward map), and the observation's
                // W and y
                const int l = is_obs ? p.lpos[e] : -1;
                return Vals<T, 13>{{
                    x0[l96_wrap(e - 2, D)], x0[l96_wrap(e - 1, D)], x0[e],
                    x0[l96_wrap(e + 1, D)], x0[l96_wrap(e + 2, D)],
                    vs(l96_wrap(e - 1, D)), vs(l96_wrap(e + 1, D)),
                    vs(l96_wrap(e + 2, D)), vs(e),
                    kDisc == kWalkForwardMap
                        ? (rpn ? rpn[e] : T(0))
                        : (rpn ? rpn[e] : T(0)) - (rcn ? rcn[e] : T(0)),
                    l >= 0 ? p.W[krow + l] : T(0),
                    l >= 0 ? p.Y[krow + l] : T(0), T(l >= 0)}};
            },
            [&](int e, const Vals<T, 13>& v) {
                const T jt = v.v[0] * v.v[5] + (v.v[4] - v.v[1]) * v.v[6]
                             - v.v[3] * v.v[7] - v.v[8];
                T gx = step_grad<kDisc>(a.c2, v.v[9], jt, a.hh, p.h);
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

// Hermite-Simpson's constants of a walk: h/6, h/8 and 2h/3 in T.
template <typename T>
struct ShCoeffs {
    T h6, h8, h23;
    __device__ __forceinline__ explicit ShCoeffs(T h)
        : h6(h / T(6)), h8(h / T(8)), h23(T(2) * h / T(3)) {}
};

// Interval k's residuals at one column from x and f at its three rows.
template <typename T>
__device__ __forceinline__ void sh_residuals(T x0, T x1, T x2, T f0, T f1,
                                             T f2, const ShCoeffs<T>& k,
                                             T& sres, T& mres) {
    sres = x2 - x0 - k.h6 * ((f0 + T(4) * f1) + f2);
    mres = x1 - T(0.5) * (x0 + x2) - k.h8 * (f0 - f2);
}

// The register walk under Hermite-Simpson, D <= kRegWalkMaxD: lane d's
// column, steps [a.n0, a.n1) (the note at the top). A step loads the
// centers of its two new rows one step ahead; the stencils come from the
// other lanes by shuffles, so the walk touches no shared memory. Every
// lane of a warp runs the same steps.
template <typename T, bool kComp, bool kDiag, typename Acc>
__device__ __forceinline__ void walk_regs_sh(const L96Problem<T>& p,
                                             const T* x, T* g,
                                             const WalkArgs<T>& a,
                                             AgPartials<T, kComp, Acc>& s) {
    const int N = p.N, D = p.D, M = (p.N - 1) / 2;
    const int d = (int)a.lane;
    const bool on = d < D;
    const int l = on ? p.lpos[d] : -1;
    const int src[4] = {l96_wrap(d - 2, D), l96_wrap(d - 1, D),
                        l96_wrap(d + 1, D), l96_wrap(d + 2, D)};
    const ShCoeffs<T> k6(p.h);
    auto weight = [&](int n) {
        return on && n >= 0 && n < N - 1 ? a.rfd[(size_t)n * D + d] : T(0);
    };
    ObsCursor oc(2 * a.n0, p.obs_stride);
    // the observation term of row n at this column (misfit summed by the
    // row's owner, which every row walked here is)
    auto obs_grad = [&](int n, T xc, T gx) {
        if (l >= 0 && oc.at(n, p.N_data)) {
            const T wv = p.W[oc.k * p.L + l];
            const T diff = xc - p.Y[oc.k * p.L + l];
            gx += T(2) * p.me_norm * wv * diff;
            s.misfit(wv, diff);
        }
        oc.pass(n, p.obs_stride);
        return gx;
    };
    T xa[5];                        // x_{2k}[d-2..d+2]
    gather5(center(x, 2 * a.n0, d, D, on && 2 * a.n0 < N), src, xa);
    T fa = f5(xa, a.F);             // f(x_{2k})_d
    T ap = T(0), bp = T(0);         // a_{k-1}, b_{k-1} at d
    if (a.n0 > 0) {                 // the halo interval k0 - 1
        T xl[5], xh[5];
        gather5(center(x, 2 * a.n0 - 2, d, D, on), src, xl);
        gather5(center(x, 2 * a.n0 - 1, d, D, on), src, xh);
        T sres, mres;
        sh_residuals(xl[2], xh[2], xa[2], f5(xl, a.F), f5(xh, a.F), fa, k6,
                     sres, mres);
        ap = kDiag ? weight(2 * a.n0 - 2) * sres : sres;
        bp = kDiag ? weight(2 * a.n0 - 1) * mres : mres;
    }
    // the centers of the next step's rows 2k+1 and 2k+2
    auto ahead = [&](int k, int j) {
        const int n = 2 * k + j;
        return center(x, n, d, D, on && k < M && n < N);
    };
    T c1 = ahead(a.n0, 1), c2 = ahead(a.n0, 2);
    for (int k = a.n0; k < a.n1; ++k) {
        const bool has_int = k < M;
        T xm[5], xo[5];             // x_{2k+1}, x_{2k+2}
        gather5(c1, src, xm);
        gather5(c2, src, xo);
        c1 = ahead(k + 1, 1);
        c2 = ahead(k + 1, 2);
        const T fm = f5(xm, a.F), fo = f5(xo, a.F);
        T ak = T(0), bk = T(0);
        if (has_int) {
            T sres, mres;
            sh_residuals(xa[2], xm[2], xo[2], fa, fm, fo, k6, sres, mres);
            ak = kDiag ? weight(2 * k) * sres : sres;
            bk = kDiag ? weight(2 * k + 1) * mres : mres;
            if (on) s.interval(ak, sres, bk, mres);
        }
        // row 2k: J(x_{2k})^T v with v = (h/6)(a_{k-1} + a_k)
        // + (h/8)(b_k - b_{k-1})
        const T v = k6.h6 * (ap + ak) + k6.h8 * (bk - bp);
        const T v_m1 = __shfl_sync(0xffffffffu, v, src[1]);
        const T v_p1 = __shfl_sync(0xffffffffu, v, src[2]);
        const T v_p2 = __shfl_sync(0xffffffffu, v, src[3]);
        const T jt = xa[0] * v_m1 + (xa[4] - xa[1]) * v_p1 - xa[3] * v_p2
                     - v;
        T gx = a.c2 * ((ap - ak) - T(0.5) * (bp + bk) - jt);
        gx = obs_grad(2 * k, xa[2], gx);
        if (on) g[(size_t)(2 * k) * D + d] = gx;
        if (has_int) {
            // row 2k+1: b_k - (2h/3) J(x_{2k+1})^T a_k
            const T a_m1 = __shfl_sync(0xffffffffu, ak, src[1]);
            const T a_p1 = __shfl_sync(0xffffffffu, ak, src[2]);
            const T a_p2 = __shfl_sync(0xffffffffu, ak, src[3]);
            const T jt1 = xm[0] * a_m1 + (xm[4] - xm[1]) * a_p1
                          - xm[3] * a_p2 - ak;
            T gx1 = a.c2 * (bk - k6.h23 * jt1);
            gx1 = obs_grad(2 * k + 1, xm[2], gx1);
            if (on) g[(size_t)(2 * k + 1) * D + d] = gx1;
        }
#pragma unroll
        for (int i = 0; i < 5; ++i) xa[i] = xo[i];
        fa = fo;
        ap = ak;
        bp = bk;
    }
}

// The wide walk under Hermite-Simpson, D > kRegWalkMaxD: steps [a.n0,
// a.n1), the lane's columns d = lane + 32 j; x read where it lies (global
// or shared memory). The ring holds a_{k-1}, b_{k-1}, a_k, b_k and
// f(x_{2k}) at every column (5 of its kRingRows rows). A step's first pass
// forms interval k's residuals at the lane's columns (f_{2k+2} replacing
// f_{2k} in the ring), the second the gradients of rows 2k and 2k+1,
// whose stencils read the ring's a and b at neighbouring columns, after a
// __syncwarp; one more ends the step's reads.
template <typename T, bool kComp, bool kDiag, typename Acc>
__device__ __forceinline__ void walk_wide_sh(const L96Problem<T>& p,
                                             const T* x, T* g, T* ring,
                                             const WalkArgs<T>& a,
                                             AgPartials<T, kComp, Acc>& s) {
    const int D = p.D, M = (p.N - 1) / 2;
    const ShCoeffs<T> k6(p.h);
    T* ap = ring;                   // a_{k-1}
    T* bp = ring + D;               // b_{k-1}
    T* ac = ring + 2 * D;           // a_k
    T* bc = ring + 3 * D;           // b_k
    T* fr = ring + 4 * D;           // f(x_{2k})
    {
        const T* x0 = x + (size_t)(2 * a.n0) * D;
        for (int d = (int)a.lane; d < D; d += 32) {
            const T f0 = l96_f(x0, d, D, a.F);
            fr[d] = f0;
            if (a.n0 > 0) {         // the halo interval k0 - 1
                const T* xl = x0 - 2 * (size_t)D;
                const T* xh = x0 - (size_t)D;
                T sres, mres;
                sh_residuals(xl[d], xh[d], x0[d], l96_f(xl, d, D, a.F),
                             l96_f(xh, d, D, a.F), f0, k6, sres, mres);
                const size_t n = (size_t)(2 * a.n0 - 2) * D + d;
                ap[d] = kDiag ? a.rfd[n] * sres : sres;
                bp[d] = kDiag ? a.rfd[n + D] * mres : mres;
            }
        }
    }
    ObsCursor obs(2 * a.n0, p.obs_stride);
    // one row's gradient pass: gx = base(e) - J(x_n)^T v at e, where the
    // stencil reads v at e-1, e+1, e+2 and e; the observation term added
    auto grad_row = [&](int n, auto base, auto v) {
        const T* xr = x + (size_t)n * D;
        const bool is_obs = obs.at(n, p.N_data);
        const int krow = obs.k * p.L;
        for (int e = (int)a.lane; e < D; e += 32) {
            const T jt = l96_jtv(xr, v, e, D);
            T gx = a.c2 * (base(e) - jt);
            const int l = is_obs ? p.lpos[e] : -1;
            if (l >= 0) {
                const T wv = p.W[krow + l];
                const T diff = xr[e] - p.Y[krow + l];
                gx += T(2) * p.me_norm * wv * diff;
                s.misfit(wv, diff);
            }
            g[(size_t)n * D + e] = gx;
        }
        obs.pass(n, p.obs_stride);
    };
    for (int k = a.n0; k < a.n1; ++k) {
        const bool has_int = k < M;
        if (has_int) {
            const T* x0 = x + (size_t)(2 * k) * D;
            const T* x1 = x0 + D;
            const T* x2 = x1 + D;
            for (int d = (int)a.lane; d < D; d += 32) {
                const T f1 = l96_f(x1, d, D, a.F);
                const T f2 = l96_f(x2, d, D, a.F);
                T sres, mres;
                sh_residuals(x0[d], x1[d], x2[d], fr[d], f1, f2, k6, sres,
                             mres);
                const size_t n = (size_t)(2 * k) * D + d;
                const T ak = kDiag ? a.rfd[n] * sres : sres;
                const T bk = kDiag ? a.rfd[n + D] * mres : mres;
                ac[d] = ak;
                bc[d] = bk;
                fr[d] = f2;
                s.interval(ak, sres, bk, mres);
            }
        }
        __syncwarp();
        const T* app = k > 0 ? ap : nullptr;
        const T* bpp = k > 0 ? bp : nullptr;
        const T* acc = has_int ? ac : nullptr;
        const T* bcc = has_int ? bc : nullptr;
        auto at = [](const T* r, int e) { return r ? r[e] : T(0); };
        // row 2k
        grad_row(
            2 * k,
            [&](int e) {
                return (at(app, e) - at(acc, e))
                       - T(0.5) * (at(bpp, e) + at(bcc, e));
            },
            [&](int e) {
                return k6.h6 * (at(app, e) + at(acc, e))
                       + k6.h8 * (at(bcc, e) - at(bpp, e));
            });
        if (has_int) {              // row 2k+1
            grad_row(
                2 * k + 1, [&](int e) { return bc[e]; },
                [&](int e) { return k6.h23 * ac[e]; });
        }
        __syncwarp();
        T* t = ap;
        ap = ac;
        ac = t;
        t = bp;
        bp = bc;
        bc = t;
    }
}

// The walk and the sums of one member under rule kDisc, at a scalar rf
// or (kDiag) at the (N-1, D) rf rfd: l96_ag_block's contract (below),
// with A = me_norm sum W (x_obs - Y)^2 + fe_norm sum w r^2 (Hermite-
// Simpson: the note at the top). The sums FE, sum r and ME, their
// partials in red and the value's combination are in Acc, rounded to T
// once at the end; red holds l96_ag_red_elems values of Acc (with kComp
// under Hermite-Simpson kAgRuleCompSums a warp, the Hermite plane's pair
// in comp[4..5]). Inlined into its callers: l96_ag_block and
// l96_rule_block (K1-K4, K8; Acc = T) and K5's kernel (Acc = double).
template <typename T, bool kComp, typename Grp, int kDisc, bool kDiag,
          typename Acc = T>
__device__ __forceinline__ AgSums<T> l96_walk_block(
        const L96Problem<T>& p, const T* x, T rf, const T* rfd, T* g,
        T* ring, Acc* red, T* comp) {
    constexpr int W = Grp::kWarps;
    const unsigned lane = Grp::rank() & 31u;
    const unsigned warp = Grp::rank() >> 5;
    WalkArgs<T> a;
    a.F = p.pslot >= 0 ? x[p.pslot] : p.F_fixed;
    a.hh = p.h / T(2);
    a.c2 = kDiag ? T(2) * p.fe_norm : T(2) * p.fe_norm * rf;
    a.rfd = rfd;
    a.lane = lane;
    T* wring = ring + (size_t)warp * kRingRows * p.D;
    AgPartials<T, kComp, Acc> s;
    if constexpr (kDisc == kWalkSimpsonHermite) {
        // the warps split the M + 1 steps of the doubled grid
        warp_rows<W>((p.N + 1) / 2, warp, a.n0, a.n1, a.rows);
        if (p.D <= kRegWalkMaxD)
            walk_regs_sh<T, kComp, kDiag, Acc>(p, x, g, a, s);
        else if (a.n0 < a.n1)
            walk_wide_sh<T, kComp, kDiag, Acc>(p, x, g, wring, a, s);
    } else {
        warp_rows<W>(p.N, warp, a.n0, a.n1, a.rows);
        if (p.D <= kRegWalkMaxD)    // a warp without rows stores nothing
            walk_regs<T, kComp, kDisc, kDiag, Acc>(p, x, g, a, s);
        else if (a.n0 < a.n1)
            walk_wide<T, kComp, kDisc, kDiag, Acc>(p, x, g, wring, a, s);
    }
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
            T* cr = reinterpret_cast<T*>(red + kAgSums * W);
            cr[warp] = s.me_hi;
            cr[W + warp] = s.me_lo;
            cr[2 * W + warp] = s.fe_hi;
            cr[3 * W + warp] = s.fe_lo;
        }
        if constexpr (kDisc == kWalkSimpsonHermite) {
            warp_two_sum(s.f2_hi, s.f2_lo);
            if (lane == 0) {
                T* cr = reinterpret_cast<T*>(red + kAgSums * W);
                cr[4 * W + warp] = s.f2_hi;
                cr[5 * W + warp] = s.f2_lo;
            }
        }
    }
    Grp::sync();   // the warps' partials (and every entry of g) complete
    Acc fe_t = red[0], sr_t = red[W], me_t = red[2 * W];
    for (int w = 1; w < W; ++w) {
        fe_t += red[w];
        sr_t += red[W + w];
        me_t += red[2 * W + w];
    }
    if (p.pslot >= 0 && Grp::rank() == (unsigned)p.pslot % Grp::kSize)
        g[p.pslot] = kDisc == kWalkForwardMap
            ? T(-Acc(a.c2) * sr_t) : T(-Acc(a.c2) * Acc(p.h) * sr_t);
    if constexpr (kComp) {
        if (Grp::rank() == 0) {
            // the warps' pairs joined in order
            const T* cr = reinterpret_cast<const T*>(red + kAgSums * W);
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
            if constexpr (kDisc == kWalkSimpsonHermite) {
                T h2 = cr[4 * W], l2 = cr[5 * W];
                for (int w = 1; w < W; ++w)
                    two_join(h2, l2, cr[4 * W + w], cr[5 * W + w]);
                comp[4] = h2;
                comp[5] = l2;
            } else {
                comp[4] = T(0);
                comp[5] = T(0);
            }
        }
    }
    // rounded apart, so that no kernel's contraction can fuse a product
    // into the sum: K1's A and the solvers' f are the same bits
    const Acc me = mul_rn(Acc(p.me_norm), me_t);
    const Acc fe = kDiag ? fe_t : mul_rn(Acc(rf), fe_t);
    return AgSums<T>{T(add_rn(me, mul_rn(Acc(p.fe_norm), fe))), T(me)};
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
    return l96_walk_block<T, kComp, Grp, kWalkTrapezoid, false>(
        p, x, rf, nullptr, g, ring, red, comp);
}

// The problem of the rules' entries: the rule (WalkDisc) and, for an
// (N-1, D) rf, its rows (rfd; nullptr for a scalar rf).
template <typename T>
struct L96RuleProblem : L96Problem<T> {
    int disc;
    const T* rfd;
};

// One rule and rf kind of l96_rule_block, not inlined: each pair gets its
// own registers (in one body with the others, its walk's registers added
// to theirs and the solver's, and the kernels spilled).
template <typename T, bool kComp, typename Grp, int kDisc, bool kDiag>
__device__ __noinline__ AgSums<T> l96_rule_walk(
        const L96Problem<T>& problem, const T* x, T rf, const T* rfd,
        T* __restrict__ g, T* ring, T* red, T* comp) {
    const L96Problem<T> p = problem;
    return l96_walk_block<T, kComp, Grp, kDisc, kDiag>(p, x, rf, rfd, g,
                                                       ring, red, comp);
}

// l96_ag_block under the problem's rule and rf kind, chosen at run time
// (one body for each rule and rf kind, l96_rule_walk, which K1's and K4's
// rules' entries and K2/K3's evaluation call alike, so they run the same
// machine code). Every pair but the trapezoid rule with a scalar rf,
// which is l96_ag_block's: the entries refuse it (rule_ok), so a
// trapezoid problem here has its (N-1, D) rf. red: l96_ag_red_elems(kComp)
// values, or with kComp kAgRuleCompSums a warp (the Hermite plane's pair);
// comp[4..5] the Hermite plane's (hi, lo) under Hermite-Simpson, else
// zero.
template <typename T, bool kComp = false, typename Grp = BlockGroup>
__device__ __forceinline__ AgSums<T> l96_rule_block(
        const L96RuleProblem<T>& p, const T* x, T rf, T* __restrict__ g,
        T* ring, T* red, T* comp = nullptr) {
    const T* rfd = p.rfd;
    switch (p.disc) {
        case kWalkEuler:
            return rfd ? l96_rule_walk<T, kComp, Grp, kWalkEuler, true>(
                             p, x, rf, rfd, g, ring, red, comp)
                       : l96_rule_walk<T, kComp, Grp, kWalkEuler, false>(
                             p, x, rf, nullptr, g, ring, red, comp);
        case kWalkForwardMap:
            return rfd
                ? l96_rule_walk<T, kComp, Grp, kWalkForwardMap, true>(
                      p, x, rf, rfd, g, ring, red, comp)
                : l96_rule_walk<T, kComp, Grp, kWalkForwardMap, false>(
                      p, x, rf, nullptr, g, ring, red, comp);
        case kWalkSimpsonHermite:
            return rfd
                ? l96_rule_walk<T, kComp, Grp, kWalkSimpsonHermite, true>(
                      p, x, rf, rfd, g, ring, red, comp)
                : l96_rule_walk<T, kComp, Grp, kWalkSimpsonHermite, false>(
                      p, x, rf, nullptr, g, ring, red, comp);
        default:
            return l96_rule_walk<T, kComp, Grp, kWalkTrapezoid, true>(
                p, x, rf, rfd, g, ring, red, comp);
    }
}

// The rules' entries take a rule of the walk with whole intervals under
// Hermite-Simpson, and the trapezoid rule only with an (N-1, D) rf.
__host__ inline bool rule_ok(int disc, int N, bool diag) {
    return disc >= kWalkTrapezoid && disc <= kWalkSimpsonHermite
           && (disc != kWalkSimpsonHermite || N % 2 == 1)
           && (disc != kWalkTrapezoid || diag);
}
