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
// Sums are reduced in a fixed order (per-thread strided partials, a warp
// shuffle tree, then thread 0 over the warps in order), with no atomics:
// repeated calls give bit-identical results.
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
// and compiles to the code they had before groups existed (the ranks are
// unsigned, as threadIdx.x is: as int, the warp index's shift turned
// arithmetic and nvcc gave K3 f32 one more register).
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
// threads. Groups never wait for each other.
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

// Shared memory the routine needs: the (N-1)*D residuals and 3*warps
// reduction partials, plus 4*warps (hi, lo) partials with kComp, in
// elements of T; warps is the group's (kAgWarps for the whole block).
__host__ __device__ inline size_t l96_ag_smem_elems(int N, int D,
                                                    bool comp = false,
                                                    int warps = kAgWarps) {
    return (size_t)(N - 1) * D + (comp ? 7 : 3) * warps;
}

// Action and gradient of the member at x (n_dof values, read from global
// memory by every thread, neighbours included) at scalar rf. Every thread
// of the group Grp calls it. Writes the gradient to g (n_dof values) and,
// from rank 0, out[0] = A and, when kWithMe, out[1] = me_norm * sum W
// (x_obs - Y)^2 (the normalized measurement error, which the ladder kernel
// records). With kComp, rank 0 also writes comp[0..5] = [me_hi, me_lo,
// fe1_hi, fe1_lo, fe2_hi, fe2_lo], the two-float sums of the ME terms and
// of the unweighted FE terms (fe2, the Hermite plane of the reference's
// Simpson-Hermite layout, is zero for the trapezoid rule).
// smem: l96_ag_smem_elems(N, D, kComp, Grp::kWarps) elements, the group's
// own. Rank 0 writes g[pslot] and out last: a caller that reads them from
// another thread synchronizes the group first.
template <typename T, bool kWithMe, bool kComp = false,
          typename Grp = BlockGroup>
__device__ void l96_ag_block(const L96Problem<T>& p, const T* x, T rf,
                             T* __restrict__ g, T* smem, T* out,
                             T* comp = nullptr) {
    const int N = p.N, D = p.D;
    T* r = smem;                                    // (N-1)*D residuals
    const int n_res = (N - 1) * D;
    T* red = r + n_res;                             // 3 * warps partials
    const T F = p.pslot >= 0 ? x[p.pslot] : p.F_fixed;
    const T hh = p.h / T(2);

    // pass 1: residuals into shared memory, partial sums of FE, sum r, ME
    // (and, with kComp, the per-thread two-float sums of the terms)
    T fe = T(0), sr = T(0), me = T(0);
    [[maybe_unused]] T me_hi = T(0), me_lo = T(0), fe_hi = T(0),
                       fe_lo = T(0);
    for (int i = Grp::rank(); i < n_res; i += Grp::kSize) {
        const int n = i / D;
        const int d = i - n * D;
        const T* x0 = x + (size_t)n * D;
        const T* x1 = x0 + D;
        const T rr = x1[d] - x0[d]
                     - hh * (l96_f(x0, d, D, F) + l96_f(x1, d, D, F));
        r[i] = rr;
        fe += rr * rr;
        sr += rr;
        if constexpr (kComp) two_join(fe_hi, fe_lo, mul_rn(rr, rr), T(0));
    }
    for (int i = Grp::rank(); i < p.N_data * p.L; i += Grp::kSize) {
        const int k = i / p.L;
        const int l = i - k * p.L;
        const T diff = x[(size_t)k * p.obs_stride * D + p.lidx[l]] - p.Y[i];
        me += p.W[i] * diff * diff;
        if constexpr (kComp) {
            two_join(me_hi, me_lo, mul_rn(mul_rn(p.W[i], diff), diff),
                     T(0));
        }
    }

    // fixed-order block reduction of the three sums
    fe = warp_sum(fe);
    sr = warp_sum(sr);
    me = warp_sum(me);
    const int lane = Grp::rank() & 31;
    const int warp = Grp::rank() >> 5;
    if (lane == 0) {
        red[warp] = fe;
        red[Grp::kWarps + warp] = sr;
        red[2 * Grp::kWarps + warp] = me;
    }
    if constexpr (kComp) {
        warp_two_sum(me_hi, me_lo);
        warp_two_sum(fe_hi, fe_lo);
        if (lane == 0) {
            T* cr = red + 3 * Grp::kWarps;
            cr[warp] = me_hi;
            cr[Grp::kWarps + warp] = me_lo;
            cr[2 * Grp::kWarps + warp] = fe_hi;
            cr[3 * Grp::kWarps + warp] = fe_lo;
        }
    }
    Grp::sync();   // residuals and partials complete

    // pass 2: the gradient of every state entry from the shared residuals
    const T c2 = T(2) * p.fe_norm * rf;
    for (int i = Grp::rank(); i < N * D; i += Grp::kSize) {
        const int n = i / D;
        const int d = i - n * D;
        const T* rp = n > 0 ? r + (size_t)(n - 1) * D : nullptr;
        const T* rc = n < N - 1 ? r + (size_t)n * D : nullptr;
        const RowPairSum<T> v{rp, rc};
        const T jt = l96_jtv(x + (size_t)n * D, v, d, D);
        T gx = c2 * ((rp ? rp[d] : T(0)) - (rc ? rc[d] : T(0)) - hh * jt);
        if (n % p.obs_stride == 0 && n / p.obs_stride < p.N_data) {
            const int l = p.lpos[d];
            if (l >= 0) {
                const int k = (n / p.obs_stride) * p.L + l;
                gx += T(2) * p.me_norm * p.W[k] * (x[i] - p.Y[k]);
            }
        }
        g[i] = gx;
    }

    if (Grp::rank() == 0) {
        T fe_t = T(0), sr_t = T(0), me_t = T(0);
        for (int w = 0; w < Grp::kWarps; ++w) {
            fe_t += red[w];
            sr_t += red[Grp::kWarps + w];
            me_t += red[2 * Grp::kWarps + w];
        }
        out[0] = p.me_norm * me_t + p.fe_norm * (rf * fe_t);
        if (kWithMe) out[1] = p.me_norm * me_t;
        if (p.pslot >= 0) g[p.pslot] = -c2 * p.h * sr_t;
        if constexpr (kComp) {
            // the warps' pairs joined in order
            const T* cr = red + 3 * Grp::kWarps;
            T mh = cr[0], ml = cr[Grp::kWarps];
            T fh = cr[2 * Grp::kWarps], fl = cr[3 * Grp::kWarps];
            for (int w = 1; w < Grp::kWarps; ++w) {
                two_join(mh, ml, cr[w], cr[Grp::kWarps + w]);
                two_join(fh, fl, cr[2 * Grp::kWarps + w],
                         cr[3 * Grp::kWarps + w]);
            }
            comp[0] = mh;
            comp[1] = ml;
            comp[2] = fh;
            comp[3] = fl;
            comp[4] = T(0);
            comp[5] = T(0);
        }
    }
}
