// The Lorenz-96 trapezoid action and its full gradient for one ensemble
// member, computed by one whole thread block of kAgThreads threads. K1
// (ag_kernel.cu) is a thin __global__ around it; the whole-solve kernels
// (solve_kernel.cu) call it once per evaluation inside their L-BFGS loop.
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
#pragma once

#include "l96_ag.cuh"

constexpr int kAgThreads = 256;
constexpr int kAgWarps = kAgThreads / 32;

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

// Shared memory the routine needs: the (N-1)*D residuals and 3*kAgWarps
// reduction partials, in elements of T.
__host__ __device__ inline size_t l96_ag_smem_elems(int N, int D) {
    return (size_t)(N - 1) * D + 3 * kAgWarps;
}

// Action and gradient of the member at x (n_dof values, read from global
// memory by every thread, neighbours included) at scalar rf. Every thread
// of the block calls it. Writes the gradient to g (n_dof values) and, from
// thread 0, out[0] = A and, when kWithMe, out[1] = me_norm * sum W
// (x_obs - Y)^2 (the normalized measurement error, which the ladder kernel
// records). smem: l96_ag_smem_elems(N, D) elements.
// Thread 0 writes g[pslot] and out last: a caller that reads them from
// another thread synchronizes first.
template <typename T, bool kWithMe>
__device__ void l96_ag_block(const L96Problem<T>& p, const T* x, T rf,
                             T* __restrict__ g, T* smem, T* out) {
    const int N = p.N, D = p.D;
    T* r = smem;                                    // (N-1)*D residuals
    const int n_res = (N - 1) * D;
    T* red = r + n_res;                             // 3 * kAgWarps partials
    const T F = p.pslot >= 0 ? x[p.pslot] : p.F_fixed;
    const T hh = p.h / T(2);

    // pass 1: residuals into shared memory, partial sums of FE, sum r, ME
    T fe = T(0), sr = T(0), me = T(0);
    for (int i = threadIdx.x; i < n_res; i += kAgThreads) {
        const int n = i / D;
        const int d = i - n * D;
        const T* x0 = x + (size_t)n * D;
        const T* x1 = x0 + D;
        const T rr = x1[d] - x0[d]
                     - hh * (l96_f(x0, d, D, F) + l96_f(x1, d, D, F));
        r[i] = rr;
        fe += rr * rr;
        sr += rr;
    }
    for (int i = threadIdx.x; i < p.N_data * p.L; i += kAgThreads) {
        const int k = i / p.L;
        const int l = i - k * p.L;
        const T diff = x[(size_t)k * p.obs_stride * D + p.lidx[l]] - p.Y[i];
        me += p.W[i] * diff * diff;
    }

    // fixed-order block reduction of the three sums
    fe = warp_sum(fe);
    sr = warp_sum(sr);
    me = warp_sum(me);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
        red[warp] = fe;
        red[kAgWarps + warp] = sr;
        red[2 * kAgWarps + warp] = me;
    }
    __syncthreads();   // residuals and partials complete

    // pass 2: the gradient of every state entry from the shared residuals
    const T c2 = T(2) * p.fe_norm * rf;
    for (int i = threadIdx.x; i < N * D; i += kAgThreads) {
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

    if (threadIdx.x == 0) {
        T fe_t = T(0), sr_t = T(0), me_t = T(0);
        for (int w = 0; w < kAgWarps; ++w) {
            fe_t += red[w];
            sr_t += red[kAgWarps + w];
            me_t += red[2 * kAgWarps + w];
        }
        out[0] = p.me_norm * me_t + p.fe_norm * (rf * fe_t);
        if (kWithMe) out[1] = p.me_norm * me_t;
        if (p.pslot >= 0) g[p.pslot] = -c2 * p.h * sr_t;
    }
}
