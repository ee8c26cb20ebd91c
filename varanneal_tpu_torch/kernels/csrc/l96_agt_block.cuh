// The Lorenz-96 one-step action and its full gradient for one ensemble
// member, computed by one thread block of kAgtThreads threads: the body of
// K5 (agt_kernel.cu), templated on the discretization and on the kind of
// rf (a scalar, or one weight per residual entry, (N-1, D) row-major).
//
// With w_n = rf (scalar) or row n of rf, c = fe_norm, and the terms of a
// row outside 0 <= n <= N-2 absent:
//
//   disc        r_n                                    gX_n (FE part)
//   trapezoid   x_{n+1} - x_n - (h/2)(f(x_n)+f(x_{n+1}))
//               2c[w_{n-1}r_{n-1} - w_n r_n - (h/2) J(x_n)^T (w_{n-1}r_{n-1}
//                  + w_n r_n)]
//   euler       x_{n+1} - x_n - h f(x_n)
//               2c[w_{n-1}r_{n-1} - w_n r_n - h J(x_n)^T (w_n r_n)]
//   forwardmap  x_{n+1} - f(x_n)
//               2c[w_{n-1}r_{n-1} - J(x_n)^T (w_n r_n)]
//
//   A     = me_norm sum W (x_obs - Y)^2 + c sum w r^2
//   dA/dF = -2c h sum w r (trapezoid, euler), -2c sum w r (forwardmap)
//
// plus ME's gradient 2 me_norm W (x - y) on the observed entries of the
// rows k * obs_stride. f and J^T v are l96_f and l96_jtv (l96_ag.cuh).
//
// Layout: row-major (N, D), as the decision vector holds the path and as
// K1 reads it. The reference's kernel works in the transposed (D_pad,
// N_pad) layout so that at D << 128 time fills the TPU's vector lanes;
// on the card a thread takes one entry of the flat vector at a time, so
// the flat layout needs no transpose, no padding and no copy, and
// neighbouring threads read neighbouring addresses whatever D is.
//
// The weighted residuals w_n r_n go to shared memory in the first pass,
// and the gradient pass reads them (J^T v reads v at a row's neighbouring
// components) after a barrier. Sums are reduced in a fixed order
// (per-thread strided partials, a warp shuffle tree, then thread 0 over
// the warps in order), with no atomics: repeated calls give bit-identical
// results.
#pragma once

#include "l96_ag.cuh"

constexpr int kAgtThreads = 256;
constexpr int kAgtWarps = kAgtThreads / 32;

// The discretizations K5 takes (ops/disc.py's names).
enum AgtDisc { kAgtTrapezoid = 0, kAgtEuler = 1, kAgtForwardMap = 2 };

// The problem's constants, shared by every member.
template <typename T>
struct AgtProblem {
    int n_dof, N, D, pslot;     // pslot: index of F in XP, or -1 (fixed)
    T F_fixed;
    const T* Y;                 // (N_data, L)
    const T* W;                 // (N_data, L) RM weights
    const int* lidx;            // (L,) observed columns
    const int* lpos;            // (D,) position in lidx, or -1
    int N_data, L, obs_stride;
    T h, me_norm, fe_norm;
};

// v_e = a_e + b_e over one or two rows of weighted residuals, a missing
// row counting as zero.
template <typename T>
struct AgtRowSum {
    const T* a;
    const T* b;
    __device__ __forceinline__ T operator()(int e) const {
        return (a ? a[e] : T(0)) + (b ? b[e] : T(0));
    }
};

template <typename T>
__device__ __forceinline__ T agt_warp_sum(T v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// Residual entry d of row n, from the rows x0 = x_n and x1 = x_{n+1}.
template <int kDisc, typename T>
__device__ __forceinline__ T agt_residual(const T* x0, const T* x1, int d,
                                          int D, T F, T h, T hh) {
    if (kDisc == kAgtTrapezoid)
        return x1[d] - x0[d] - hh * (l96_f(x0, d, D, F) + l96_f(x1, d, D, F));
    if (kDisc == kAgtEuler) return x1[d] - x0[d] - h * l96_f(x0, d, D, F);
    return x1[d] - l96_f(x0, d, D, F);
}

// Shared memory the routine needs: the (N-1)*D weighted residuals and
// 3*kAgtWarps reduction partials, in elements of T.
__host__ __device__ inline size_t l96_agt_smem_elems(int N, int D) {
    return (size_t)(N - 1) * D + 3 * kAgtWarps;
}

// Action and gradient of the member at x (n_dof values, read from global
// memory by every thread, neighbours included). kDiag: rf is rfd, (N-1, D)
// row-major; else the scalar rf. Every thread of the block calls it.
// Writes the gradient to g (n_dof values) and, from thread 0, out[0] = A.
// smem: l96_agt_smem_elems(N, D) elements.
template <typename T, int kDisc, bool kDiag>
__device__ void l96_agt_block(const AgtProblem<T>& p, const T* x, T rf,
                              const T* __restrict__ rfd, T* __restrict__ g,
                              T* smem, T* out) {
    const int N = p.N, D = p.D;
    T* q = smem;                                    // (N-1)*D w_n r_n
    const int n_res = (N - 1) * D;
    T* red = q + n_res;                             // 3 * kAgtWarps partials
    const T F = p.pslot >= 0 ? x[p.pslot] : p.F_fixed;
    const T hh = p.h / T(2);

    // pass 1: weighted residuals into shared memory, partial sums of
    // sum w r^2, sum w r and ME
    T fe = T(0), sw = T(0), me = T(0);
    for (int i = threadIdx.x; i < n_res; i += kAgtThreads) {
        const int n = i / D;
        const int d = i - n * D;
        const T* x0 = x + (size_t)n * D;
        const T r = agt_residual<kDisc>(x0, x0 + D, d, D, F, p.h, hh);
        const T wr = kDiag ? rfd[i] * r : r;
        q[i] = wr;
        fe += wr * r;
        sw += wr;
    }
    for (int i = threadIdx.x; i < p.N_data * p.L; i += kAgtThreads) {
        const int k = i / p.L;
        const int l = i - k * p.L;
        const T diff = x[(size_t)k * p.obs_stride * D + p.lidx[l]] - p.Y[i];
        me += p.W[i] * diff * diff;
    }

    // fixed-order block reduction of the three sums
    fe = agt_warp_sum(fe);
    sw = agt_warp_sum(sw);
    me = agt_warp_sum(me);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
        red[warp] = fe;
        red[kAgtWarps + warp] = sw;
        red[2 * kAgtWarps + warp] = me;
    }
    __syncthreads();   // weighted residuals and partials complete

    // pass 2: the gradient of every state entry from the shared rows
    const T c2 = kDiag ? T(2) * p.fe_norm : T(2) * p.fe_norm * rf;
    for (int i = threadIdx.x; i < N * D; i += kAgtThreads) {
        const int n = i / D;
        const int d = i - n * D;
        const T* qp = n > 0 ? q + (size_t)(n - 1) * D : nullptr;
        const T* qc = n < N - 1 ? q + (size_t)n * D : nullptr;
        const T* xn = x + (size_t)n * D;
        const T vp = qp ? qp[d] : T(0);
        const T vc = qc ? qc[d] : T(0);
        T gx;
        if (kDisc == kAgtTrapezoid) {
            const T jt = l96_jtv(xn, AgtRowSum<T>{qp, qc}, d, D);
            gx = c2 * (vp - vc - hh * jt);
        } else {
            const T jt = qc ? l96_jtv(xn, AgtRowSum<T>{nullptr, qc}, d, D)
                            : T(0);
            gx = kDisc == kAgtEuler ? c2 * (vp - vc - p.h * jt)
                                    : c2 * (vp - jt);
        }
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
        T fe_t = T(0), sw_t = T(0), me_t = T(0);
        for (int w = 0; w < kAgtWarps; ++w) {
            fe_t += red[w];
            sw_t += red[kAgtWarps + w];
            me_t += red[2 * kAgtWarps + w];
        }
        out[0] = p.me_norm * me_t
                 + p.fe_norm * (kDiag ? fe_t : rf * fe_t);
        if (p.pslot >= 0)
            g[p.pslot] = kDisc == kAgtForwardMap ? -c2 * sw_t
                                                 : -c2 * p.h * sw_t;
    }
}
