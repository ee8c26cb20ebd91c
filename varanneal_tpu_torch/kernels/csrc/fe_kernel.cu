// K6 on Hopper: the time-blocked model-error (FE) kernels, forward and
// hand-written adjoint, for the one-step discretizations and for
// Hermite–Simpson, over a (member, time block) grid.
//
// Replaces varanneal_tpu/kernels/fe_pallas.py's seven pallas_call sites:
//
//   fe_onestep_fwd  <- _kern_scalar (:138, call :384) and _kern_diag
//                      (:156, call :396): kDiag picks the rf form;
//   fe_onestep_vag  <- _kern_bwd (:187, call :450), with the value in the
//                      same launch (the reference runs _kern_scalar or
//                      _kern_diag, then _kern_bwd in its custom_vjp): the
//                      backward's outputs and fe_onestep_fwd's partials,
//                      on the same blocks;
//   fe_sh_fwd       <- _kern_sh_fwd (:238, call :632) and the batched-grid
//                      _kern_sh_fwd_b (:472, call :718);
//   fe_sh_vag       <- _kern_sh_bwd (:260, call :648) and _kern_sh_bwd_b
//                      (:502, call :735), with the value in the same
//                      launch (the reference runs _kern_sh_fwd, then
//                      _kern_sh_bwd in its custom_vjp): the backward's
//                      outputs and fe_sh_fwd's partials, on the same
//                      blocks.
//
// The batch is always on the grid (gridDim.y = B members, gridDim.x = time
// blocks), so one kernel serves the Pallas kernel's B = 1 form and its
// batched-grid form. What the Pallas kernels owe to the TPU is dropped: D
// is not padded to 128 lanes, no shifted copies of X are built in device
// memory (a block stages its own rows, halo included, in shared memory),
// the boundaries are index tests instead of zero weight rows, and the
// per-block partial sums are reduced in registers and shared memory.
//
// Formulas (fe_pallas.py; norm and 2·g/norm are applied by the wrapper):
//
//   one-step residual r_n   trapezoid x_{n+1} - x_n - (h/2)(f_n + f_{n+1})
//                           euler     x_{n+1} - x_n - h f_n
//                           forwardmap x_{n+1} - f_n
//   partial (block)         rf · Σ r²  (scalar rf)  or  Σ rf ⊙ r²
//   adjoint (_disc_coeffs)  wr_n = w_n r_n, v_m = c0 wr_{m-1} + c1 wr_m,
//                           gx_m = wr_{m-1} - a1 wr_m - J(x_m)ᵀ v_m,
//                           gp partial = -Σ_m F_p(x_m)ᵀ v_m (F_p the
//                           model's parameter Jacobian; Lorenz-96: -Σ v)
//   Hermite–Simpson         S = x_{2k+2} - x_{2k} - (h/6)(f0 + 4 fm + f1),
//                           H = x_{2k+1} - (x_{2k} + x_{2k+2})/2
//                               - (h/8)(f0 - f1),
//                           partial Σ ws S² + wh H², and the triplet
//                           g_e0 = -WS - WH/2 + J0ᵀ v0, g_m = WH + Jmᵀ vm,
//                           g_e1 = WS - WH/2 + J1ᵀ v1 (WS = ws S,
//                           WH = wh H, v0 = -(h/6)WS - (h/8)WH,
//                           vm = -(4h/6)WS, v1 = -(h/6)WS + (h/8)WH),
//                           gp partial = Σ F_p0ᵀ v0 + F_pmᵀ vm + F_p1ᵀ v1.
//
// The wrapper (kernels/fe.py) sums the partials over blocks and scales
// them, and joins the Hermite–Simpson triplet into the gradient by node
// with one shift-add (g_even[j] = g_e0[j] + g_e1[j-1]), as the reference
// does: an even node is shared by two intervals that may lie in two
// blocks, so writing the triplet keeps the kernel free of races.
//
// What bounds it on the card: each kernel reads X once (N_f·D values a
// member) plus rf, and writes a partial a block (forward) or the gradient
// (backward); ~15-60 operations an entry for Lorenz-96, ~2-4x that for
// NaKL (a tanh and a division a gate). At BASELINE config #2 (D=100,
// N_f=241, one member) that is ~100-300 KB and ~1 MFLOP a launch, at
// config #3 (NaKL, D=4, N_f=6,001) ~100-300 KB and ~2 MFLOP: well
// under a microsecond at the card's rates, below the few microseconds a
// launch costs. So the kernels are bound by launch latency and by the
// serial depth of one thread (stage, one or two passes, one reduction);
// with few members most SMs would sit idle. So the wrapper sizes the
// blocks from the batch's rows (B·M intervals under Hermite–Simpson, B·N_f
// rows for a one-step disc) and the SM count, so that one member covers
// the SMs (config #3 at B=1: 94 blocks of 32 intervals; config #2: 120
// blocks of one interval; config #1's one-step path: 161 blocks of one
// row), and a thread takes one interval or row of a row-level model
// (NaKL) or one (interval or row, component) pair of Lorenz-96, with no
// loop over pairs at the configurations' shapes. A NaKL thread evaluates
// each node it owns once (three tanh and three divisions a node, none
// again for Jᵀv or the parameter adjoint), so no warp splits by
// component. The value-and-gradient launches give the value's block
// partials too, on the blocks of the value-only launch and with its
// arithmetic, so the two agree bit for bit. The parameter partials and
// the value reduce by shuffle trees, then lane j of warp 0 sums partial
// j's warp slots in order. No atomics anywhere, so repeated launches give
// bit-identical results.
//
// The model is a template parameter with f, the transposed Jacobian
// product and the parameter adjoint written by hand (no autodiff on the
// card): L96 uses l96_ag.cuh's functions unchanged, NaKL nakl.cuh's. A
// model reads its parameter row p (kNP values: the wrapper merges the
// estimated values into the fixed ones and, for a log-space model,
// exponentiates them, so the kernel always sees the linear parameters)
// and the stimulus of its model-grid row (I; 0 without a stimulus), and
// adds its parameter partials Σ_d df_d/dp_j v_d into kNP per-thread
// accumulators, reduced in a fixed order per block (gp: (B, kNP, blocks)).
// Lorenz-96 (kNP = 1) reads F from global memory, and its arithmetic is
// the one of the L96-only kernels, bit for bit; NaKL stages its 19
// parameters, extended by 1/Cm and the gates' 1/dva, in shared memory.
// Colpitts (colpitts.cuh) and Lorenz-63 (l63.cuh), D = 3 and 4 or 3
// parameters, take NaKL's row-level paths with no stimulus: a thread an
// interval or node, each node's f (and Colpitts' exp(-x1)) evaluated once
// and reused by Jᵀv and the parameter adjoint.

#include <cuda_runtime.h>

#include "l96_ag.cuh"
#include "row_models.cuh"

namespace {

enum Disc { kEuler = 0, kTrapezoid = 1, kForwardmap = 2 };
enum ModelId { kL96 = 0, kNaKL = 1, kColpitts = 2, kL63 = 3 };

// Lorenz-96 with p = [F]: df_d/dF = 1, so F's adjoint is Σ_d v_d. Its
// kernels map a thread to an (interval or row, component) pair (kRow
// false): D runs to the thousands, and a component's f and Jᵀv read its
// neighbours only.
struct L96 {
    static constexpr int kNP = 1;
    static constexpr int kNPX = 1;
    static constexpr bool kStim = false;
    static constexpr bool kRow = false;
    static constexpr int kMaxThreads = 1024;
    template <typename T>
    __device__ static T f(const T* x, int d, int D, const T* p, T) {
        return l96_f(x, d, D, p[0]);
    }
    template <typename T, typename V>
    __device__ static T jtv(const T* x, const V& v, int e, int D,
                            const T*) {
        return l96_jtv(x, v, e, D);
    }
    template <typename T>
    __device__ static void ptv(const T*, int, int, const T*, T, T v_d,
                               T* acc) {
        acc[0] += v_d;
    }
};

// One-step residual from x_n, x_{n+1} and f at both (f1 unread but under
// the trapezoid rule); hc is h/2 (trapezoid), h (euler), unused
// (forwardmap).
template <typename T, int kDisc>
__device__ __forceinline__ T step_residual(T x0, T x1, T f0, T f1, T hc) {
    if constexpr (kDisc == kTrapezoid) {
        return x1 - x0 - hc * (f0 + f1);
    } else if constexpr (kDisc == kEuler) {
        return x1 - x0 - hc * f0;
    } else {
        return x1 - f0;
    }
}

// The same of component d from the rows x0 = x_n, x1 = x_{n+1} of a model
// without a stimulus (Lorenz-96's pair mapping), f evaluated where the rule
// reads it.
template <typename T, typename Model, int kDisc>
__device__ __forceinline__ T onestep_residual(const T* x0, const T* x1,
                                              int d, int D, const T* p,
                                              T hc) {
    const T f0 = Model::f(x0, d, D, p, T(0));
    const T f1 = kDisc == kTrapezoid ? Model::f(x1, d, D, p, T(0)) : T(0);
    return step_residual<T, kDisc>(x0[d], x1[d], f0, f1, hc);
}

// Hermite–Simpson residual pair of component d on one interval (rows
// xe0, xm = xe0 + D, xe1 = xe0 + 2D; currents s[0], s[1], s[2]).
template <typename T, typename Model>
__device__ __forceinline__ void sh_residuals(const T* xe0, int d, int D,
                                             const T* p, const T* s, T h6,
                                             T h8, T* S, T* H) {
    const T* xm = xe0 + D;
    const T* xe1 = xm + D;
    const T f0 = Model::f(xe0, d, D, p, s[0]);
    const T fm = Model::f(xm, d, D, p, s[1]);
    const T f1 = Model::f(xe1, d, D, p, s[2]);
    *S = xe1[d] - xe0[d] - h6 * (f0 + T(4) * fm + f1);
    *H = xm[d] - T(0.5) * (xe0[d] + xe1[d]) - h8 * (f0 - f1);
}

// ---------------------------------------------------------------------------
// K6c/K6d, Hermite–Simpson. Block i of member b takes intervals
// [k0, k0 + nk), k0 = i·bk, and stages rows 2k0 .. 2k0 + 2nk. The wrapper
// picks bk from B·M and the card's SM count, and the threads a block
// (kernels/fe.py, rows_per_block and sh_threads), so that one member
// spreads over many SMs and a thread takes one interval (a row-level
// model) or one (interval, component) pair (Lorenz-96) up to
// Model::kMaxThreads, past which (Lorenz-96 at D > 1,024) a thread takes
// more: every loop below strides by blockDim.x, so any whole number of
// warps up to kMaxThreads is right. rf (diagonal form): (N_f - 1, D)
// rows, ws = row 2k, wh = row 2k + 1. Outputs: partials (B, gridDim.x),
// the triplet (g_e0, g_m, g_e1) each (B, M, D), gp (B, kNP, gridDim.x).

// Shared memory of a block of nw warps, in values: the staged rows, the
// reduction's slots (kNP + 1 a warp: the parameter partials and the
// value), and for a row model its extended parameter row and the stimulus
// of its rows; the Lorenz-96 fused launch also keeps S and H (pass 2
// reads them) and v0, vm, v1 (Jᵀv reads them at other components).
template <typename Model>
constexpr size_t sh_smem_vals(bool grad, int bk, int D, int nw) {
    size_t v = (size_t)(2 * bk + 1) * D + (size_t)nw * (Model::kNP + 1);
    if (Model::kRow) {
        v += Model::kNPX + 2 * bk + 1;
    } else if (grad) {
        v += (size_t)5 * bk * D;
    }
    return v;
}

// Sums N per-thread values over the block in a fixed order: a shuffle
// tree in each warp, then lane j of warp 0 adds value j's warp sums in
// warp order and calls out(j, sum) (N <= 32). No atomics, so a repeated
// launch gives the same bits.
template <typename T, int N, typename Out>
__device__ __forceinline__ void block_reduce(T* v, T* red, const Out& out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            v[j] += __shfl_down_sync(0xffffffffu, v[j], o);
        }
    }
    if (lane == 0) {
#pragma unroll
        for (int j = 0; j < N; ++j) red[j * nw + warp] = v[j];
    }
    __syncthreads();
    if (threadIdx.x < N) {
        T s = T(0);
        for (int w = 0; w < nw; ++w) s += red[threadIdx.x * nw + w];
        out((int)threadIdx.x, s);
    }
}

// The block's rows and, for a row model, its extended parameter row and
// the stimulus of its rows (0 without one). Returns the parameter row
// the model reads (Lorenz-96: member b's row of P in global memory). The
// caller's barrier covers the copies.
template <typename T, typename Model>
__device__ __forceinline__ const T* sh_stage(
        const T* __restrict__ X, long long x_bs, const T* __restrict__ P,
        long long p_bs, const T* __restrict__ stim, int D, int k0, int nk,
        T* sx, T* sp, T* ss) {
    const T* xb = X + (size_t)blockIdx.y * x_bs + (size_t)2 * k0 * D;
    for (int j = threadIdx.x; j < (2 * nk + 1) * D; j += blockDim.x) {
        sx[j] = xb[j];
    }
    const T* prow = P + (size_t)blockIdx.y * p_bs;
    if constexpr (Model::kRow) {
        for (int j = threadIdx.x; j < Model::kNPX; j += blockDim.x) {
            sp[j] = Model::param(prow, j);
        }
        for (int j = threadIdx.x; j < 2 * nk + 1; j += blockDim.x) {
            ss[j] = stim ? stim[2 * k0 + j] : T(0);
        }
        return sp;
    }
    return prow;
}

template <typename T, bool kDiag>
__device__ __forceinline__ void sh_weights(const T* __restrict__ rf, T rf_s,
                                           int k, int d, int D, T* ws,
                                           T* wh) {
    if constexpr (kDiag) {
        const size_t at = (size_t)2 * k * D + d;
        *ws = rf[at];
        *wh = rf[at + D];
    } else {
        *ws = rf_s;
        *wh = rf_s;
    }
}

// Row model: thread kk owns interval k0 + kk and evaluates its three
// nodes once each (Model::node: f and what the adjoint reuses); the
// backward forms S, H, WS, WH, v and then Jᵀv and the parameter partials
// from the same node quantities, in registers, with no barrier between.
// kGrad: false the forward (value partials), true the fused launch (the
// value partials and the backward's outputs).
template <typename T, typename Model, bool kDiag, bool kGrad>
__device__ __forceinline__ void sh_rows(
        const T* __restrict__ X, long long x_bs, const T* __restrict__ P,
        long long p_bs, const T* __restrict__ stim,
        const T* __restrict__ rf, T rf_s, int M, T h6, T h8, T h46, int bk,
        T* __restrict__ ge0, T* __restrict__ gm, T* __restrict__ ge1,
        T* __restrict__ gp, T* __restrict__ partials) {
    constexpr int D = Model::kD, NP = Model::kNP;
    constexpr int NV = kGrad ? NP + 1 : 1;
    using Node = typename Model::template Node<T>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nw = blockDim.x >> 5;
    T* sx = reinterpret_cast<T*>(smem_raw);           // (2 bk + 1) * D
    T* red = sx + (size_t)(2 * bk + 1) * D;            // nw * (NP + 1)
    T* sp = red + (size_t)nw * (NP + 1);               // kNPX
    T* ss = sp + Model::kNPX;                          // 2 bk + 1
    const int k0 = blockIdx.x * bk;
    const int nk = min(bk, M - k0);
    const T* p = sh_stage<T, Model>(X, x_bs, P, p_bs, stim, D, k0, nk, sx,
                                    sp, ss);
    __syncthreads();
    T acc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = T(0);
    for (int kk = threadIdx.x; kk < nk; kk += blockDim.x) {
        const T* x0 = sx + (size_t)2 * kk * D;
        const T* xm = x0 + D;
        const T* x1 = xm + D;
        Node n0, nm, n1;
        Model::node(x0, p, ss[2 * kk], n0);
        Model::node(xm, p, ss[2 * kk + 1], nm);
        Model::node(x1, p, ss[2 * kk + 2], n1);
        T WS[D], WH[D], v0[D], vm[D], v1[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
            const T S = x1[d] - x0[d]
                        - h6 * (n0.f[d] + T(4) * nm.f[d] + n1.f[d]);
            const T H = xm[d] - T(0.5) * (x0[d] + x1[d])
                        - h8 * (n0.f[d] - n1.f[d]);
            T ws, wh;
            sh_weights<T, kDiag>(rf, rf_s, k0 + kk, d, D, &ws, &wh);
            acc[NV - 1] += ws * S * S + wh * H * H;
            WS[d] = ws * S;
            WH[d] = wh * H;
            v0[d] = -h6 * WS[d] - h8 * WH[d];
            vm[d] = -h46 * WS[d];
            v1[d] = -h6 * WS[d] + h8 * WH[d];
        }
        if constexpr (kGrad) {
            T j0[D], jm[D], j1[D];
            Model::adjoint(x0, p, n0, v0, j0, acc);
            Model::adjoint(xm, p, nm, vm, jm, acc);
            Model::adjoint(x1, p, n1, v1, j1, acc);
            const size_t out = ((size_t)blockIdx.y * M + k0 + kk) * D;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                ge0[out + d] = -WS[d] - T(0.5) * WH[d] + j0[d];
                gm[out + d] = WH[d] + jm[d];
                ge1[out + d] = WS[d] - T(0.5) * WH[d] + j1[d];
            }
        }
    }
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    block_reduce<T, NV>(acc, red, [&](int j, T s) {
        if (kGrad && j < NP) {
            gp[((size_t)blockIdx.y * NP + j) * gridDim.x + blockIdx.x] = s;
        } else {
            partials[blk] = s;
        }
    });
}

// Lorenz-96: thread j owns pair (interval j / D, component j % D). Its
// arithmetic a pair is the per-component design's, so each gradient
// entry keeps its bits: pass 1 computes S and H, the value term and v0,
// vm, v1, and keeps S and H in shared memory; pass 2, after a block
// barrier (Jᵀv reads v at other components), reads S and H back and
// weights them as that design's second pass did (kept as WS and WH,
// nvcc contracts the triplet's sums otherwise, and its f32 entries move
// by an ulp). F's partial sums the interval's three terms before adding
// them, (a + b) + c.
template <typename T, typename Model, bool kDiag, bool kGrad>
__device__ __forceinline__ void sh_pairs(
        const T* __restrict__ X, long long x_bs, const T* __restrict__ P,
        long long p_bs, const T* __restrict__ rf, T rf_s, int M, int D,
        T h6, T h8, T h46, int bk, T* __restrict__ ge0, T* __restrict__ gm,
        T* __restrict__ ge1, T* __restrict__ gp, T* __restrict__ partials) {
    static_assert(!Model::kStim, "the pair mapping reads no stimulus");
    constexpr int NP = Model::kNP;
    constexpr int NV = kGrad ? NP + 1 : 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nw = blockDim.x >> 5;
    T* sx = reinterpret_cast<T*>(smem_raw);           // (2 bk + 1) * D
    T* red = sx + (size_t)(2 * bk + 1) * D;            // nw * (NP + 1)
    T* sS = red + (size_t)nw * (NP + 1);               // bk * D each
    T* sH = sS + (size_t)bk * D;
    T* v0 = sH + (size_t)bk * D;
    T* vm = v0 + (size_t)bk * D;
    T* v1 = vm + (size_t)bk * D;
    const int k0 = blockIdx.x * bk;
    const int nk = min(bk, M - k0);
    const T* p = sh_stage<T, Model>(X, x_bs, P, p_bs, nullptr, D, k0, nk,
                                    sx, nullptr, nullptr);
    __syncthreads();
    const T st[3] = {T(0), T(0), T(0)};
    T acc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = T(0);
    for (int j = threadIdx.x; j < nk * D; j += blockDim.x) {
        const int kk = j / D, d = j - kk * D;
        const T* xe0 = sx + (size_t)2 * kk * D;
        T S, H, ws, wh;
        sh_residuals<T, Model>(xe0, d, D, p, st, h6, h8, &S, &H);
        sh_weights<T, kDiag>(rf, rf_s, k0 + kk, d, D, &ws, &wh);
        acc[NV - 1] += ws * S * S + wh * H * H;
        if constexpr (kGrad) {
            const T WS = ws * S, WH = wh * H;
            const T a = -h6 * WS - h8 * WH;
            const T b = -h46 * WS;
            const T c = -h6 * WS + h8 * WH;
            sS[j] = S;
            sH[j] = H;
            v0[j] = a;
            vm[j] = b;
            v1[j] = c;
            T t[NP];
#pragma unroll
            for (int k = 0; k < NP; ++k) t[k] = T(0);
            Model::ptv(xe0, d, D, p, st[0], a, t);
            Model::ptv(xe0 + D, d, D, p, st[1], b, t);
            Model::ptv(xe0 + 2 * D, d, D, p, st[2], c, t);
#pragma unroll
            for (int k = 0; k < NP; ++k) acc[k] += t[k];
        }
    }
    if constexpr (kGrad) {
        __syncthreads();
        const size_t out0 = (size_t)blockIdx.y * M * D + (size_t)k0 * D;
        for (int j = threadIdx.x; j < nk * D; j += blockDim.x) {
            const int kk = j / D, e = j - kk * D;
            const T* xe0 = sx + (size_t)2 * kk * D;
            T ws, wh;
            sh_weights<T, kDiag>(rf, rf_s, k0 + kk, e, D, &ws, &wh);
            const T WS = ws * sS[j], WH = wh * sH[j];
            const T* r0 = v0 + (size_t)kk * D;
            const T* rm = vm + (size_t)kk * D;
            const T* r1 = v1 + (size_t)kk * D;
            ge0[out0 + j] = -WS - T(0.5) * WH
                            + Model::jtv(xe0, [r0](int k) { return r0[k]; },
                                         e, D, p);
            gm[out0 + j] = WH + Model::jtv(xe0 + D,
                                           [rm](int k) { return rm[k]; }, e,
                                           D, p);
            ge1[out0 + j] = WS - T(0.5) * WH
                            + Model::jtv(xe0 + 2 * D,
                                         [r1](int k) { return r1[k]; }, e, D,
                                         p);
        }
    }
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    block_reduce<T, NV>(acc, red, [&](int j, T s) {
        if (kGrad && j < NP) {
            gp[((size_t)blockIdx.y * NP + j) * gridDim.x + blockIdx.x] = s;
        } else {
            partials[blk] = s;
        }
    });
}

template <typename T, typename Model, bool kDiag, bool kGrad>
__device__ __forceinline__ void sh_block(
        const T* X, long long x_bs, const T* P, long long p_bs,
        const T* stim, const T* rf, T rf_s, int M, int D, T h6, T h8, T h46,
        int bk, T* ge0, T* gm, T* ge1, T* gp, T* partials) {
    if constexpr (Model::kRow) {
        sh_rows<T, Model, kDiag, kGrad>(X, x_bs, P, p_bs, stim, rf, rf_s, M,
                                        h6, h8, h46, bk, ge0, gm, ge1, gp,
                                        partials);
    } else {
        sh_pairs<T, Model, kDiag, kGrad>(X, x_bs, P, p_bs, rf, rf_s, M, D,
                                         h6, h8, h46, bk, ge0, gm, ge1, gp,
                                         partials);
    }
}

// K6c/K6d forward: the value's block partials Σ ws S² + wh H².
template <typename T, typename Model, bool kDiag>
__global__ void __launch_bounds__(Model::kMaxThreads) fe_sh_fwd(
        const T* __restrict__ X, long long x_bs, const T* __restrict__ P,
        long long p_bs, const T* __restrict__ stim,
        const T* __restrict__ rf, T rf_s, int M, int D, T h6, T h8, int bk,
        T* __restrict__ partials) {
    sh_block<T, Model, kDiag, false>(X, x_bs, P, p_bs, stim, rf, rf_s, M, D,
                                     h6, h8, T(0), bk, nullptr, nullptr,
                                     nullptr, nullptr, partials);
}

// K6c/K6d value and gradient in one launch: the value's block partials,
// the triplet and the parameters' block partials
// Σ (F_p(x_e0)ᵀ v0 + F_p(x_m)ᵀ vm + F_p(x_e1)ᵀ v1), the value from the
// residuals the backward computes anyway.
template <typename T, typename Model, bool kDiag>
__global__ void __launch_bounds__(Model::kMaxThreads) fe_sh_vag(
        const T* __restrict__ X, long long x_bs, const T* __restrict__ P,
        long long p_bs, const T* __restrict__ stim,
        const T* __restrict__ rf, T rf_s, int M, int D, T h6, T h8, T h46,
        int bk, T* __restrict__ ge0, T* __restrict__ gm, T* __restrict__ ge1,
        T* __restrict__ gp, T* __restrict__ partials) {
    sh_block<T, Model, kDiag, true>(X, x_bs, P, p_bs, stim, rf, rf_s, M, D,
                                    h6, h8, h46, bk, ge0, gm, ge1, gp,
                                    partials);
}

// ---------------------------------------------------------------------------
// K6a/K6b, the one-step discs. Block i of member b takes the gradient rows
// [m0, m0 + nm), m0 = i·bn, nm = min(bn, N_f - m0), and for the value the
// residual rows of the same indices below N_f - 1 (the last block may have
// none; its partial is then 0). The wrapper picks bn from B·N_f and the
// card's SM count and the threads a block (kernels/fe.py, rows_per_block
// and onestep_threads). wr_q = w_q r_q is the weighted residual, zero
// outside 0 .. N_f - 2; v_m = c0 wr_{m-1} + c1 wr_m; gx_m = wr_{m-1}
// - a1 wr_m - J(x_m)ᵀ v_m; gp's partial -Σ_m F_p(x_m)ᵀ v_m. Outputs:
// partials (B, gridDim.x), gx (B, N_f, D), gp (B, kNP, gridDim.x).

// Shared memory of a one-step block of nw warps, in values: the
// reduction's slots (kNP + 1 a warp); a row model's extended parameter
// row; Lorenz-96's x rows m0 - 1 .. m0 + bn and wr rows m0 - 1 ..
// m0 + bn - 1.
template <typename Model>
constexpr size_t onestep_smem_vals(int bn, int D, int nw) {
    const size_t v = (size_t)nw * (Model::kNP + 1);
    return Model::kRow ? v + Model::kNPX : v + (size_t)(2 * bn + 3) * D;
}

// Lorenz-96: a thread a (row, component) pair. The block stages its x rows
// with the halo row m0 - 1, then computes the weighted residuals of rows
// m0 - 1 .. m0 + nm - 1 (the halo row itself: no other block's work is
// read) into shared memory, the value's terms and F's from its own rows;
// after one barrier, a gradient entry forms v at the components Jᵀv reads
// from the two wr rows, with no v array. F enters every component with
// df_d/dF = 1, so its adjoint -Σ_m Σ_d v_m,d is -(c0 + c1) Σ_q Σ_d wr_q,d
// (each wr row enters two v rows, once with c0 and once with c1), as K1
// forms dA/dF. The value-only launch (kGrad false) walks the same pairs in
// the same order, so its partials are the fused launch's bits.
template <typename T, typename Model, int kDisc, bool kDiag, bool kGrad>
__device__ __forceinline__ void onestep_pairs(
        const T* __restrict__ X, long long x_bs, const T* __restrict__ P,
        long long p_bs, const T* __restrict__ rf, T rf_s, int N_f, int D,
        T hc, T a1, T c0, T c1, int bn, T* __restrict__ gx,
        T* __restrict__ gp, T* __restrict__ partials) {
    static_assert(!Model::kStim && Model::kNP == 1,
                  "the pair mapping: one parameter with df_d/dp = 1");
    constexpr int NP = Model::kNP;
    constexpr int NV = kGrad ? NP + 1 : 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nw = blockDim.x >> 5;
    T* sx = reinterpret_cast<T*>(smem_raw);           // (bn + 2) * D
    T* wr = sx + (size_t)(bn + 2) * D;                 // (bn + 1) * D
    T* red = wr + (size_t)(bn + 1) * D;                // nw * (NP + 1)
    const int m0 = blockIdx.x * bn;
    const int nm = min(bn, N_f - m0);
    const T* p = P + (size_t)blockIdx.y * p_bs;
    const T* xb = X + (size_t)blockIdx.y * x_bs + (long long)(m0 - 1) * D;
    for (int j = threadIdx.x; j < (nm + 2) * D; j += blockDim.x) {
        const int row = m0 - 1 + j / D;
        sx[j] = row >= 0 && row < N_f ? xb[j] : T(0);
    }
    __syncthreads();
    T acc[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = T(0);
    // row j <-> residual m0 - 1 + j; the halo row j = 0 feeds the gradient
    for (int j = threadIdx.x; j < (nm + 1) * D; j += blockDim.x) {
        const int row = j / D, d = j - row * D;
        const int q = m0 - 1 + row;
        T w = T(0);
        if (q >= 0 && q <= N_f - 2 && (kGrad || row > 0)) {
            const T* x0 = sx + (size_t)row * D;
            const T r = onestep_residual<T, Model, kDisc>(x0, x0 + D, d, D,
                                                          p, hc);
            if constexpr (kDiag) {
                w = rf[(size_t)q * D + d] * r;
                if (row > 0) acc[NV - 1] += w * r;
            } else {
                w = rf_s * r;
                if (row > 0) acc[NV - 1] += r * r;
            }
            if (kGrad && row > 0) acc[0] += w;
        }
        if constexpr (kGrad) wr[j] = w;
    }
    if constexpr (kGrad) {
        // Jᵀv reads every wr row at other components: one block barrier
        __syncthreads();
        T* gxb = gx + (size_t)blockIdx.y * N_f * D + (size_t)m0 * D;
        for (int j = threadIdx.x; j < nm * D; j += blockDim.x) {
            const int row = j / D, e = j - row * D;
            const T* wp = wr + (size_t)row * D;       // wr_{m-1}
            const T* wc = wp + D;                      // wr_m
            const auto v = [wp, wc, c0, c1](int k) {
                return c0 * wp[k] + c1 * wc[k];
            };
            gxb[j] = wp[e] - a1 * wc[e]
                     - Model::jtv(sx + (size_t)(row + 1) * D, v, e, D, p);
        }
    }
    block_reduce<T, NV>(acc, red, [&](int j, T s) {
        if (kGrad && j < NP) {
            gp[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = -(c0 + c1) * s;
        } else {
            partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] =
                kDiag ? s : rf_s * s;
        }
    });
}

// Rows of a one-step warp of a row-level model: its 32 lanes hold the
// nodes m - 1 .. m + 30 of its rows m .. m + 29, the two ends being the
// halo nodes its residuals read.
constexpr int kWarpRows = 30;

// Row-level model (NaKL, Colpitts, Lorenz-63): warp w of the block owns
// rows [m0 + 30 w, m0 + 30 w + 30) of the block's, and lane l node
// k = m0 + 30 w - 1 + l.
// A lane loads its row of x and its current, evaluates its node once
// (Model::node: f and what the adjoint reuses), takes x and f of node
// k + 1 from the next lane to form residual k and wr_k, and wr_{k-1} from
// the previous lane to form v_k, Jᵀv and the parameter adjoint of its
// row: shuffles, no shared row and no barrier but the one after the
// parameter row is staged. The value-only launch computes the same
// residuals in the same order.
template <typename T, typename Model, int kDisc, bool kDiag, bool kGrad>
__device__ __forceinline__ void onestep_rows(
        const T* __restrict__ X, long long x_bs, const T* __restrict__ P,
        long long p_bs, const T* __restrict__ stim,
        const T* __restrict__ rf, T rf_s, int N_f, T hc, T a1, T c0, T c1,
        int bn, T* __restrict__ gx, T* __restrict__ gp,
        T* __restrict__ partials) {
    constexpr int D = Model::kD, NP = Model::kNP;
    constexpr int NV = kGrad ? NP + 1 : 1;
    constexpr unsigned kAll = 0xffffffffu;
    using Node = typename Model::template Node<T>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nw = blockDim.x >> 5;
    T* red = reinterpret_cast<T*>(smem_raw);           // nw * (NP + 1)
    T* sp = red + (size_t)nw * (NP + 1);               // kNPX
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int m0 = blockIdx.x * bn;
    const int w0 = m0 + kWarpRows * warp;              // the warp's rows
    const int w1 = min(w0 + kWarpRows, m0 + min(bn, N_f - m0));
    const T* prow = P + (size_t)blockIdx.y * p_bs;
    for (int j = threadIdx.x; j < Model::kNPX; j += blockDim.x) {
        sp[j] = Model::param(prow, j);
    }
    const int k = w0 - 1 + lane;                       // the lane's node
    const bool on = k >= 0 && k < N_f;
    const T* xk = X + (size_t)blockIdx.y * x_bs + (long long)k * D;
    T x[D];
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = on ? xk[d] : T(0);
    const T I = stim && on ? stim[k] : T(0);
    __syncthreads();                                   // sp staged
    Node nd;
    Model::node(x, sp, I, nd);
    // residual k from node k + 1, the next lane's
    const bool res = lane < 31 && k >= 0 && k <= N_f - 2;
    const bool own = lane >= 1 && k < w1;              // row k is ours
    T acc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = T(0);
    T wr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        const T x1 = __shfl_down_sync(kAll, x[d], 1);
        const T f1 = __shfl_down_sync(kAll, nd.f[d], 1);
        T w = T(0);
        if (res) {
            const T r = step_residual<T, kDisc>(x[d], x1, nd.f[d], f1, hc);
            if constexpr (kDiag) {
                w = rf[(size_t)k * D + d] * r;
                if (own) acc[NV - 1] += w * r;
            } else {
                w = rf_s * r;
                if (own) acc[NV - 1] += r * r;
            }
        }
        wr[d] = w;
    }
    if constexpr (kGrad) {
        T wp[D], v[D], jt[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
            wp[d] = __shfl_up_sync(kAll, wr[d], 1);    // wr_{k-1}
            v[d] = c0 * wp[d] + c1 * wr[d];
        }
        if (own) {
            Model::adjoint(x, sp, nd, v, jt, acc);
            T* out = gx + ((size_t)blockIdx.y * N_f + k) * D;
#pragma unroll
            for (int d = 0; d < D; ++d) out[d] = wp[d] - a1 * wr[d] - jt[d];
        }
    }
    block_reduce<T, NV>(acc, red, [&](int j, T s) {
        if (kGrad && j < NP) {
            gp[((size_t)blockIdx.y * NP + j) * gridDim.x + blockIdx.x] = -s;
        } else {
            partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] =
                kDiag ? s : rf_s * s;
        }
    });
}

template <typename T, typename Model, int kDisc, bool kDiag, bool kGrad>
__device__ __forceinline__ void onestep_block(
        const T* X, long long x_bs, const T* P, long long p_bs,
        const T* stim, const T* rf, T rf_s, int N_f, int D, T hc, T a1,
        T c0, T c1, int bn, T* gx, T* gp, T* partials) {
    if constexpr (Model::kRow) {
        onestep_rows<T, Model, kDisc, kDiag, kGrad>(
            X, x_bs, P, p_bs, stim, rf, rf_s, N_f, hc, a1, c0, c1, bn, gx,
            gp, partials);
    } else {
        onestep_pairs<T, Model, kDisc, kDiag, kGrad>(
            X, x_bs, P, p_bs, rf, rf_s, N_f, D, hc, a1, c0, c1, bn, gx, gp,
            partials);
    }
}

// K6a: the value's block partials rf · Σ r² or Σ rf ⊙ r².
template <typename T, typename Model, int kDisc, bool kDiag>
__global__ void __launch_bounds__(Model::kMaxThreads) fe_onestep_fwd(
        const T* __restrict__ X, long long x_bs, const T* __restrict__ P,
        long long p_bs, const T* __restrict__ stim,
        const T* __restrict__ rf, T rf_s, int N_f, int D, T hc, int bn,
        T* __restrict__ partials) {
    onestep_block<T, Model, kDisc, kDiag, false>(
        X, x_bs, P, p_bs, stim, rf, rf_s, N_f, D, hc, T(0), T(0), T(0), bn,
        nullptr, nullptr, partials);
}

// K6b with K6a's value in one launch: the value's block partials, the
// gradient rows and the parameters' block partials.
template <typename T, typename Model, int kDisc, bool kDiag>
__global__ void __launch_bounds__(Model::kMaxThreads) fe_onestep_vag(
        const T* __restrict__ X, long long x_bs, const T* __restrict__ P,
        long long p_bs, const T* __restrict__ stim,
        const T* __restrict__ rf, T rf_s, int N_f, int D, T hc, T a1, T c0,
        T c1, int bn, T* __restrict__ gx, T* __restrict__ gp,
        T* __restrict__ partials) {
    onestep_block<T, Model, kDisc, kDiag, true>(
        X, x_bs, P, p_bs, stim, rf, rf_s, N_f, D, hc, a1, c0, c1, bn, gx, gp,
        partials);
}

// Opt in to more than 48 KB of dynamic shared memory where needed (a
// launch above 48 KB without it is refused and never runs), then launch.
template <typename K, typename... Args>
int launch(K kernel, int n_blocks, int B, int threads, size_t smem,
           void* stream, Args... args) {
    if (smem > 48 * 1024) {
        // a refusal's error read back, so that the next launch does not
        // report it again
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
    }
    kernel<<<dim3(n_blocks, B), threads, smem, (cudaStream_t)stream>>>(
        args...);
    return (int)cudaGetLastError();
}

constexpr int kBadArg = (int)cudaErrorInvalidValue;

// Whether a block may run ``threads``: whole warps, at most the kernel's
// launch bound.
template <typename Model>
bool threads_ok(int threads) {
    return threads >= 32 && threads % 32 == 0
           && threads <= Model::kMaxThreads;
}

template <typename T, typename Model, int kDisc, bool kDiag>
int onestep_fwd(const void* X, long long x_bs, const void* P, long long p_bs,
                const void* stim, const void* rf, double rf_s, int B,
                int N_f, int D, double hc, int bn, int threads,
                void* partials, void* stream) {
    if (!threads_ok<Model>(threads)) return kBadArg;
    return launch(fe_onestep_fwd<T, Model, kDisc, kDiag>,
                  (N_f + bn - 1) / bn, B, threads,
                  onestep_smem_vals<Model>(bn, D, threads / 32) * sizeof(T),
                  stream, static_cast<const T*>(X), x_bs,
                  static_cast<const T*>(P), p_bs,
                  static_cast<const T*>(stim), static_cast<const T*>(rf),
                  (T)rf_s, N_f, D, (T)hc, bn, static_cast<T*>(partials));
}

template <typename T, typename Model, int kDisc, bool kDiag>
int onestep_vag(const void* X, long long x_bs, const void* P, long long p_bs,
                const void* stim, const void* rf, double rf_s, int B,
                int N_f, int D, double hc, double a1, double c0, double c1,
                int bn, int threads, void* gx, void* gp, void* partials,
                void* stream) {
    if (!threads_ok<Model>(threads)) return kBadArg;
    return launch(fe_onestep_vag<T, Model, kDisc, kDiag>,
                  (N_f + bn - 1) / bn, B, threads,
                  onestep_smem_vals<Model>(bn, D, threads / 32) * sizeof(T),
                  stream, static_cast<const T*>(X), x_bs,
                  static_cast<const T*>(P), p_bs,
                  static_cast<const T*>(stim), static_cast<const T*>(rf),
                  (T)rf_s, N_f, D, (T)hc, (T)a1, (T)c0, (T)c1, bn,
                  static_cast<T*>(gx), static_cast<T*>(gp),
                  static_cast<T*>(partials));
}

template <typename T, typename Model, bool kDiag>
int sh_fwd(const void* X, long long x_bs, const void* P, long long p_bs,
           const void* stim, const void* rf, double rf_s, int B, int M,
           int D, double h6, double h8, int bk, int threads, void* partials,
           void* stream) {
    if (!threads_ok<Model>(threads)) return kBadArg;
    return launch(fe_sh_fwd<T, Model, kDiag>, (M + bk - 1) / bk, B, threads,
                  sh_smem_vals<Model>(false, bk, D, threads / 32)
                      * sizeof(T),
                  stream, static_cast<const T*>(X), x_bs,
                  static_cast<const T*>(P), p_bs,
                  static_cast<const T*>(stim), static_cast<const T*>(rf),
                  (T)rf_s, M, D, (T)h6, (T)h8, bk,
                  static_cast<T*>(partials));
}

template <typename T, typename Model, bool kDiag>
int sh_vag(const void* X, long long x_bs, const void* P, long long p_bs,
           const void* stim, const void* rf, double rf_s, int B, int M,
           int D, double h6, double h8, double h46, int bk, int threads,
           void* ge0, void* gm, void* ge1, void* gp, void* partials,
           void* stream) {
    if (!threads_ok<Model>(threads)) return kBadArg;
    return launch(fe_sh_vag<T, Model, kDiag>, (M + bk - 1) / bk, B, threads,
                  sh_smem_vals<Model>(true, bk, D, threads / 32) * sizeof(T),
                  stream, static_cast<const T*>(X), x_bs,
                  static_cast<const T*>(P), p_bs,
                  static_cast<const T*>(stim), static_cast<const T*>(rf),
                  (T)rf_s, M, D, (T)h6, (T)h8, (T)h46, bk,
                  static_cast<T*>(ge0), static_cast<T*>(gm),
                  static_cast<T*>(ge1), static_cast<T*>(gp),
                  static_cast<T*>(partials));
}

// The (model, disc, rf form) instantiation a call names; kBadArg for an
// unknown code.
#define VA_MODELS(CALL)                                                     \
    switch (model) {                                                        \
        case kL96: CALL(L96);                                               \
        case kNaKL: CALL(NaKL);                                             \
        case kColpitts: CALL(Colpitts);                                     \
        case kL63: CALL(L63);                                               \
        default: return kBadArg;                                            \
    }

template <typename T, typename Model>
int onestep_fwd_disc(int disc, int diag, const void* X, long long x_bs,
                     const void* P, long long p_bs, const void* stim,
                     const void* rf, double rf_s, int B, int N_f, int D,
                     double hc, int bn, int threads, void* partials,
                     void* stream) {
#define VA_FWD(DISC, DIAG)                                                  \
    return onestep_fwd<T, Model, DISC, DIAG>(X, x_bs, P, p_bs, stim, rf,    \
                                             rf_s, B, N_f, D, hc, bn,       \
                                             threads, partials, stream)
    switch (disc * 2 + (diag ? 1 : 0)) {
        case kEuler * 2: VA_FWD(kEuler, false);
        case kEuler * 2 + 1: VA_FWD(kEuler, true);
        case kTrapezoid * 2: VA_FWD(kTrapezoid, false);
        case kTrapezoid * 2 + 1: VA_FWD(kTrapezoid, true);
        case kForwardmap * 2: VA_FWD(kForwardmap, false);
        case kForwardmap * 2 + 1: VA_FWD(kForwardmap, true);
        default: return kBadArg;
    }
#undef VA_FWD
}

template <typename T, typename Model>
int onestep_vag_disc(int disc, int diag, const void* X, long long x_bs,
                     const void* P, long long p_bs, const void* stim,
                     const void* rf, double rf_s, int B, int N_f, int D,
                     double hc, double a1, double c0, double c1, int bn,
                     int threads, void* gx, void* gp, void* partials,
                     void* stream) {
#define VA_VAG(DISC, DIAG)                                                  \
    return onestep_vag<T, Model, DISC, DIAG>(X, x_bs, P, p_bs, stim, rf,    \
                                             rf_s, B, N_f, D, hc, a1, c0,   \
                                             c1, bn, threads, gx, gp,       \
                                             partials, stream)
    switch (disc * 2 + (diag ? 1 : 0)) {
        case kEuler * 2: VA_VAG(kEuler, false);
        case kEuler * 2 + 1: VA_VAG(kEuler, true);
        case kTrapezoid * 2: VA_VAG(kTrapezoid, false);
        case kTrapezoid * 2 + 1: VA_VAG(kTrapezoid, true);
        case kForwardmap * 2: VA_VAG(kForwardmap, false);
        case kForwardmap * 2 + 1: VA_VAG(kForwardmap, true);
        default: return kBadArg;
    }
#undef VA_VAG
}

template <typename T>
int onestep_fwd_any(int model, int disc, int diag, const void* X,
                    long long x_bs, const void* P, long long p_bs,
                    const void* stim, const void* rf, double rf_s, int B,
                    int N_f, int D, double hc, int bn, int threads,
                    void* partials, void* stream) {
#define VA_CALL(M)                                                          \
    return onestep_fwd_disc<T, M>(disc, diag, X, x_bs, P, p_bs, stim, rf,   \
                                  rf_s, B, N_f, D, hc, bn, threads,         \
                                  partials, stream)
    VA_MODELS(VA_CALL)
#undef VA_CALL
}

template <typename T>
int onestep_vag_any(int model, int disc, int diag, const void* X,
                    long long x_bs, const void* P, long long p_bs,
                    const void* stim, const void* rf, double rf_s, int B,
                    int N_f, int D, double hc, double a1, double c0,
                    double c1, int bn, int threads, void* gx, void* gp,
                    void* partials, void* stream) {
#define VA_CALL(M)                                                          \
    return onestep_vag_disc<T, M>(disc, diag, X, x_bs, P, p_bs, stim, rf,   \
                                  rf_s, B, N_f, D, hc, a1, c0, c1, bn,      \
                                  threads, gx, gp, partials, stream)
    VA_MODELS(VA_CALL)
#undef VA_CALL
}

template <typename T>
int sh_fwd_any(int model, int diag, const void* X, long long x_bs,
               const void* P, long long p_bs, const void* stim,
               const void* rf, double rf_s, int B, int M, int D, double h6,
               double h8, int bk, int threads, void* partials,
               void* stream) {
#define VA_CALL(M_)                                                         \
    return diag ? sh_fwd<T, M_, true>(X, x_bs, P, p_bs, stim, rf, rf_s, B,  \
                                      M, D, h6, h8, bk, threads, partials,  \
                                      stream)                               \
                : sh_fwd<T, M_, false>(X, x_bs, P, p_bs, stim, rf, rf_s, B, \
                                       M, D, h6, h8, bk, threads, partials, \
                                       stream)
    VA_MODELS(VA_CALL)
#undef VA_CALL
}

template <typename T>
int sh_vag_any(int model, int diag, const void* X, long long x_bs,
               const void* P, long long p_bs, const void* stim,
               const void* rf, double rf_s, int B, int M, int D, double h6,
               double h8, double h46, int bk, int threads, void* ge0,
               void* gm, void* ge1, void* gp, void* partials, void* stream) {
#define VA_CALL(M_)                                                         \
    return diag ? sh_vag<T, M_, true>(X, x_bs, P, p_bs, stim, rf, rf_s, B,  \
                                      M, D, h6, h8, h46, bk, threads, ge0,  \
                                      gm, ge1, gp, partials, stream)        \
                : sh_vag<T, M_, false>(X, x_bs, P, p_bs, stim, rf, rf_s, B, \
                                       M, D, h6, h8, h46, bk, threads, ge0, \
                                       gm, ge1, gp, partials, stream)
    VA_MODELS(VA_CALL)
#undef VA_CALL
}

#undef VA_MODELS

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess). Pointers
// are device pointers. model: 0 Lorenz-96 (1 parameter), 1 NaKL (D = 4,
// 19 parameters), 2 Colpitts (D = 3, 4 parameters), 3 Lorenz-63 (D = 3,
// 3 parameters). X: member b's (N_f, D) state rows start at X + b·x_bs,
// rows contiguous; P: member b's full (linear) parameter row at P + b·p_bs
// (p_bs = 0: one row for every member); stim: the (N_f,) injected current
// on the model grid, or null (NaKL only; the other models ignore it); rf:
// (N_f - 1, D) contiguous for diag = 1, else null and rf_s the scalar.
// disc: 0 euler, 1 trapezoid, 2 forwardmap. bn (bk): rows (intervals) a
// block, ``threads`` a block (whole warps, at most the model's launch
// bound; kBadArg otherwise); the wrapper sizes the outputs for
// ceil(rows / bn) blocks (rows: N_f for a one-step disc, M under
// Hermite–Simpson), gp as (B, NP, blocks).

int va_fe_onestep_fwd_f32(int model, int disc, int diag, const void* X,
                          long long x_bs, const void* P, long long p_bs,
                          const void* stim, const void* rf, double rf_s,
                          int B, int N_f, int D, double hc, int bn,
                          int threads, void* partials, void* stream) {
    return onestep_fwd_any<float>(model, disc, diag, X, x_bs, P, p_bs, stim,
                                  rf, rf_s, B, N_f, D, hc, bn, threads,
                                  partials, stream);
}

int va_fe_onestep_fwd_f64(int model, int disc, int diag, const void* X,
                          long long x_bs, const void* P, long long p_bs,
                          const void* stim, const void* rf, double rf_s,
                          int B, int N_f, int D, double hc, int bn,
                          int threads, void* partials, void* stream) {
    return onestep_fwd_any<double>(model, disc, diag, X, x_bs, P, p_bs,
                                   stim, rf, rf_s, B, N_f, D, hc, bn,
                                   threads, partials, stream);
}

// The fused launch (fe_onestep_vag): gx (B, N_f, D), the parameters'
// block partials (B, NP, blocks) and the value's block partials (B,
// blocks), as va_fe_onestep_fwd's.
int va_fe_onestep_vag_f32(int model, int disc, int diag, const void* X,
                          long long x_bs, const void* P, long long p_bs,
                          const void* stim, const void* rf, double rf_s,
                          int B, int N_f, int D, double hc, double a1,
                          double c0, double c1, int bn, int threads,
                          void* gx, void* gp, void* partials, void* stream) {
    return onestep_vag_any<float>(model, disc, diag, X, x_bs, P, p_bs, stim,
                                  rf, rf_s, B, N_f, D, hc, a1, c0, c1, bn,
                                  threads, gx, gp, partials, stream);
}

int va_fe_onestep_vag_f64(int model, int disc, int diag, const void* X,
                          long long x_bs, const void* P, long long p_bs,
                          const void* stim, const void* rf, double rf_s,
                          int B, int N_f, int D, double hc, double a1,
                          double c0, double c1, int bn, int threads,
                          void* gx, void* gp, void* partials, void* stream) {
    return onestep_vag_any<double>(model, disc, diag, X, x_bs, P, p_bs,
                                   stim, rf, rf_s, B, N_f, D, hc, a1, c0, c1,
                                   bn, threads, gx, gp, partials, stream);
}

// Hermite–Simpson.
int va_fe_sh_fwd_f32(int model, int diag, const void* X, long long x_bs,
                     const void* P, long long p_bs, const void* stim,
                     const void* rf, double rf_s, int B, int M, int D,
                     double h6, double h8, int bk, int threads,
                     void* partials, void* stream) {
    return sh_fwd_any<float>(model, diag, X, x_bs, P, p_bs, stim, rf, rf_s,
                             B, M, D, h6, h8, bk, threads, partials, stream);
}

int va_fe_sh_fwd_f64(int model, int diag, const void* X, long long x_bs,
                     const void* P, long long p_bs, const void* stim,
                     const void* rf, double rf_s, int B, int M, int D,
                     double h6, double h8, int bk, int threads,
                     void* partials, void* stream) {
    return sh_fwd_any<double>(model, diag, X, x_bs, P, p_bs, stim, rf, rf_s,
                              B, M, D, h6, h8, bk, threads, partials,
                              stream);
}

// The fused launch (fe_sh_vag): the triplet (B, M, D) each, the
// parameters' block partials (B, NP, blocks) and the value's block
// partials (B, blocks), as va_fe_sh_fwd's.
int va_fe_sh_vag_f32(int model, int diag, const void* X, long long x_bs,
                     const void* P, long long p_bs, const void* stim,
                     const void* rf, double rf_s, int B, int M, int D,
                     double h6, double h8, double h46, int bk, int threads,
                     void* ge0, void* gm, void* ge1, void* gp,
                     void* partials, void* stream) {
    return sh_vag_any<float>(model, diag, X, x_bs, P, p_bs, stim, rf, rf_s,
                             B, M, D, h6, h8, h46, bk, threads, ge0, gm, ge1,
                             gp, partials, stream);
}

int va_fe_sh_vag_f64(int model, int diag, const void* X, long long x_bs,
                     const void* P, long long p_bs, const void* stim,
                     const void* rf, double rf_s, int B, int M, int D,
                     double h6, double h8, double h46, int bk, int threads,
                     void* ge0, void* gm, void* ge1, void* gp,
                     void* partials, void* stream) {
    return sh_vag_any<double>(model, diag, X, x_bs, P, p_bs, stim, rf, rf_s,
                              B, M, D, h6, h8, h46, bk, threads, ge0, gm,
                              ge1, gp, partials, stream);
}

const char* va_fe_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
