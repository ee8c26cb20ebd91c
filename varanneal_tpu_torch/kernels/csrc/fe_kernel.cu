// K6 on Hopper: the time-blocked model-error (FE) kernels, forward and
// hand-written adjoint, for the one-step discretizations and for
// Hermite–Simpson, over a (member, time block) grid.
//
// Replaces varanneal_tpu/kernels/fe_pallas.py's seven pallas_call sites:
//
//   fe_onestep_fwd  <- _kern_scalar (:138, call :384) and _kern_diag
//                      (:156, call :396): kDiagRf picks the rf form;
//   fe_onestep_bwd  <- _kern_bwd (:187, call :450);
//   fe_sh_fwd       <- _kern_sh_fwd (:238, call :632) and the batched-grid
//                      _kern_sh_fwd_b (:472, call :718);
//   fe_sh_bwd       <- _kern_sh_bwd (:260, call :648) and _kern_sh_bwd_b
//                      (:502, call :735).
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
//                           gF partial = -Σ v  (∂f_d/∂F = 1)
//   Hermite–Simpson         S = x_{2k+2} - x_{2k} - (h/6)(f0 + 4 fm + f1),
//                           H = x_{2k+1} - (x_{2k} + x_{2k+2})/2
//                               - (h/8)(f0 - f1),
//                           partial Σ ws S² + wh H², and the triplet
//                           g_e0 = -WS - WH/2 + J0ᵀ v0, g_m = WH + Jmᵀ vm,
//                           g_e1 = WS - WH/2 + J1ᵀ v1 (WS = ws S,
//                           WH = wh H, v0 = -(h/6)WS - (h/8)WH,
//                           vm = -(4h/6)WS, v1 = -(h/6)WS + (h/8)WH),
//                           gF partial = Σ (v0 + vm + v1).
//
// The wrapper (kernels/fe.py) sums the partials over blocks and scales
// them, and joins the Hermite–Simpson triplet into the gradient by node
// with one shift-add (g_even[j] = g_e0[j] + g_e1[j-1]), as the reference
// does: an even node is shared by two intervals that may lie in two
// blocks, so writing the triplet keeps the kernel free of races.
//
// What bounds it on the card: each kernel reads X once (N_f·D values a
// member) plus rf, and writes a partial a block (forward) or the gradient
// (backward); ~15-60 operations an entry. At BASELINE config #2 (D=100,
// N_f=241, one member) that is ~100-300 KB and ~1 MFLOP a launch: well
// under a microsecond at the card's rates, below the few microseconds a
// launch costs. So the kernels are bound by launch latency and by the
// serial depth of one block (stage, one or two passes, one reduction);
// with few members most SMs are idle. The design keeps every pass a
// strided loop over the block's (row, component) pairs with the model
// evaluated from shared memory, and one fixed-order reduction (a warp
// shuffle tree, then thread 0 over the warps in order; no atomics), so
// repeated launches give bit-identical results.
//
// The model is a template parameter with f, the transposed Jacobian
// product and the parameter adjoint written by hand (no autodiff on the
// card); L96 uses l96_ag.cuh's functions unchanged.

#include <cuda_runtime.h>

#include "l96_ag.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Disc { kEuler = 0, kTrapezoid = 1, kForwardmap = 2 };

// Lorenz-96 with p = [F]: ∂f_d/∂F = 1, so F's adjoint is Σ_d v_d.
struct L96 {
    template <typename T>
    __device__ static T f(const T* x, int d, int D, T F) {
        return l96_f(x, d, D, F);
    }
    template <typename T, typename V>
    __device__ static T jtv(const T* x, const V& v, int e, int D) {
        return l96_jtv(x, v, e, D);
    }
    template <typename T>
    __device__ static T pbar_term(T v_d) { return v_d; }
};

// Block-wide sum in a fixed order: a warp shuffle tree, then thread 0
// adds the warps' sums in order. The result is valid on thread 0.
template <typename T>
__device__ T block_sum(T v, T* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    T s = T(0);
    if (threadIdx.x == 0) {
        for (int w = 0; w < kWarps; ++w) s += red[w];
    }
    return s;
}

template <typename T>
__device__ __forceinline__ T param_F(const T* pest, long long p_bs,
                                     T F_fixed) {
    return pest ? pest[(size_t)blockIdx.y * p_bs] : F_fixed;
}

// One-step residual of component d from rows x0 = x_n, x1 = x_{n+1}; hc is
// h/2 (trapezoid), h (euler), unused (forwardmap).
template <typename T, typename Model, int kDisc>
__device__ __forceinline__ T onestep_residual(const T* x0, const T* x1,
                                              int d, int D, T F, T hc) {
    const T f0 = Model::f(x0, d, D, F);
    if constexpr (kDisc == kTrapezoid) {
        return x1[d] - x0[d] - hc * (f0 + Model::f(x1, d, D, F));
    } else if constexpr (kDisc == kEuler) {
        return x1[d] - x0[d] - hc * f0;
    } else {
        return x1[d] - f0;
    }
}

// Hermite–Simpson residual pair of component d on one interval (rows
// xe0, xm = xe0 + D, xe1 = xe0 + 2D).
template <typename T, typename Model>
__device__ __forceinline__ void sh_residuals(const T* xe0, int d, int D,
                                             T F, T h6, T h8, T* S, T* H) {
    const T* xm = xe0 + D;
    const T* xe1 = xm + D;
    const T f0 = Model::f(xe0, d, D, F);
    const T fm = Model::f(xm, d, D, F);
    const T f1 = Model::f(xe1, d, D, F);
    *S = xe1[d] - xe0[d] - h6 * (f0 + T(4) * fm + f1);
    *H = xm[d] - T(0.5) * (xe0[d] + xe1[d]) - h8 * (f0 - f1);
}

// K6a. Block i of member b: residual rows [i·bn, min(i·bn + bn, N_f - 1)),
// staged rows i·bn .. i·bn + nr (nr + 1 rows). partials: (B, gridDim.x).
template <typename T, typename Model, int kDisc, bool kDiagRf>
__global__ void __launch_bounds__(kThreads) fe_onestep_fwd(
        const T* __restrict__ X, long long x_bs, const T* __restrict__ pest,
        long long p_bs, T F_fixed, const T* __restrict__ rf, T rf_s,
        int N_f, int D, T hc, int bn, T* __restrict__ partials) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sx = reinterpret_cast<T*>(smem_raw);           // (bn + 1) * D
    T* red = sx + (size_t)(bn + 1) * D;                // kWarps
    const int r0 = blockIdx.x * bn;
    const int nr = min(bn, N_f - 1 - r0);
    const T F = param_F(pest, p_bs, F_fixed);
    const T* xb = X + (size_t)blockIdx.y * x_bs + (size_t)r0 * D;
    for (int j = threadIdx.x; j < (nr + 1) * D; j += kThreads) sx[j] = xb[j];
    __syncthreads();
    T acc = T(0);
    for (int j = threadIdx.x; j < nr * D; j += kThreads) {
        const int row = j / D, d = j - row * D;
        const T* x0 = sx + (size_t)row * D;
        const T r = onestep_residual<T, Model, kDisc>(x0, x0 + D, d, D, F,
                                                      hc);
        if constexpr (kDiagRf) {
            acc += rf[(size_t)r0 * D + j] * r * r;
        } else {
            acc += r * r;
        }
    }
    const T s = block_sum(acc, red);
    if (threadIdx.x == 0) {
        partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] =
            kDiagRf ? s : rf_s * s;
    }
}

// K6b. Block i of member b: gradient rows m in [m0, m0 + nm), m0 = i·bn.
// Shared memory holds x rows m0 - 1 .. m0 + nm (row j <-> x_{m0-1+j}),
// wr rows (row j <-> w r of residual m0 - 1 + j, zero outside
// 0 .. N_f - 2) and v rows (row j <-> v_{m0+j}). gx: (B, N_f, D)
// contiguous; gp: (B, gridDim.x), the block's partial -Σ v.
template <typename T, typename Model, int kDisc, bool kDiagRf>
__global__ void __launch_bounds__(kThreads) fe_onestep_bwd(
        const T* __restrict__ X, long long x_bs, const T* __restrict__ pest,
        long long p_bs, T F_fixed, const T* __restrict__ rf, T rf_s,
        int N_f, int D, T hc, T a1, T c0, T c1, int bn,
        T* __restrict__ gx, T* __restrict__ gp) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sx = reinterpret_cast<T*>(smem_raw);           // (bn + 2) * D
    T* wr = sx + (size_t)(bn + 2) * D;                 // (bn + 1) * D
    T* sv = wr + (size_t)(bn + 1) * D;                 // bn * D
    T* red = sv + (size_t)bn * D;                      // kWarps
    const int m0 = blockIdx.x * bn;
    const int nm = min(bn, N_f - m0);
    const T F = param_F(pest, p_bs, F_fixed);
    const T* xb = X + (size_t)blockIdx.y * x_bs;
    for (int j = threadIdx.x; j < (nm + 2) * D; j += kThreads) {
        const int row = m0 - 1 + j / D;
        if (row >= 0 && row < N_f) sx[j] = xb[(long long)(m0 - 1) * D + j];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < (nm + 1) * D; j += kThreads) {
        const int row = j / D, d = j - row * D;
        const int q = m0 - 1 + row;                    // residual row
        T w = T(0);
        if (q >= 0 && q <= N_f - 2) {
            const T* x0 = sx + (size_t)row * D;
            const T r = onestep_residual<T, Model, kDisc>(x0, x0 + D, d, D,
                                                          F, hc);
            w = (kDiagRf ? rf[(size_t)q * D + d] : rf_s) * r;
        }
        wr[j] = w;
    }
    __syncthreads();
    T acc = T(0);
    for (int j = threadIdx.x; j < nm * D; j += kThreads) {
        const T v = c0 * wr[j] + c1 * wr[j + D];
        sv[j] = v;
        acc += Model::pbar_term(v);
    }
    // every row's v is read at other components by Jᵀv: a block barrier
    __syncthreads();
    T* gxb = gx + (size_t)blockIdx.y * N_f * D + (size_t)m0 * D;
    for (int j = threadIdx.x; j < nm * D; j += kThreads) {
        const int row = j / D, e = j - row * D;
        const T* vrow = sv + (size_t)row * D;
        const T jt = Model::jtv(sx + (size_t)(row + 1) * D,
                                [vrow](int k) { return vrow[k]; }, e, D);
        gxb[j] = wr[j] - a1 * wr[j + D] - jt;
    }
    const T s = block_sum(acc, red);
    if (threadIdx.x == 0) {
        gp[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = -s;
    }
}

// K6c/K6d forward. Block i of member b: intervals [k0, k0 + nk), k0 = i·bk,
// staged rows 2k0 .. 2k0 + 2nk. rf (diagonal form): (N_f - 1, D) rows, ws =
// row 2k, wh = row 2k + 1. partials: (B, gridDim.x).
template <typename T, typename Model, bool kDiagRf>
__global__ void __launch_bounds__(kThreads) fe_sh_fwd(
        const T* __restrict__ X, long long x_bs, const T* __restrict__ pest,
        long long p_bs, T F_fixed, const T* __restrict__ rf, T rf_s, int M,
        int D, T h6, T h8, int bk, T* __restrict__ partials) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sx = reinterpret_cast<T*>(smem_raw);           // (2 bk + 1) * D
    T* red = sx + (size_t)(2 * bk + 1) * D;            // kWarps
    const int k0 = blockIdx.x * bk;
    const int nk = min(bk, M - k0);
    const T F = param_F(pest, p_bs, F_fixed);
    const T* xb = X + (size_t)blockIdx.y * x_bs + (size_t)2 * k0 * D;
    for (int j = threadIdx.x; j < (2 * nk + 1) * D; j += kThreads) {
        sx[j] = xb[j];
    }
    __syncthreads();
    T acc = T(0);
    for (int j = threadIdx.x; j < nk * D; j += kThreads) {
        const int kk = j / D, d = j - kk * D;
        T S, H;
        sh_residuals<T, Model>(sx + (size_t)2 * kk * D, d, D, F, h6, h8, &S,
                               &H);
        T ws = rf_s, wh = rf_s;
        if constexpr (kDiagRf) {
            const size_t at = (size_t)2 * (k0 + kk) * D + d;
            ws = rf[at];
            wh = rf[at + D];
        }
        acc += ws * S * S + wh * H * H;
    }
    const T s = block_sum(acc, red);
    if (threadIdx.x == 0) {
        partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
    }
}

// K6c/K6d backward: the triplet (g_e0, g_m, g_e1), each (B, M, D)
// contiguous, and gp (B, gridDim.x), the block's partial Σ (v0 + vm + v1).
// Pass 1 writes v0, vm, v1 to shared memory; pass 2, after a block
// barrier (Jᵀv reads v at other components), recomputes S and H from the
// staged rows and forms the triplet.
template <typename T, typename Model, bool kDiagRf>
__global__ void __launch_bounds__(kThreads) fe_sh_bwd(
        const T* __restrict__ X, long long x_bs, const T* __restrict__ pest,
        long long p_bs, T F_fixed, const T* __restrict__ rf, T rf_s, int M,
        int D, T h6, T h8, T h46, int bk, T* __restrict__ ge0,
        T* __restrict__ gm, T* __restrict__ ge1, T* __restrict__ gp) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sx = reinterpret_cast<T*>(smem_raw);           // (2 bk + 1) * D
    T* v0 = sx + (size_t)(2 * bk + 1) * D;             // bk * D each
    T* vm = v0 + (size_t)bk * D;
    T* v1 = vm + (size_t)bk * D;
    T* red = v1 + (size_t)bk * D;                      // kWarps
    const int k0 = blockIdx.x * bk;
    const int nk = min(bk, M - k0);
    const T F = param_F(pest, p_bs, F_fixed);
    const T* xb = X + (size_t)blockIdx.y * x_bs + (size_t)2 * k0 * D;
    for (int j = threadIdx.x; j < (2 * nk + 1) * D; j += kThreads) {
        sx[j] = xb[j];
    }
    __syncthreads();
    auto weights = [&](int kk, int d, T* ws, T* wh) {
        *ws = rf_s;
        *wh = rf_s;
        if constexpr (kDiagRf) {
            const size_t at = (size_t)2 * (k0 + kk) * D + d;
            *ws = rf[at];
            *wh = rf[at + D];
        }
    };
    T acc = T(0);
    for (int j = threadIdx.x; j < nk * D; j += kThreads) {
        const int kk = j / D, d = j - kk * D;
        T S, H, ws, wh;
        sh_residuals<T, Model>(sx + (size_t)2 * kk * D, d, D, F, h6, h8, &S,
                               &H);
        weights(kk, d, &ws, &wh);
        const T WS = ws * S, WH = wh * H;
        const T a = -h6 * WS - h8 * WH;
        const T b = -h46 * WS;
        const T c = -h6 * WS + h8 * WH;
        v0[j] = a;
        vm[j] = b;
        v1[j] = c;
        acc += Model::pbar_term(a) + Model::pbar_term(b) + Model::pbar_term(c);
    }
    __syncthreads();
    const size_t out0 = (size_t)blockIdx.y * M * D + (size_t)k0 * D;
    for (int j = threadIdx.x; j < nk * D; j += kThreads) {
        const int kk = j / D, e = j - kk * D;
        const T* xe0 = sx + (size_t)2 * kk * D;
        T S, H, ws, wh;
        sh_residuals<T, Model>(xe0, e, D, F, h6, h8, &S, &H);
        weights(kk, e, &ws, &wh);
        const T WS = ws * S, WH = wh * H;
        const T* r0 = v0 + (size_t)kk * D;
        const T* rm = vm + (size_t)kk * D;
        const T* r1 = v1 + (size_t)kk * D;
        ge0[out0 + j] = -WS - T(0.5) * WH
                        + Model::jtv(xe0, [r0](int k) { return r0[k]; }, e, D);
        gm[out0 + j] = WH + Model::jtv(xe0 + D, [rm](int k) { return rm[k]; },
                                       e, D);
        ge1[out0 + j] = WS - T(0.5) * WH
                        + Model::jtv(xe0 + 2 * D,
                                     [r1](int k) { return r1[k]; }, e, D);
    }
    const T s = block_sum(acc, red);
    if (threadIdx.x == 0) {
        gp[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
    }
}

// Opt in to more than 48 KB of dynamic shared memory where needed (a
// launch above 48 KB without it is refused and never runs), then launch.
template <typename K, typename... Args>
int launch(K kernel, int n_blocks, int B, size_t smem, void* stream,
           Args... args) {
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
    kernel<<<dim3(n_blocks, B), kThreads, smem, (cudaStream_t)stream>>>(
        args...);
    return (int)cudaGetLastError();
}

template <typename T, int kDisc, bool kDiag>
int onestep_fwd(const void* X, long long x_bs, const void* pest,
                long long p_bs, double F_fixed, const void* rf, double rf_s,
                int B, int N_f, int D, double hc, int bn, void* partials,
                void* stream) {
    const int n_blocks = (N_f - 1 + bn - 1) / bn;
    const size_t smem = ((size_t)(bn + 1) * D + kWarps) * sizeof(T);
    return launch(fe_onestep_fwd<T, L96, kDisc, kDiag>, n_blocks, B, smem,
                  stream, static_cast<const T*>(X), x_bs,
                  static_cast<const T*>(pest), p_bs, (T)F_fixed,
                  static_cast<const T*>(rf), (T)rf_s, N_f, D, (T)hc, bn,
                  static_cast<T*>(partials));
}

template <typename T, int kDisc, bool kDiag>
int onestep_bwd(const void* X, long long x_bs, const void* pest,
                long long p_bs, double F_fixed, const void* rf, double rf_s,
                int B, int N_f, int D, double hc, double a1, double c0,
                double c1, int bn, void* gx, void* gp, void* stream) {
    const int n_blocks = (N_f + bn - 1) / bn;
    const size_t smem = ((size_t)(3 * bn + 3) * D + kWarps) * sizeof(T);
    return launch(fe_onestep_bwd<T, L96, kDisc, kDiag>, n_blocks, B, smem,
                  stream, static_cast<const T*>(X), x_bs,
                  static_cast<const T*>(pest), p_bs, (T)F_fixed,
                  static_cast<const T*>(rf), (T)rf_s, N_f, D, (T)hc, (T)a1,
                  (T)c0, (T)c1, bn, static_cast<T*>(gx),
                  static_cast<T*>(gp));
}

template <typename T, bool kDiag>
int sh_fwd(const void* X, long long x_bs, const void* pest, long long p_bs,
           double F_fixed, const void* rf, double rf_s, int B, int M, int D,
           double h6, double h8, int bk, void* partials, void* stream) {
    const int n_blocks = (M + bk - 1) / bk;
    const size_t smem = ((size_t)(2 * bk + 1) * D + kWarps) * sizeof(T);
    return launch(fe_sh_fwd<T, L96, kDiag>, n_blocks, B, smem, stream,
                  static_cast<const T*>(X), x_bs,
                  static_cast<const T*>(pest), p_bs, (T)F_fixed,
                  static_cast<const T*>(rf), (T)rf_s, M, D, (T)h6, (T)h8, bk,
                  static_cast<T*>(partials));
}

template <typename T, bool kDiag>
int sh_bwd(const void* X, long long x_bs, const void* pest, long long p_bs,
           double F_fixed, const void* rf, double rf_s, int B, int M, int D,
           double h6, double h8, double h46, int bk, void* ge0, void* gm,
           void* ge1, void* gp, void* stream) {
    const int n_blocks = (M + bk - 1) / bk;
    const size_t smem = ((size_t)(5 * bk + 1) * D + kWarps) * sizeof(T);
    return launch(fe_sh_bwd<T, L96, kDiag>, n_blocks, B, smem, stream,
                  static_cast<const T*>(X), x_bs,
                  static_cast<const T*>(pest), p_bs, (T)F_fixed,
                  static_cast<const T*>(rf), (T)rf_s, M, D, (T)h6, (T)h8,
                  (T)h46, bk, static_cast<T*>(ge0), static_cast<T*>(gm),
                  static_cast<T*>(ge1), static_cast<T*>(gp));
}

constexpr int kBadDisc = (int)cudaErrorInvalidValue;

template <typename T>
int onestep_fwd_any(int disc, int diag, const void* X, long long x_bs,
                    const void* pest, long long p_bs, double F_fixed,
                    const void* rf, double rf_s, int B, int N_f, int D,
                    double hc, int bn, void* partials, void* stream) {
#define VA_FWD(DISC, DIAG)                                                  \
    return onestep_fwd<T, DISC, DIAG>(X, x_bs, pest, p_bs, F_fixed, rf,     \
                                      rf_s, B, N_f, D, hc, bn, partials,    \
                                      stream)
    switch (disc * 2 + (diag ? 1 : 0)) {
        case kEuler * 2: VA_FWD(kEuler, false);
        case kEuler * 2 + 1: VA_FWD(kEuler, true);
        case kTrapezoid * 2: VA_FWD(kTrapezoid, false);
        case kTrapezoid * 2 + 1: VA_FWD(kTrapezoid, true);
        case kForwardmap * 2: VA_FWD(kForwardmap, false);
        case kForwardmap * 2 + 1: VA_FWD(kForwardmap, true);
        default: return kBadDisc;
    }
#undef VA_FWD
}

template <typename T>
int onestep_bwd_any(int disc, int diag, const void* X, long long x_bs,
                    const void* pest, long long p_bs, double F_fixed,
                    const void* rf, double rf_s, int B, int N_f, int D,
                    double hc, double a1, double c0, double c1, int bn,
                    void* gx, void* gp, void* stream) {
#define VA_BWD(DISC, DIAG)                                                  \
    return onestep_bwd<T, DISC, DIAG>(X, x_bs, pest, p_bs, F_fixed, rf,     \
                                      rf_s, B, N_f, D, hc, a1, c0, c1, bn,  \
                                      gx, gp, stream)
    switch (disc * 2 + (diag ? 1 : 0)) {
        case kEuler * 2: VA_BWD(kEuler, false);
        case kEuler * 2 + 1: VA_BWD(kEuler, true);
        case kTrapezoid * 2: VA_BWD(kTrapezoid, false);
        case kTrapezoid * 2 + 1: VA_BWD(kTrapezoid, true);
        case kForwardmap * 2: VA_BWD(kForwardmap, false);
        case kForwardmap * 2 + 1: VA_BWD(kForwardmap, true);
        default: return kBadDisc;
    }
#undef VA_BWD
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess). Pointers
// are device pointers. X: member b's (N_f, D) state rows start at
// X + b·x_bs, rows contiguous; pest: F at pest[b·p_bs], or null for
// F = F_fixed; rf: (N_f - 1, D) contiguous for diag = 1, else null and
// rf_s the scalar. disc: 0 euler, 1 trapezoid, 2 forwardmap. bn (bk):
// rows (intervals) a block; the wrapper sizes the outputs for
// ceil(rows / bn) blocks.

int va_fe_onestep_fwd_f32(int disc, int diag, const void* X, long long x_bs,
                          const void* pest, long long p_bs, double F_fixed,
                          const void* rf, double rf_s, int B, int N_f, int D,
                          double hc, int bn, void* partials, void* stream) {
    return onestep_fwd_any<float>(disc, diag, X, x_bs, pest, p_bs, F_fixed,
                                  rf, rf_s, B, N_f, D, hc, bn, partials,
                                  stream);
}

int va_fe_onestep_fwd_f64(int disc, int diag, const void* X, long long x_bs,
                          const void* pest, long long p_bs, double F_fixed,
                          const void* rf, double rf_s, int B, int N_f, int D,
                          double hc, int bn, void* partials, void* stream) {
    return onestep_fwd_any<double>(disc, diag, X, x_bs, pest, p_bs, F_fixed,
                                   rf, rf_s, B, N_f, D, hc, bn, partials,
                                   stream);
}

int va_fe_onestep_bwd_f32(int disc, int diag, const void* X, long long x_bs,
                          const void* pest, long long p_bs, double F_fixed,
                          const void* rf, double rf_s, int B, int N_f, int D,
                          double hc, double a1, double c0, double c1, int bn,
                          void* gx, void* gp, void* stream) {
    return onestep_bwd_any<float>(disc, diag, X, x_bs, pest, p_bs, F_fixed,
                                  rf, rf_s, B, N_f, D, hc, a1, c0, c1, bn,
                                  gx, gp, stream);
}

int va_fe_onestep_bwd_f64(int disc, int diag, const void* X, long long x_bs,
                          const void* pest, long long p_bs, double F_fixed,
                          const void* rf, double rf_s, int B, int N_f, int D,
                          double hc, double a1, double c0, double c1, int bn,
                          void* gx, void* gp, void* stream) {
    return onestep_bwd_any<double>(disc, diag, X, x_bs, pest, p_bs, F_fixed,
                                   rf, rf_s, B, N_f, D, hc, a1, c0, c1, bn,
                                   gx, gp, stream);
}

int va_fe_sh_fwd_f32(int diag, const void* X, long long x_bs,
                     const void* pest, long long p_bs, double F_fixed,
                     const void* rf, double rf_s, int B, int M, int D,
                     double h6, double h8, int bk, void* partials,
                     void* stream) {
    return diag ? sh_fwd<float, true>(X, x_bs, pest, p_bs, F_fixed, rf, rf_s,
                                      B, M, D, h6, h8, bk, partials, stream)
                : sh_fwd<float, false>(X, x_bs, pest, p_bs, F_fixed, rf,
                                       rf_s, B, M, D, h6, h8, bk, partials,
                                       stream);
}

int va_fe_sh_fwd_f64(int diag, const void* X, long long x_bs,
                     const void* pest, long long p_bs, double F_fixed,
                     const void* rf, double rf_s, int B, int M, int D,
                     double h6, double h8, int bk, void* partials,
                     void* stream) {
    return diag ? sh_fwd<double, true>(X, x_bs, pest, p_bs, F_fixed, rf,
                                       rf_s, B, M, D, h6, h8, bk, partials,
                                       stream)
                : sh_fwd<double, false>(X, x_bs, pest, p_bs, F_fixed, rf,
                                        rf_s, B, M, D, h6, h8, bk, partials,
                                        stream);
}

int va_fe_sh_bwd_f32(int diag, const void* X, long long x_bs,
                     const void* pest, long long p_bs, double F_fixed,
                     const void* rf, double rf_s, int B, int M, int D,
                     double h6, double h8, double h46, int bk, void* ge0,
                     void* gm, void* ge1, void* gp, void* stream) {
    return diag ? sh_bwd<float, true>(X, x_bs, pest, p_bs, F_fixed, rf, rf_s,
                                      B, M, D, h6, h8, h46, bk, ge0, gm, ge1,
                                      gp, stream)
                : sh_bwd<float, false>(X, x_bs, pest, p_bs, F_fixed, rf,
                                       rf_s, B, M, D, h6, h8, h46, bk, ge0,
                                       gm, ge1, gp, stream);
}

int va_fe_sh_bwd_f64(int diag, const void* X, long long x_bs,
                     const void* pest, long long p_bs, double F_fixed,
                     const void* rf, double rf_s, int B, int M, int D,
                     double h6, double h8, double h46, int bk, void* ge0,
                     void* gm, void* ge1, void* gp, void* stream) {
    return diag ? sh_bwd<double, true>(X, x_bs, pest, p_bs, F_fixed, rf,
                                       rf_s, B, M, D, h6, h8, h46, bk, ge0,
                                       gm, ge1, gp, stream)
                : sh_bwd<double, false>(X, x_bs, pest, p_bs, F_fixed, rf,
                                        rf_s, B, M, D, h6, h8, h46, bk, ge0,
                                        gm, ge1, gp, stream);
}

const char* va_fe_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
