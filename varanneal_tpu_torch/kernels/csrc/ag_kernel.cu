// K1 on Hopper: the Lorenz-96 trapezoid action and its full gradient in one
// launch, one thread block per ensemble member.
//
// Replaces varanneal_tpu/kernels/ag_pallas.py::_ag_kernel (with build_fwd,
// launched by _ag_batched) for the trapezoid rule, a scalar rf, a scalar
// or (N_data, L) RM and constant parameters. The Pallas kernel gets its
// gradient from jax.vjp traced inside the kernel; CUDA cannot, so the
// adjoint here is written by hand (l96_ag.cuh):
//
//   r_n  = x_{n+1} - x_n - (h/2)(f(x_n) + f(x_{n+1})),  n < N-1
//   A    = me_norm * sum W (x_obs - Y)^2 + fe_norm * rf * sum r^2
//   gX_n = 2c [r_{n-1} - r_n - (h/2) J(x_n)^T (r_{n-1} + r_n)]
//          + 2 me_norm W (x_n - y) on observed entries,  c = fe_norm * rf
//   dA/dF = -2 c h sum r
//
// What bounds it on the card: per member it reads X once (N*D values) and
// writes gX once (the same size); the arithmetic is ~40 operations per
// state entry. At the main path's shape (N=161, D=20, B=4) that is
// ~100 KB and ~0.5 MFLOP per launch: tens of nanoseconds at the card's
// memory and f32 rates, far below the few microseconds a launch costs. So
// the kernel is bound by launch latency and by the serial depth inside one
// block, not by bytes or operations. The design keeps that depth short:
// one launch gives value and gradient (the L-BFGS loop calls no
// autograd), the residuals stay in shared memory between the two passes
// (X is read from global memory through L1, never copied or padded), and
// the three sums are reduced once with warp shuffles. Filling the card
// (B = 4 blocks on 132 SMs) is left to the fused-solve kernels of the
// next slice, which keep whole L-BFGS solves inside one launch.
//
// Sums are reduced in a fixed order (per-thread strided partials, a warp
// shuffle tree, then warp 0 in order), with no atomics: repeated launches
// give bit-identical results.

#include <cuda_runtime.h>

#include "l96_ag.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <typename T>
__global__ void __launch_bounds__(kThreads) l96_ag_trap_kernel(
        const T* __restrict__ XP, int n_dof, int N, int D, int pslot,
        T F_fixed, const T* __restrict__ Y, const T* __restrict__ W,
        const int* __restrict__ lidx, const int* __restrict__ lpos,
        int N_data, int L, int obs_stride, T h, T rf, T me_norm, T fe_norm,
        T* __restrict__ A_out, T* __restrict__ G_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* r = reinterpret_cast<T*>(smem_raw);           // (N-1)*D residuals
    const int n_res = (N - 1) * D;
    T* red = r + n_res;                               // 3 * kWarps partials

    const int b = blockIdx.x;
    const T* x = XP + (size_t)b * n_dof;
    T* g = G_out + (size_t)b * n_dof;
    const T F = pslot >= 0 ? x[pslot] : F_fixed;
    const T hh = h / T(2);

    // pass 1: residuals into shared memory, partial sums of FE, sum r, ME
    T fe = T(0), sr = T(0), me = T(0);
    for (int i = threadIdx.x; i < n_res; i += kThreads) {
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
    for (int i = threadIdx.x; i < N_data * L; i += kThreads) {
        const int k = i / L;
        const int l = i - k * L;
        const T diff = x[(size_t)k * obs_stride * D + lidx[l]] - Y[i];
        me += W[i] * diff * diff;
    }

    // fixed-order block reduction of the three sums
    fe = warp_sum(fe);
    sr = warp_sum(sr);
    me = warp_sum(me);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
        red[warp] = fe;
        red[kWarps + warp] = sr;
        red[2 * kWarps + warp] = me;
    }
    __syncthreads();   // residuals and partials complete

    // pass 2: the gradient of every state entry from the shared residuals
    const T c2 = T(2) * fe_norm * rf;
    for (int i = threadIdx.x; i < N * D; i += kThreads) {
        const int n = i / D;
        const int d = i - n * D;
        const T* rp = n > 0 ? r + (size_t)(n - 1) * D : nullptr;
        const T* rc = n < N - 1 ? r + (size_t)n * D : nullptr;
        const RowPairSum<T> v{rp, rc};
        const T jt = l96_jtv(x + (size_t)n * D, v, d, D);
        T gx = c2 * ((rp ? rp[d] : T(0)) - (rc ? rc[d] : T(0)) - hh * jt);
        if (n % obs_stride == 0 && n / obs_stride < N_data) {
            const int l = lpos[d];
            if (l >= 0) {
                const int k = (n / obs_stride) * L + l;
                gx += T(2) * me_norm * W[k] * (x[i] - Y[k]);
            }
        }
        g[i] = gx;
    }

    if (threadIdx.x == 0) {
        T fe_t = T(0), sr_t = T(0), me_t = T(0);
        for (int w = 0; w < kWarps; ++w) {
            fe_t += red[w];
            sr_t += red[kWarps + w];
            me_t += red[2 * kWarps + w];
        }
        A_out[b] = me_norm * me_t + fe_norm * (rf * fe_t);
        if (pslot >= 0) g[pslot] = -c2 * h * sr_t;
    }
}

template <typename T>
int launch(const void* XP, int B, int n_dof, int N, int D, int pslot,
           double F_fixed, const void* Y, const void* W, const void* lidx,
           const void* lpos, int N_data, int L, int obs_stride, double h,
           double rf, double me_norm, double fe_norm, void* A_out,
           void* G_out, void* stream) {
    const size_t smem = ((size_t)(N - 1) * D + 3 * kWarps) * sizeof(T);
    if (smem > 48 * 1024) {
        // above 48 KB only as opted-in dynamic shared memory; a launch
        // without the opt-in is refused and never runs
        const cudaError_t e = cudaFuncSetAttribute(
            l96_ag_trap_kernel<T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    l96_ag_trap_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const T*>(XP), n_dof, N, D, pslot, (T)F_fixed,
        static_cast<const T*>(Y), static_cast<const T*>(W),
        static_cast<const int*>(lidx), static_cast<const int*>(lpos),
        N_data, L, obs_stride, (T)h, (T)rf, (T)me_norm, (T)fe_norm,
        static_cast<T*>(A_out), static_cast<T*>(G_out));
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess). Pointers
// are device pointers; XP/G_out are (B, n_dof) row-major, Y/W (N_data, L),
// lidx (L,) and lpos (D,) int32 (lpos[d] = position of d in lidx, or -1).
int va_l96_ag_trap_f32(const void* XP, int B, int n_dof, int N, int D,
                       int pslot, double F_fixed, const void* Y,
                       const void* W, const void* lidx, const void* lpos,
                       int N_data, int L, int obs_stride, double h,
                       double rf, double me_norm, double fe_norm,
                       void* A_out, void* G_out, void* stream) {
    return launch<float>(XP, B, n_dof, N, D, pslot, F_fixed, Y, W, lidx,
                         lpos, N_data, L, obs_stride, h, rf, me_norm,
                         fe_norm, A_out, G_out, stream);
}

int va_l96_ag_trap_f64(const void* XP, int B, int n_dof, int N, int D,
                       int pslot, double F_fixed, const void* Y,
                       const void* W, const void* lidx, const void* lpos,
                       int N_data, int L, int obs_stride, double h,
                       double rf, double me_norm, double fe_norm,
                       void* A_out, void* G_out, void* stream) {
    return launch<double>(XP, B, n_dof, N, D, pslot, F_fixed, Y, W, lidx,
                          lpos, N_data, L, obs_stride, h, rf, me_norm,
                          fe_norm, A_out, G_out, stream);
}

const char* va_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
