// K5 on Hopper: the Lorenz-96 one-step action and its full gradient in one
// launch, one thread block per ensemble member, for small D (4 <= D <= 64)
// under the trapezoid rule, Euler or a forward map, with a scalar rf or an
// (N-1, D) one.
//
// Replaces varanneal_tpu/kernels/ag_pallas.py::_agt_kernel (launched by
// _agt_batched, built by make_action_ag_t), the reference's small-D
// action kernel in the transposed (components x time) layout. The Pallas
// kernel differentiates its forward with jax.vjp inside the kernel; here
// the adjoint is written by hand (l96_agt_block.cuh states it per disc).
// The function is the XLA action's (ops/action.py): the reference's
// kernel embeds the observations at model rows 0..N_data-1 whatever the
// observation stride, and falls into the forward-map residual for
// Hermite-Simpson; this kernel puts the observations at rows
// k * obs_stride, and its wrapper's envelope (kernels/ag.py,
// agt_supported) refuses Hermite-Simpson.
//
// Layout: row-major (N, D), read straight from the flat decision vector
// (l96_agt_block.cuh says why not the transposed one).
//
// What bounds it on the card: per member it reads X once (N*D values), rf
// once when it is (N-1, D), and writes the gradient once; ~25-40
// operations per entry. At config #1's shape (N=161, D=20, B=4) that is
// ~0.1 MB and ~0.5 MFLOP a launch: tens of nanoseconds at the card's
// rates, far below the microseconds a launch and one block's serial depth
// cost. So, as K1, it is bound by launch latency and the block's depth;
// the design keeps that short: one launch gives value and gradient, the
// weighted residuals stay in shared memory between the two passes, and
// the three sums are reduced once with warp shuffles.

#include <cuda_runtime.h>

#include "l96_agt_block.cuh"

namespace {

template <typename T, int kDisc, bool kDiag>
__global__ void __launch_bounds__(kAgtThreads) l96_agt_kernel(
        AgtProblem<T> p, const T* __restrict__ XP, T rf,
        const T* __restrict__ rfd, T* __restrict__ A_out,
        T* __restrict__ G_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int b = blockIdx.x;
    l96_agt_block<T, kDisc, kDiag>(p, XP + (size_t)b * p.n_dof, rf, rfd,
                                   G_out + (size_t)b * p.n_dof,
                                   reinterpret_cast<T*>(smem_raw), A_out + b);
}

template <typename T, int kDisc, bool kDiag>
int launch_k(const AgtProblem<T>& p, int B, const void* XP, double rf,
             const void* rfd, void* A_out, void* G_out, void* stream) {
    const size_t smem = l96_agt_smem_elems(p.N, p.D) * sizeof(T);
    if (smem > 48 * 1024) {
        // above 48 KB only as opted-in dynamic shared memory; a launch
        // without the opt-in is refused and never runs (its error read
        // back, so that the next launch does not report it again)
        const cudaError_t e = cudaFuncSetAttribute(
            l96_agt_kernel<T, kDisc, kDiag>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
    }
    l96_agt_kernel<T, kDisc, kDiag>
        <<<B, kAgtThreads, smem, (cudaStream_t)stream>>>(
            p, static_cast<const T*>(XP), (T)rf, static_cast<const T*>(rfd),
            static_cast<T*>(A_out), static_cast<T*>(G_out));
    return (int)cudaGetLastError();
}

template <typename T, int kDisc>
int launch_rf(const AgtProblem<T>& p, int B, const void* XP, double rf,
              const void* rfd, void* A_out, void* G_out, void* stream) {
    return rfd ? launch_k<T, kDisc, true>(p, B, XP, rf, rfd, A_out, G_out,
                                          stream)
               : launch_k<T, kDisc, false>(p, B, XP, rf, rfd, A_out, G_out,
                                           stream);
}

template <typename T>
int launch(const void* XP, int B, int n_dof, int N, int D, int pslot,
           double F_fixed, const void* Y, const void* W, const void* lidx,
           const void* lpos, int N_data, int L, int obs_stride, double h,
           double me_norm, double fe_norm, int disc, double rf,
           const void* rfd, void* A_out, void* G_out, void* stream) {
    const AgtProblem<T> p{n_dof, N, D, pslot, (T)F_fixed,
                          static_cast<const T*>(Y), static_cast<const T*>(W),
                          static_cast<const int*>(lidx),
                          static_cast<const int*>(lpos), N_data, L,
                          obs_stride, (T)h, (T)me_norm, (T)fe_norm};
    switch (disc) {
        case kAgtTrapezoid:
            return launch_rf<T, kAgtTrapezoid>(p, B, XP, rf, rfd, A_out,
                                               G_out, stream);
        case kAgtEuler:
            return launch_rf<T, kAgtEuler>(p, B, XP, rf, rfd, A_out, G_out,
                                           stream);
        case kAgtForwardMap:
            return launch_rf<T, kAgtForwardMap>(p, B, XP, rf, rfd, A_out,
                                                G_out, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess). Pointers
// are device pointers; XP/G_out are (B, n_dof) row-major, Y/W (N_data, L),
// lidx (L,) and lpos (D,) int32 (lpos[d] = position of d in lidx, or -1);
// disc 0 trapezoid, 1 euler, 2 forwardmap; rfd the (N-1, D) rf, or NULL
// for the scalar rf; A_out (B,).
int va_l96_agt_f32(const void* XP, int B, int n_dof, int N, int D,
                   int pslot, double F_fixed, const void* Y, const void* W,
                   const void* lidx, const void* lpos, int N_data, int L,
                   int obs_stride, double h, double me_norm, double fe_norm,
                   int disc, double rf, const void* rfd, void* A_out,
                   void* G_out, void* stream) {
    return launch<float>(XP, B, n_dof, N, D, pslot, F_fixed, Y, W, lidx,
                         lpos, N_data, L, obs_stride, h, me_norm, fe_norm,
                         disc, rf, rfd, A_out, G_out, stream);
}

int va_l96_agt_f64(const void* XP, int B, int n_dof, int N, int D,
                   int pslot, double F_fixed, const void* Y, const void* W,
                   const void* lidx, const void* lpos, int N_data, int L,
                   int obs_stride, double h, double me_norm, double fe_norm,
                   int disc, double rf, const void* rfd, void* A_out,
                   void* G_out, void* stream) {
    return launch<double>(XP, B, n_dof, N, D, pslot, F_fixed, Y, W, lidx,
                          lpos, N_data, L, obs_stride, h, me_norm, fe_norm,
                          disc, rf, rfd, A_out, G_out, stream);
}

const char* va_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
