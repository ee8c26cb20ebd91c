// K5 on Hopper: the Lorenz-96 one-step action and its full gradient in one
// launch, one thread block per ensemble member, for small D (4 <= D <= 64)
// under the trapezoid rule, Euler or a forward map, with a scalar rf or an
// (N-1, D) one.
//
// Replaces varanneal_tpu/kernels/ag_pallas.py::_agt_kernel (launched by
// _agt_batched, built by make_action_ag_t), the reference's small-D
// action kernel in the transposed (components x time) layout. The Pallas
// kernel differentiates its forward with jax.vjp inside the kernel; here
// the adjoint is written by hand (l96_ag_block.cuh states it per rule).
// The function is the XLA action's (ops/action.py): the reference's
// kernel embeds the observations at model rows 0..N_data-1 whatever the
// observation stride, and falls into the forward-map residual for
// Hermite-Simpson; this kernel puts the observations at rows
// k * obs_stride, and its wrapper's envelope (kernels/ag.py,
// agt_refusal) refuses Hermite-Simpson.
//
// Layout: row-major (N, D), read straight from the flat decision vector,
// as K1 reads it. The reference's transposed layout lets time fill the
// TPU's 128 lanes at D << 128; on the card a warp's lanes take the
// columns of a row instead, so the flat layout needs no transpose, no
// padding and no copy.
//
// What bounds it on the card: per member it reads X once (N*D values), rf
// once when it is (N-1, D), and writes the gradient once; ~25-40
// operations per entry. At config #1's shape (N=161, D=20, B=4) that is
// ~0.1 MB and ~0.5 MFLOP a launch: tens of nanoseconds at the card's
// rates, far below the microseconds a launch and one block's serial depth
// cost. So, as K1, it is bound by launch latency and the block's depth.
// The body is K1's walk in time (l96_walk_block, l96_ag_block.cuh) under
// the rule and the rf kind as template arguments: each warp walks its own
// rows, by registers and shuffles at D <= 32 and with a 6-row ring in
// shared memory above, f once a row, no residual array and one block
// barrier; shared memory does not grow with N. Its three sums (FE, sum
// w r, ME) and the value's combination are carried in double, rounded to
// T once: at the first rungs, where A is nearly all ME, K1's f32 partial
// sums along a warp's rows leave it about an ulp from f64, and the plain
// version's pairwise sum a fifth of that. Sums are reduced in a fixed
// order with no atomics, so repeated launches give bit-identical
// results.

#include <cuda_runtime.h>

#include "l96_ag_block.cuh"

namespace {

// The sums' type (see above).
using Acc = double;

template <typename T, int kDisc, bool kDiag>
__global__ void __launch_bounds__(kAgThreads) l96_agt_kernel(
        L96Problem<T> p, const T* __restrict__ XP, T rf,
        const T* __restrict__ rfd, T* __restrict__ A_out,
        T* __restrict__ G_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int b = blockIdx.x;
    Acc* red = reinterpret_cast<Acc*>(smem_raw);
    T* ring = reinterpret_cast<T*>(red + l96_ag_red_elems());
    const AgSums<T> s = l96_walk_block<T, false, BlockGroup, kDisc, kDiag,
                                       Acc>(
        p, XP + (size_t)b * p.n_dof, rf, rfd, G_out + (size_t)b * p.n_dof,
        ring, red, nullptr);
    if (threadIdx.x == 0) A_out[b] = s.A;
}

template <typename T, int kDisc>
int launch_rf(const L96Problem<T>& p, int B, const void* XP, double rf,
              const void* rfd, void* A_out, void* G_out, void* stream) {
    // the partials and the rings (under 25 KB at D <= 64)
    const size_t smem = l96_ag_red_elems() * sizeof(Acc)
                        + l96_ag_ring_elems(p.D) * sizeof(T);
    const T* x = static_cast<const T*>(XP);
    T* A = static_cast<T*>(A_out);
    T* G = static_cast<T*>(G_out);
    if (rfd) {
        l96_agt_kernel<T, kDisc, true>
            <<<B, kAgThreads, smem, (cudaStream_t)stream>>>(
                p, x, (T)rf, static_cast<const T*>(rfd), A, G);
    } else {
        l96_agt_kernel<T, kDisc, false>
            <<<B, kAgThreads, smem, (cudaStream_t)stream>>>(
                p, x, (T)rf, nullptr, A, G);
    }
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* XP, int B, int n_dof, int N, int D, int pslot,
           double F_fixed, const void* Y, const void* W, const void* lidx,
           const void* lpos, int N_data, int L, int obs_stride, double h,
           double me_norm, double fe_norm, int disc, double rf,
           const void* rfd, void* A_out, void* G_out, void* stream) {
    const L96Problem<T> p{n_dof, N, D, pslot, (T)F_fixed,
                          static_cast<const T*>(Y), static_cast<const T*>(W),
                          static_cast<const int*>(lidx),
                          static_cast<const int*>(lpos), N_data, L,
                          obs_stride, (T)h, (T)me_norm, (T)fe_norm};
    switch (disc) {
        case kWalkTrapezoid:
            return launch_rf<T, kWalkTrapezoid>(p, B, XP, rf, rfd, A_out,
                                                G_out, stream);
        case kWalkEuler:
            return launch_rf<T, kWalkEuler>(p, B, XP, rf, rfd, A_out, G_out,
                                            stream);
        case kWalkForwardMap:
            return launch_rf<T, kWalkForwardMap>(p, B, XP, rf, rfd, A_out,
                                                 G_out, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess). Pointers
// are device pointers; XP/G_out are (B, n_dof) row-major, Y/W (N_data, L),
// lidx (L,) and lpos (D,) int32 (lpos[d] = position of d in lidx, or -1;
// the observed columns distinct); disc 0 trapezoid, 1 euler, 2
// forwardmap; rfd the (N-1, D) rf, or NULL for the scalar rf; A_out (B,).
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
