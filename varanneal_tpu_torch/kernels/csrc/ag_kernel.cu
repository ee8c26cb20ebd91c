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
// autograd), and the block routine walks the path in time, each warp over
// its own rows with its lanes over the columns, so that no residual array
// and no block barrier stand between the residuals and the gradient; the
// warps' three sums meet at the one barrier of the launch. The
// whole-solve kernels (solve_kernel.cu) keep whole L-BFGS solves inside
// one launch and so escape the per-evaluation launch cost.
//
// The body is the block routine l96_ag_block (l96_ag_block.cuh), which the
// whole-solve kernels share. Sums are reduced in a fixed order (per-lane
// partials along the walk, a warp shuffle tree, then the warps in order),
// with no atomics: repeated launches give bit-identical results. Shared
// memory holds the warps' partials and their rings of rows
// (l96_ag_smem_elems: 6 rows of D a warp, whatever N); where the rings
// do not fit in the block's 227 KB (D above 1,210 in f32, 604 in f64)
// they live in a workspace the wrapper passes, one per member.
//
// K4, the compensated entry (va_l96_ag_trap_comp_*), replaces the same
// Pallas kernel with comp=True (ag_pallas.py::_ag_kernel's comp branch and
// comp_sum_block). It is K1 plus a (B, 6) row of two-float sums
// [me_hi, me_lo, fe1_hi, fe1_lo, fe2_hi, fe2_lo] of the ME terms and of
// the unweighted FE terms r^2, which the wrapper joins in f64 and scales
// by rf and the norms (ag.py::combine), so that an f32 action keeps an
// ~f64-accurate value at high rf. Its plain value and gradient are K1's,
// bit for bit (the same block routine; the gradient rides the plain
// forward, as in the reference). Bound as K1: per term it adds a TwoSum
// (6 rounded operations and a product), ~8 operations per state entry on
// top of K1's ~40, and 48 bytes a member of output; it stays bound by
// launch latency and the block's serial depth. The per-lane pairs are
// joined down a warp shuffle tree and then over the warps in order by
// thread 0, with no atomics, so repeats are bit-identical.

#include <cuda_runtime.h>

#include "l96_ag_block.cuh"

namespace {

constexpr int kThreads = kAgThreads;

// Member b's rings: in shared memory past the partials, or in its slice of
// the workspace (work != nullptr).
template <typename T>
__device__ __forceinline__ T* ring_of(T* red, T* work, int D, bool comp,
                                      int b) {
    return work ? work + (size_t)b * l96_ag_ring_elems(D)
                : red + l96_ag_red_elems(comp);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) l96_ag_trap_kernel(
        const T* __restrict__ XP, int n_dof, int N, int D, int pslot,
        T F_fixed, const T* __restrict__ Y, const T* __restrict__ W,
        const int* __restrict__ lidx, const int* __restrict__ lpos,
        int N_data, int L, int obs_stride, T h, T rf, T me_norm, T fe_norm,
        T* __restrict__ work, T* __restrict__ A_out,
        T* __restrict__ G_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const L96Problem<T> p{n_dof, N, D, pslot, F_fixed, Y, W, lidx, lpos,
                          N_data, L, obs_stride, h, me_norm, fe_norm};
    const int b = blockIdx.x;
    T* red = reinterpret_cast<T*>(smem_raw);
    const AgSums<T> s = l96_ag_block<T>(
        p, XP + (size_t)b * n_dof, rf, G_out + (size_t)b * n_dof,
        ring_of(red, work, D, false, b), red);
    if (threadIdx.x == 0) A_out[b] = s.A;
}

// K4: K1 plus the (B, 6) row of two-float sums (see the note above).
template <typename T>
__global__ void __launch_bounds__(kThreads) l96_ag_trap_comp_kernel(
        const T* __restrict__ XP, int n_dof, int N, int D, int pslot,
        T F_fixed, const T* __restrict__ Y, const T* __restrict__ W,
        const int* __restrict__ lidx, const int* __restrict__ lpos,
        int N_data, int L, int obs_stride, T h, T rf, T me_norm, T fe_norm,
        T* __restrict__ work, T* __restrict__ A_out,
        T* __restrict__ G_out, T* __restrict__ C_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const L96Problem<T> p{n_dof, N, D, pslot, F_fixed, Y, W, lidx, lpos,
                          N_data, L, obs_stride, h, me_norm, fe_norm};
    const int b = blockIdx.x;
    T* red = reinterpret_cast<T*>(smem_raw);
    const AgSums<T> s = l96_ag_block<T, true>(
        p, XP + (size_t)b * n_dof, rf, G_out + (size_t)b * n_dof,
        ring_of(red, work, D, true, b), red, C_out + (size_t)b * 6);
    if (threadIdx.x == 0) A_out[b] = s.A;
}

template <typename T, bool kComp>
int launch(const void* XP, int B, int n_dof, int N, int D, int pslot,
           double F_fixed, const void* Y, const void* W, const void* lidx,
           const void* lpos, int N_data, int L, int obs_stride, double h,
           double rf, double me_norm, double fe_norm, void* work,
           void* A_out, void* G_out, void* C_out, void* stream) {
    const size_t smem = (work ? l96_ag_red_elems(kComp)
                              : l96_ag_smem_elems(D, kComp)) * sizeof(T);
    const void* fn = kComp ? (const void*)l96_ag_trap_comp_kernel<T>
                           : (const void*)l96_ag_trap_kernel<T>;
    if (smem > 48 * 1024) {
        // above 48 KB only as opted-in dynamic shared memory; a launch
        // without the opt-in is refused and never runs (its error read
        // back, so that the next launch does not report it again)
        const cudaError_t e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
    }
    if constexpr (kComp) {
        l96_ag_trap_comp_kernel<T>
            <<<B, kThreads, smem, (cudaStream_t)stream>>>(
                static_cast<const T*>(XP), n_dof, N, D, pslot, (T)F_fixed,
                static_cast<const T*>(Y), static_cast<const T*>(W),
                static_cast<const int*>(lidx), static_cast<const int*>(lpos),
                N_data, L, obs_stride, (T)h, (T)rf, (T)me_norm, (T)fe_norm,
                static_cast<T*>(work), static_cast<T*>(A_out),
                static_cast<T*>(G_out), static_cast<T*>(C_out));
    } else {
        l96_ag_trap_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
            static_cast<const T*>(XP), n_dof, N, D, pslot, (T)F_fixed,
            static_cast<const T*>(Y), static_cast<const T*>(W),
            static_cast<const int*>(lidx), static_cast<const int*>(lpos),
            N_data, L, obs_stride, (T)h, (T)rf, (T)me_norm, (T)fe_norm,
            static_cast<T*>(work), static_cast<T*>(A_out),
            static_cast<T*>(G_out));
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess). Pointers
// are device pointers; XP/G_out are (B, n_dof) row-major, Y/W (N_data, L),
// lidx (L,) and lpos (D,) int32 (lpos[d] = position of d in lidx, or -1);
// work: NULL (the rings in shared memory) or (B, l96_ag_ring_elems(D))
// of the kernel's dtype, where they do not fit there.
int va_l96_ag_trap_f32(const void* XP, int B, int n_dof, int N, int D,
                       int pslot, double F_fixed, const void* Y,
                       const void* W, const void* lidx, const void* lpos,
                       int N_data, int L, int obs_stride, double h,
                       double rf, double me_norm, double fe_norm,
                       void* work, void* A_out, void* G_out, void* stream) {
    return launch<float, false>(XP, B, n_dof, N, D, pslot, F_fixed, Y, W,
                                lidx, lpos, N_data, L, obs_stride, h, rf,
                                me_norm, fe_norm, work, A_out, G_out,
                                nullptr, stream);
}

int va_l96_ag_trap_f64(const void* XP, int B, int n_dof, int N, int D,
                       int pslot, double F_fixed, const void* Y,
                       const void* W, const void* lidx, const void* lpos,
                       int N_data, int L, int obs_stride, double h,
                       double rf, double me_norm, double fe_norm,
                       void* work, void* A_out, void* G_out, void* stream) {
    return launch<double, false>(XP, B, n_dof, N, D, pslot, F_fixed, Y, W,
                                 lidx, lpos, N_data, L, obs_stride, h, rf,
                                 me_norm, fe_norm, work, A_out, G_out,
                                 nullptr, stream);
}

// K4: the same arguments plus C_out, (B, 6) of the kernel's dtype.
int va_l96_ag_trap_comp_f32(const void* XP, int B, int n_dof, int N, int D,
                            int pslot, double F_fixed, const void* Y,
                            const void* W, const void* lidx,
                            const void* lpos, int N_data, int L,
                            int obs_stride, double h, double rf,
                            double me_norm, double fe_norm, void* work,
                            void* A_out, void* G_out, void* C_out,
                            void* stream) {
    return launch<float, true>(XP, B, n_dof, N, D, pslot, F_fixed, Y, W,
                               lidx, lpos, N_data, L, obs_stride, h, rf,
                               me_norm, fe_norm, work, A_out, G_out, C_out,
                               stream);
}

int va_l96_ag_trap_comp_f64(const void* XP, int B, int n_dof, int N, int D,
                            int pslot, double F_fixed, const void* Y,
                            const void* W, const void* lidx,
                            const void* lpos, int N_data, int L,
                            int obs_stride, double h, double rf,
                            double me_norm, double fe_norm, void* work,
                            void* A_out, void* G_out, void* C_out,
                            void* stream) {
    return launch<double, true>(XP, B, n_dof, N, D, pslot, F_fixed, Y, W,
                                lidx, lpos, N_data, L, obs_stride, h, rf,
                                me_norm, fe_norm, work, A_out, G_out,
                                C_out, stream);
}

const char* va_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
