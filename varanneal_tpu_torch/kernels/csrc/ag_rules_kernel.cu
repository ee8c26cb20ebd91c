// K1 and K4 on Hopper under Lorenz-96's other rules: the action and its
// full gradient in one launch, one thread block per ensemble member, under
// Euler, the forward map, Hermite-Simpson or the trapezoid rule, with a
// scalar rf or an (N-1, D) one (every pair but the trapezoid rule with a
// scalar rf, which is ag_kernel.cu's).
//
// Replaces varanneal_tpu/kernels/ag_pallas.py::_ag_kernel (with build_fwd,
// launched by _ag_batched) for those rules and rf kinds ('scalar', 'diag'
// and 'diag_sh' rf_mode there): the Pallas kernel differentiates its
// forward with jax.vjp inside the kernel; here the adjoint is written by
// hand, per rule (l96_ag_block.cuh states each). The reference embeds an
// (N-1, D) rf under Hermite-Simpson as two weight planes at the
// intervals' even rows; this kernel reads rows 2k and 2k+1 of the rf
// itself.
//
// The body is l96_rule_block (l96_ag_block.cuh), which takes the rule and
// the rf kind at run time and walks the member's path in time as K1's
// routine does: each warp its own rows (Hermite-Simpson: its own steps of
// two rows), its lanes over the columns, registers and shuffles at D <=
// 32 and a 6-row ring (5 under Hermite-Simpson) in shared memory above,
// in a workspace where it does not fit; f once a row, no residual array,
// one block barrier. The whole-solve kernels of the rules
// (l96_solve_rules.cuh) call the same body, not inlined, so K1 and
// their evaluations run the same machine code.
//
// What bounds it on the card: per member it reads X once (N*D values),
// the (N-1, D) rf once when there is one, and writes the gradient once;
// ~25-50 operations per entry (Hermite-Simpson's two residuals and two
// J^T products a pair of rows among the most). At config #1's shape (N =
// 161, D = 20, B = 4) that is ~0.1 MB and ~0.5 MFLOP a launch: tens of
// nanoseconds at the card's rates, far below the microseconds a launch
// and one block's serial depth cost. So, as K1, it is bound by launch
// latency and the block's depth, which the walk keeps short.
//
// K4 (va_l96_ag_rule_comp_*) adds the (B, 6) row of two-float sums [me_hi,
// me_lo, fe1_hi, fe1_lo, fe2_hi, fe2_lo]: the ME terms, the FE terms
// (r^2 under a scalar rf, (w r) r under an (N-1, D) one; Hermite-
// Simpson's Simpson plane) and Hermite-Simpson's Hermite plane (zero
// otherwise), as the reference's build_fwd(with_terms=True) forms them;
// the wrapper joins them (kernels/ag.py::combine). Sums are reduced in a
// fixed order with no atomics, so repeated launches give bit-identical
// results.

#include <cuda_runtime.h>

#include "l96_ag_block.cuh"

namespace {

constexpr int kThreads = kAgThreads;

// The partials of the rules' entries: kAgSums a warp, kAgRuleCompSums with
// K4's pairs.
__host__ __device__ inline size_t rule_red_elems(bool comp) {
    return (size_t)(comp ? kAgRuleCompSums : kAgSums) * kAgWarps;
}

template <typename T, bool kComp>
__global__ void __launch_bounds__(kThreads) l96_ag_rule_kernel(
        L96RuleProblem<T> p, const T* __restrict__ XP, T rf,
        T* __restrict__ work, T* __restrict__ A_out, T* __restrict__ G_out,
        T* __restrict__ C_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int b = blockIdx.x;
    T* red = reinterpret_cast<T*>(smem_raw);
    T* ring = work ? work + (size_t)b * l96_ag_ring_elems(p.D)
                   : red + rule_red_elems(kComp);
    const AgSums<T> s = l96_rule_block<T, kComp>(
        p, XP + (size_t)b * p.n_dof, rf, G_out + (size_t)b * p.n_dof, ring,
        red, kComp ? C_out + (size_t)b * 6 : nullptr);
    if (threadIdx.x == 0) A_out[b] = s.A;
}

template <typename T, bool kComp>
int launch(const void* XP, int B, int n_dof, int N, int D, int pslot,
           double F_fixed, const void* Y, const void* W, const void* lidx,
           const void* lpos, int N_data, int L, int obs_stride, double h,
           double rf, double me_norm, double fe_norm, void* work, int disc,
           const void* rfd, void* A_out, void* G_out, void* C_out,
           void* stream) {
    if (!rule_ok(disc, N, rfd != nullptr)) return (int)cudaErrorInvalidValue;
    L96RuleProblem<T> p;
    static_cast<L96Problem<T>&>(p) = L96Problem<T>{
        n_dof, N, D, pslot, (T)F_fixed, static_cast<const T*>(Y),
        static_cast<const T*>(W), static_cast<const int*>(lidx),
        static_cast<const int*>(lpos), N_data, L, obs_stride, (T)h,
        (T)me_norm, (T)fe_norm};
    p.disc = disc;
    p.rfd = static_cast<const T*>(rfd);
    const size_t smem = (rule_red_elems(kComp)
                         + (work ? 0 : l96_ag_ring_elems(D))) * sizeof(T);
    const void* fn = (const void*)l96_ag_rule_kernel<T, kComp>;
    if (smem > 48 * 1024) {
        // above 48 KB only as opted-in dynamic shared memory (a refusal's
        // error read back, so that the next launch does not report it)
        const cudaError_t e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
    }
    l96_ag_rule_kernel<T, kComp>
        <<<B, kThreads, smem, (cudaStream_t)stream>>>(
            p, static_cast<const T*>(XP), (T)rf, static_cast<T*>(work),
            static_cast<T*>(A_out), static_cast<T*>(G_out),
            static_cast<T*>(C_out));
    return (int)cudaGetLastError();
}

}  // namespace

// The entries' arguments: ag_kernel.cu's, then the rule and the rf rows.
#define VA_RULE_ARGS                                                        \
    const void *XP, int B, int n_dof, int N, int D, int pslot,             \
        double F_fixed, const void *Y, const void *W, const void *lidx,    \
        const void *lpos, int N_data, int L, int obs_stride, double h,     \
        double rf, double me_norm, double fe_norm, void *work, int disc,   \
        const void *rfd
#define VA_RULE_PASS                                                        \
    XP, B, n_dof, N, D, pslot, F_fixed, Y, W, lidx, lpos, N_data, L,       \
        obs_stride, h, rf, me_norm, fe_norm, work, disc, rfd

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess). Pointers
// are device pointers; XP/G_out are (B, n_dof) row-major, Y/W (N_data, L),
// lidx (L,) and lpos (D,) int32 (lpos[d] = position of d in lidx, or -1;
// the observed columns distinct); work: NULL (the rings in shared memory)
// or (B, l96_ag_ring_elems(D)) of the kernel's dtype; disc 0 trapezoid
// (with an (N-1, D) rf only), 1 euler, 2 forwardmap, 3 SimpsonHermite (N
// odd); rfd the (N-1, D) rf, or NULL for the scalar rf; A_out (B,).
int va_l96_ag_rule_f32(VA_RULE_ARGS, void* A_out, void* G_out,
                       void* stream) {
    return launch<float, false>(VA_RULE_PASS, A_out, G_out, nullptr,
                                stream);
}

int va_l96_ag_rule_f64(VA_RULE_ARGS, void* A_out, void* G_out,
                       void* stream) {
    return launch<double, false>(VA_RULE_PASS, A_out, G_out, nullptr,
                                 stream);
}

// K4: the same arguments plus C_out, (B, 6) of the kernel's dtype.
int va_l96_ag_rule_comp_f32(VA_RULE_ARGS, void* A_out, void* G_out,
                            void* C_out, void* stream) {
    return launch<float, true>(VA_RULE_PASS, A_out, G_out, C_out, stream);
}

int va_l96_ag_rule_comp_f64(VA_RULE_ARGS, void* A_out, void* G_out,
                            void* C_out, void* stream) {
    return launch<double, true>(VA_RULE_PASS, A_out, G_out, C_out, stream);
}

const char* va_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
