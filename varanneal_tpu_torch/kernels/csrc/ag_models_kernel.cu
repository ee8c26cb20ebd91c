// K1 and K4 on Hopper on the built-in row-level models: NaKL (D = 4, 19
// parameters, with or without its stimulus), Colpitts (D = 3, 4) and
// Lorenz-63 (D = 3, 3), the action and its full gradient in one launch,
// one thread block per ensemble member, under the trapezoid rule, Euler,
// the forward map or Hermite-Simpson, with a scalar or (N-1, D) rf, any
// distinct estimated parameters.
//
// Replaces varanneal_tpu/kernels/ag_pallas.py::_ag_kernel (with build_fwd,
// launched by _ag_batched) on those models: the Pallas kernel traces the
// model and differentiates it with jax.vjp inside the kernel
// (ag_pallas.py:331-346) and embeds the stimulus as shifted views
// (embed_consts, :436-446); here the model is a template argument whose f,
// J^T v and parameter adjoint are written by hand (row_models.cuh, the
// functions K6 runs), and the stimulus is read at each model-grid row.
// The body is row_ag_block.cuh's walk by thread, which takes the rule and
// the rf kind at run time; K2 and K3 on these models (solve_models_*.cu)
// evaluate through the same body.
//
// What bounds it on the card: per member it reads X once (N*D values), the
// stimulus and the (N-1, D) rf once where there are, and writes the
// gradient once; ~100-250 operations a NaKL row (f, three tanh and three
// divisions, the adjoint and its 19 parameter terms), ~30-60 a Colpitts
// or Lorenz-63 row. At config #3's record (N = 6,001, D = 4, B = 1) that
// is ~0.2 MB and ~1.5 MFLOP: well under a microsecond at the card's
// rates. One block a member walks the rows by thread, ~N/256 rows a
// thread, so the launch is bound by that serial depth and the launch's
// latency, not by bytes or operations; at one member the other SMs idle
// (K6, which spreads a member over blocks, is the engine for one long
// record). K4 (va_*_ag_comp_*) adds the (B, 6) row of two-float sums
// [me_hi, me_lo, fe1_hi, fe1_lo, fe2_hi, fe2_lo] that kernels/ag.py's
// combine joins. Sums are reduced in a fixed order with no atomics, so
// repeated launches give bit-identical results.

#include <cuda_runtime.h>

#include "row_ag_block.cuh"

namespace {

template <typename Model, typename T, bool kComp>
__global__ void __launch_bounds__(kAgThreads) row_ag_kernel(
        RowProblem<Model, T> p, const T* __restrict__ XP, T rf,
        T* __restrict__ A_out, T* __restrict__ G_out,
        T* __restrict__ C_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int b = blockIdx.x;
    const AgSums<T> s = row_rule_block<Model, T, kComp>(
        p, XP + (size_t)b * p.n_dof, rf, G_out + (size_t)b * p.n_dof,
        reinterpret_cast<T*>(smem_raw),
        kComp ? C_out + (size_t)b * 6 : nullptr);
    if (threadIdx.x == 0) A_out[b] = s.A;
}

template <typename Model, typename T, bool kComp>
int launch(const void* XP, int B, VA_ROW_ARGS, double rf, void* A_out,
           void* G_out, void* C_out, void* stream) {
    if (!row_ok<Model>(disc, N, n_dof, n_est))
        return (int)cudaErrorInvalidValue;
    const RowProblem<Model, T> p =
        row_problem<Model, T>(VA_ROW_PASS);
    const size_t smem = row_area_elems<Model>(kComp) * sizeof(T);
    row_ag_kernel<Model, T, kComp>
        <<<B, kAgThreads, smem, (cudaStream_t)stream>>>(
            p, static_cast<const T*>(XP), (T)rf, static_cast<T*>(A_out),
            static_cast<T*>(G_out), static_cast<T*>(C_out));
    return (int)cudaGetLastError();
}

}  // namespace

// Each returns the cudaError_t of the launch (0 = cudaSuccess). Pointers
// are device pointers: XP/G_out (B, n_dof) row-major, n_dof = N * D +
// n_est (the states, then the estimated parameters in pidx order); Y/W
// (N_data, L); lpos (D,) int32 (position of column d among the observed,
// or -1: the observed columns distinct); disc 0 trapezoid, 1 euler, 2
// forwardmap, 3 SimpsonHermite (N odd); rfd the (N-1, D) rf, or NULL for
// the scalar rf; stim (N,) the injected current of each model-grid row
// (NaKL), or NULL; pfix (kNP,) the parameters (linear; the estimated
// entries unread); pmap (kNP,) int32, each parameter's position among the
// estimated or -1; pidx (n_est,) int32; A_out (B,); C_out (B, 6) (K4).
#define VA_ROW_AG_ENTRIES(MODEL, name)                                      \
    int va_##name##_ag_f32(const void* XP, int B, VA_ROW_ARGS, double rf,  \
                           void* A_out, void* G_out, void* stream) {       \
        return launch<MODEL, float, false>(XP, B, VA_ROW_PASS, rf, A_out,  \
                                           G_out, nullptr, stream);        \
    }                                                                       \
    int va_##name##_ag_f64(const void* XP, int B, VA_ROW_ARGS, double rf,  \
                           void* A_out, void* G_out, void* stream) {       \
        return launch<MODEL, double, false>(XP, B, VA_ROW_PASS, rf, A_out, \
                                            G_out, nullptr, stream);       \
    }                                                                       \
    int va_##name##_ag_comp_f32(const void* XP, int B, VA_ROW_ARGS,        \
                                double rf, void* A_out, void* G_out,       \
                                void* C_out, void* stream) {               \
        return launch<MODEL, float, true>(XP, B, VA_ROW_PASS, rf, A_out,   \
                                          G_out, C_out, stream);           \
    }                                                                       \
    int va_##name##_ag_comp_f64(const void* XP, int B, VA_ROW_ARGS,        \
                                double rf, void* A_out, void* G_out,       \
                                void* C_out, void* stream) {               \
        return launch<MODEL, double, true>(XP, B, VA_ROW_PASS, rf, A_out,  \
                                           G_out, C_out, stream);          \
    }

extern "C" {

VA_ROW_AG_ENTRIES(NaKL, nakl)
VA_ROW_AG_ENTRIES(Colpitts, colpitts)
VA_ROW_AG_ENTRIES(L63, l63)

const char* va_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
