// K2 and K3 under Lorenz-96's other rules, float64 entries; the
// kernels, their notes and the launches are l96_solve_rules.cuh's.

#include <cuda_runtime.h>

#include "l96_solve_rules.cuh"

extern "C" {

// As solve_kernel.cu's entries, plus disc (0 trapezoid, with K2's (N-1,
// D) rf only; 1 euler, 2 forwardmap, 3 SimpsonHermite with N odd) and,
// for K2, rfd: the (N-1, D) rf (a device pointer of double), or NULL for
// the scalar rf.
int va_l96_solve_rule_f64(VA_SOLVE_ARGS, int layout, int disc, double rf,
                          const void* rfd, const void* lo, const void* hi,
                          int bnd_stride, void* work, void* X_out,
                          void* G_out, void* fp_out, void* cnt_out,
                          void* stream) {
    if (!rule_ok(disc, N, rfd != nullptr))
        return (int)cudaErrorInvalidValue;
    return launch_solve(rule_problem(VA_PROBLEM(double), disc, rfd),
                        VA_OPTS(double), B, layout, rf, XP, lo, hi,
                        bnd_stride, work, X_out, G_out, fp_out, cnt_out,
                        stream);
}

int va_l96_ladder_rule_f64(VA_SOLVE_ARGS, int layout, int disc,
                           const void* rfs, int k_rungs, void* work,
                           void* X_out, void* rec, void* rec_i,
                           void* stream) {
    if (!rule_ok(disc, N, false)) return (int)cudaErrorInvalidValue;
    return launch_ladder(rule_problem(VA_PROBLEM(double), disc, nullptr),
                         VA_OPTS(double), B, layout, rfs, k_rungs, XP, work,
                         X_out, rec, rec_i, stream);
}

// As va_l96_solve_attrs, for this library's kernels.
int va_l96_solve_rule_attrs(int ladder, int bounded, int layout, int* out) {
    return rule_attrs<double>(ladder, bounded, layout, out);
}

const char* va_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
