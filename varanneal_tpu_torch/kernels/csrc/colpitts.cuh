// The Colpitts oscillator on the card: the vector field, the transposed
// Jacobian product and the parameter adjoint, written by hand (no
// autodiff on the card) from varanneal_tpu_torch/models/colpitts.py, for
// kernels in which one thread owns a whole state row (K6, fe_kernel.cu).
//
// State x = [x1, x2, x3] (x[0], x[1], x[2]); p = [alpha, gamma, q, eta];
// e = exp(-x1), evaluated once a node:
//
//   f   = [alpha x2, -gamma (x1 + x3) - q x2, eta (x2 + 1 - e)]
//   Jᵀv = [-gamma v2 + eta e v3, alpha v1 - q v2 + eta v3, -gamma v2]
//   Σ_d df_d/dp v_d = [x2 v1, -(x1 + x3) v2, -x2 v2, (x2 + 1 - e) v3]
//
// (v1, v2, v3 = v[0], v[1], v[2].) exp is the full-precision one (expf,
// exp), not __expf: f32 stays within a few ulps of the plain version.
#pragma once

namespace colpitts {

constexpr int kNP = 4;
enum Param { kAlpha, kGamma, kQ, kEta };

__device__ __forceinline__ float va_exp(float u) { return expf(u); }
__device__ __forceinline__ double va_exp(double u) { return exp(u); }

// One node's model quantities: f (3) and e = exp(-x1), which the adjoint
// reuses.
template <typename T>
struct Node {
    T f[3];
    T e;
};

}  // namespace colpitts

// f at one row x (3 values) with the parameter row p, keeping e.
template <typename T>
__device__ __forceinline__ void colpitts_node(const T* x, const T* p,
                                              colpitts::Node<T>& nd) {
    using namespace colpitts;
    const T e = va_exp(-x[0]);
    nd.e = e;
    nd.f[0] = p[kAlpha] * x[1];
    nd.f[1] = -p[kGamma] * (x[0] + x[2]) - p[kQ] * x[1];
    nd.f[2] = p[kEta] * (x[1] + T(1) - e);
}

// (J(x)ᵀ v) into jt (3) and the 4 partials Σ_d df_d/dp_j v_d added to
// acc, at the row x whose quantities nd holds (colpitts_node).
template <typename T>
__device__ __forceinline__ void colpitts_adjoint_row(
        const T* x, const T* p, const colpitts::Node<T>& nd, const T* v,
        T* jt, T* acc) {
    using namespace colpitts;
    jt[0] = -p[kGamma] * v[1] + p[kEta] * nd.e * v[2];
    jt[1] = p[kAlpha] * v[0] - p[kQ] * v[1] + p[kEta] * v[2];
    jt[2] = -p[kGamma] * v[1];
    acc[kAlpha] += x[1] * v[0];
    acc[kGamma] += -(x[0] + x[2]) * v[1];
    acc[kQ] += -x[1] * v[1];
    acc[kEta] += (x[1] + T(1) - nd.e) * v[2];
}
