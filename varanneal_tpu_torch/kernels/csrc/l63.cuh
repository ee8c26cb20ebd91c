// Lorenz-63 on the card: the vector field, the transposed Jacobian product
// and the parameter adjoint, written by hand (no autodiff on the card)
// from varanneal_tpu_torch/models/lorenz.py's lorenz63, for kernels in
// which one thread owns a whole state row (K6, fe_kernel.cu).
//
// State x = [x0, x1, x2]; p = [sigma, rho, beta]:
//
//   f   = [sigma (x1 - x0), x0 (rho - x2) - x1, x0 x1 - beta x2]
//   Jᵀv = [-sigma v0 + (rho - x2) v1 + x1 v2, sigma v0 - v1 + x0 v2,
//          -x0 v1 - beta v2]
//   Σ_d df_d/dp v_d = [(x1 - x0) v0, x0 v1, -x2 v2]
#pragma once

namespace l63 {

constexpr int kNP = 3;
enum Param { kSigma, kRho, kBeta };

// One node's model quantities: f (3); the adjoint needs nothing more.
template <typename T>
struct Node {
    T f[3];
};

}  // namespace l63

// f at one row x (3 values) with the parameter row p.
template <typename T>
__device__ __forceinline__ void l63_node(const T* x, const T* p,
                                         l63::Node<T>& nd) {
    using namespace l63;
    nd.f[0] = p[kSigma] * (x[1] - x[0]);
    nd.f[1] = x[0] * (p[kRho] - x[2]) - x[1];
    nd.f[2] = x[0] * x[1] - p[kBeta] * x[2];
}

// (J(x)ᵀ v) into jt (3) and the 3 partials Σ_d df_d/dp_j v_d added to
// acc.
template <typename T>
__device__ __forceinline__ void l63_adjoint_row(const T* x, const T* p,
                                                const T* v, T* jt, T* acc) {
    using namespace l63;
    jt[0] = -p[kSigma] * v[0] + (p[kRho] - x[2]) * v[1] + x[1] * v[2];
    jt[1] = p[kSigma] * v[0] - v[1] + x[0] * v[2];
    jt[2] = -x[0] * v[1] - p[kBeta] * v[2];
    acc[kSigma] += (x[1] - x[0]) * v[0];
    acc[kRho] += x[0] * v[1];
    acc[kBeta] += -x[2] * v[2];
}
