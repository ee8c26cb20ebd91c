// The NaKL Hodgkin–Huxley neuron on the card: the vector field, the
// transposed Jacobian product and the parameter adjoint, written by hand
// (no autodiff on the card) from varanneal_tpu_torch/models/nakl.py, for
// kernels in which one thread owns a whole state row (K6, fe_kernel.cu).
//
// State x = [V, m, h, n]; p the 19 parameters in NAKL_PNAMES order; I the
// injected current of the row (0 without a stimulus):
//
//   f_0 = (gNa m^3 h (ENa - V) + gK n^4 (EK - V) + gL (EL - V) + I) / Cm
//   f_a = (a_inf(V) - a) / tau_a(V)            a = m, h, n (components 1-3)
//   a_inf = (1 + th) / 2,  tau_a = ta0 + ta1 s,
//   th = tanh(u), u = (V - va) / dva, s = 1 - th^2 (the tanh form's
//   derivative: dth/du = s)
//
// Partial derivatives used below (gate a with parameters va, dva, ta0,
// ta1 at p[q .. q+3], q = 7 + 4 (a - 1)):
//
//   df_0/dV = -(gNa m^3 h + gK n^4 + gL) / Cm
//   df_0/dm = 3 gNa m^2 h (ENa - V) / Cm,  df_0/dh = gNa m^3 (ENa - V) / Cm,
//   df_0/dn = 4 gK n^3 (EK - V) / Cm
//   df_a/dth = (1/2 + 2 ta1 th f_a) / tau_a     (a_inf' = 1/2,
//                                                tau_a' = -2 ta1 th)
//   df_a/dV = df_a/dth * s / dva,  df_a/da = -1 / tau_a
//   df_0/dCm = -f_0 / Cm, df_0/dgNa = m^3 h (ENa - V) / Cm,
//   df_0/dENa = gNa m^3 h / Cm, df_0/dgK = n^4 (EK - V) / Cm,
//   df_0/dEK = gK n^4 / Cm, df_0/dgL = (EL - V) / Cm, df_0/dEL = gL / Cm
//   df_a/dva = -df_a/dth * s / dva, df_a/ddva = -df_a/dth * s u / dva,
//   df_a/dta0 = -f_a / tau_a, df_a/dta1 = -f_a s / tau_a
//
// nakl_node evaluates the row's four f values and keeps each gate's th
// and 1/tau_a (one tanh and one division a gate), and nakl_adjoint_row
// forms Jᵀv and the 19 parameter partials Σ_d df_d/dp_j v_d from them
// with no further tanh or division. They read the parameter row extended
// by nakl::derived (1/Cm and the gates' 1/dva after the 19 values), so
// that u and f_0 take a product where the model divides.
#pragma once

namespace nakl {

constexpr int kNP = 19;
enum Param { Cm, gNa, ENa, gK, EK, gL, EL };

__device__ __forceinline__ float va_tanh(float u) { return tanhf(u); }
__device__ __forceinline__ double va_tanh(double u) { return tanh(u); }

// The extended parameter row of the row-level functions: the 19 values,
// then 1/Cm, then 1/dva of the gates m, h, n.
constexpr int kICm = kNP;
constexpr int kIdva = kNP + 1;
constexpr int kNPX = kNP + 4;

// The value whose inverse entry j (kNP <= j < kNPX) of the extended row
// is: Cm, or the gate's dva (derived's index, for a row that is not an
// array).
__host__ __device__ constexpr int derived_of(int j) {
    return j == kICm ? Cm : 7 + 4 * (j - kIdva) + 1;
}

// Entry j (kNP <= j < kNPX) of the extended row from the 19 values p.
template <typename T>
__device__ __forceinline__ T derived(const T* p, int j) {
    return T(1) / (j == kICm ? p[Cm] : p[7 + 4 * (j - kIdva) + 1]);
}

// One node's model quantities: f (4) and, per gate, th and 1/tau.
template <typename T>
struct Node {
    T f[4];
    T th[3];
    T ti[3];
};

}  // namespace nakl

// f at one row x (4 values) with the extended parameter row px and the
// current I, keeping what nakl_adjoint_row needs: three tanh and three
// divisions.
template <typename T>
__device__ __forceinline__ void nakl_node(const T* x, const T* px, T I,
                                          nakl::Node<T>& nd) {
    using namespace nakl;
    const T V = x[0], m = x[1], h = x[2], n = x[3];
    nd.f[0] = (px[gNa] * m * m * m * h * (px[ENa] - V)
               + px[gK] * n * n * n * n * (px[EK] - V)
               + px[gL] * (px[EL] - V) + I) * px[kICm];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const T* g = px + 7 + 4 * a;
        const T th = va_tanh((V - g[0]) * px[kIdva + a]);
        const T ti = T(1) / (g[2] + g[3] * (T(1) - th * th));
        nd.th[a] = th;
        nd.ti[a] = ti;
        nd.f[1 + a] = (T(0.5) * (T(1) + th) - x[1 + a]) * ti;
    }
}

// (J(x)ᵀ v) into jt (4) and the 19 partials Σ_d df_d/dp_j v_d added to
// acc, at the row x whose quantities nd holds (nakl_node).
template <typename T>
__device__ __forceinline__ void nakl_adjoint_row(const T* x, const T* px,
                                                 const nakl::Node<T>& nd,
                                                 const T* v, T* jt, T* acc) {
    using namespace nakl;
    const T V = x[0], m = x[1], h = x[2], n = x[3];
    const T iCm = px[kICm];
    const T m3 = m * m * m, n3 = n * n * n;
    const T m3h = m3 * h, n4 = n3 * n;
    const T eNa = px[ENa] - V, eK = px[EK] - V;
    const T w = v[0] * iCm;
    T j0 = -(px[gNa] * m3h + px[gK] * n4 + px[gL]) * w;
    jt[1] = T(3) * px[gNa] * m * m * h * eNa * w;
    jt[2] = px[gNa] * m3 * eNa * w;
    jt[3] = T(4) * px[gK] * n3 * eK * w;
    acc[Cm] += -nd.f[0] * w;
    acc[gNa] += m3h * eNa * w;
    acc[ENa] += px[gNa] * m3h * w;
    acc[gK] += n4 * eK * w;
    acc[EK] += px[gK] * n4 * w;
    acc[gL] += (px[EL] - V) * w;
    acc[EL] += px[gL] * w;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const T* g = px + 7 + 4 * a;
        const T idva = px[kIdva + a];
        const T th = nd.th[a], ti = nd.ti[a], fa = nd.f[1 + a];
        const T s = T(1) - th * th;
        // df_a/dth · s / dva (df_a/dth = (1/2 + 2 ta1 th f_a) / tau)
        const T dV = (T(0.5) + T(2) * g[3] * th * fa) * ti * s * idva;
        const T va = v[1 + a];
        j0 += dV * va;
        jt[1 + a] -= va * ti;
        acc[7 + 4 * a] += -dV * va;
        acc[8 + 4 * a] += -dV * (V - g[0]) * idva * va;
        acc[9 + 4 * a] += -fa * ti * va;
        acc[10 + 4 * a] += -fa * s * ti * va;
    }
    jt[0] = j0;
}
