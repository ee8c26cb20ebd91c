// The NaKL Hodgkin–Huxley neuron on the card: the vector field, the
// transposed Jacobian product and the parameter adjoint, written by hand
// (no autodiff on the card) from varanneal_tpu_torch/models/nakl.py.
// K6 (fe_kernel.cu) evaluates them one (row, component) at a time; a
// whole-problem kernel can call them the same way.
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
// Each component's f depends on its own parameter group only (V's on
// p[0..6], gate a's on p[q..q+3]), so the per-component adjoint
// nakl_ptv touches a disjoint set of the 19 partials, and the sum of
// nakl_ptv over the four components is the row's Σ_d df_d/dp_j v_d
// (nakl_ptv_row).
#pragma once

namespace nakl {

constexpr int kNP = 19;
enum Param { Cm, gNa, ENa, gK, EK, gL, EL };

__device__ __forceinline__ float va_tanh(float u) { return tanhf(u); }
__device__ __forceinline__ double va_tanh(double u) { return tanh(u); }

// The gate's tanh form at V: th, s = 1 - th^2, tau and f_a.
template <typename T>
struct Gate {
    T u, th, s, tau, fa;
};

template <typename T>
__device__ __forceinline__ Gate<T> gate(T V, T a, const T* g) {
    Gate<T> r;
    r.u = (V - g[0]) / g[1];
    r.th = va_tanh(r.u);
    r.s = T(1) - r.th * r.th;
    r.tau = g[2] + g[3] * r.s;
    r.fa = (T(0.5) * (T(1) + r.th) - a) / r.tau;
    return r;
}

// df_a/dth.
template <typename T>
__device__ __forceinline__ T gate_dth(const Gate<T>& r, const T* g) {
    return (T(0.5) + T(2) * g[3] * r.th * r.fa) / r.tau;
}

template <typename T>
__device__ __forceinline__ T f0(const T* x, const T* p, T I) {
    const T V = x[0], m = x[1], h = x[2], n = x[3];
    return (p[gNa] * m * m * m * h * (p[ENa] - V)
            + p[gK] * n * n * n * n * (p[EK] - V)
            + p[gL] * (p[EL] - V) + I) / p[Cm];
}

// Gate parameter adjoint into acc[Q .. Q+3] (Q a constant, so that acc
// stays in registers).
template <int Q, typename T>
__device__ __forceinline__ void gate_ptv(const T* x, int a, const T* p,
                                         T v, T* acc) {
    const T* g = p + Q;
    const Gate<T> r = gate(x[0], x[a], g);
    const T dth = gate_dth(r, g);
    acc[Q] += -dth * r.s / g[1] * v;
    acc[Q + 1] += -dth * r.s * r.u / g[1] * v;
    acc[Q + 2] += -r.fa / r.tau * v;
    acc[Q + 3] += -r.fa * r.s / r.tau * v;
}

}  // namespace nakl

// f_d(x) for one state row x (4 values), parameters p (19) and current I.
template <typename T>
__device__ __forceinline__ T nakl_f(const T* x, int d, const T* p, T I) {
    if (d == 0) return nakl::f0(x, p, I);
    return nakl::gate(x[0], x[d], p + 7 + 4 * (d - 1)).fa;
}

// (J(x)^T v)_e; v is any callable k -> v_k (the stimulus is additive, so
// it does not enter).
template <typename T, typename V>
__device__ __forceinline__ T nakl_jtv(const T* x, const V& v, int e,
                                      const T* p) {
    using namespace nakl;
    const T Vm = x[0], m = x[1], h = x[2], n = x[3];
    if (e == 0) {
        T acc = -(p[gNa] * m * m * m * h + p[gK] * n * n * n * n + p[gL])
                / p[Cm] * v(0);
        for (int a = 1; a <= 3; ++a) {
            const T* g = p + 7 + 4 * (a - 1);
            const Gate<T> r = gate(Vm, x[a], g);
            acc += gate_dth(r, g) * r.s / g[1] * v(a);
        }
        return acc;
    }
    const T* g = p + 7 + 4 * (e - 1);
    const T tau = gate(Vm, x[e], g).tau;
    T d0;
    if (e == 1) {
        d0 = T(3) * p[gNa] * m * m * h * (p[ENa] - Vm) / p[Cm];
    } else if (e == 2) {
        d0 = p[gNa] * m * m * m * (p[ENa] - Vm) / p[Cm];
    } else {
        d0 = T(4) * p[gK] * n * n * n * (p[EK] - Vm) / p[Cm];
    }
    return d0 * v(0) - v(e) / tau;
}

// Adds df_d/dp_j · v_d to acc[j] for the parameters component d depends
// on; acc holds the 19 partials.
template <typename T>
__device__ __forceinline__ void nakl_ptv(const T* x, int d, const T* p,
                                         T I, T v, T* acc) {
    using namespace nakl;
    if (d == 0) {
        const T V = x[0], m = x[1], h = x[2], n = x[3];
        const T mh3 = m * m * m * h, n4 = n * n * n * n;
        const T w = v / p[Cm];
        acc[Cm] += -f0(x, p, I) * w;
        acc[gNa] += mh3 * (p[ENa] - V) * w;
        acc[ENa] += p[gNa] * mh3 * w;
        acc[gK] += n4 * (p[EK] - V) * w;
        acc[EK] += p[gK] * n4 * w;
        acc[gL] += (p[EL] - V) * w;
        acc[EL] += p[gL] * w;
    } else if (d == 1) {
        gate_ptv<7>(x, 1, p, v, acc);
    } else if (d == 2) {
        gate_ptv<11>(x, 2, p, v, acc);
    } else {
        gate_ptv<15>(x, 3, p, v, acc);
    }
}

// The row's parameter adjoint Σ_d df_d/dp_j · v_d, added to acc (19).
template <typename T, typename V>
__device__ __forceinline__ void nakl_ptv_row(const T* x, const V& v,
                                             const T* p, T I, T* acc) {
#pragma unroll
    for (int d = 0; d < 4; ++d) nakl_ptv(x, d, p, I, v(d), acc);
}
