// Lorenz-96 vector field and its transposed Jacobian product, as device
// functions shared by the port's CUDA kernels (the action+gradient kernel
// in ag_kernel.cu now; the whole-rung and whole-ladder solve kernels
// next). The formulas are those of native/valib.cpp (l96_f, l96_jtv),
// which the test suite checks against jax.grad:
//
//   f_d(x)        = (x_{d+1} - x_{d-2}) x_{d-1} - x_d + F
//   (J(x)^T v)_e  = x_{e-2} v_{e-1} + (x_{e+2} - x_{e-1}) v_{e+1}
//                   - x_{e+1} v_{e+2} - v_e
//
// Indices wrap modulo D. Offsets never exceed 2, so one compare replaces
// the modulus (valid for D >= 2; Lorenz-96 has D >= 4).
#pragma once

__device__ __forceinline__ int l96_wrap(int i, int D) {
    return i < 0 ? i + D : (i >= D ? i - D : i);
}

// f_d(x) for one state row x (length D).
template <typename T>
__device__ __forceinline__ T l96_f(const T* x, int d, int D, T F) {
    return (x[l96_wrap(d + 1, D)] - x[l96_wrap(d - 2, D)])
               * x[l96_wrap(d - 1, D)]
           - x[d] + F;
}

// (J(x)^T v)_e for one state row x; v is any callable e -> v_e, so a
// caller can form v from several rows without storing it.
template <typename T, typename V>
__device__ __forceinline__ T l96_jtv(const T* x, const V& v, int e, int D) {
    return x[l96_wrap(e - 2, D)] * v(l96_wrap(e - 1, D))
           + (x[l96_wrap(e + 2, D)] - x[l96_wrap(e - 1, D)])
                 * v(l96_wrap(e + 1, D))
           - x[l96_wrap(e + 1, D)] * v(l96_wrap(e + 2, D))
           - v(e);
}
