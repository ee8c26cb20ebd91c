// The built-in row-level models of the kernels, as policies of static
// members: NaKL (nakl.cuh), Colpitts (colpitts.cuh) and Lorenz-63
// (l63.cuh), each with its state width kD, its parameter count kNP, the
// extended parameter row its node functions read (kNPX values: param()
// from the merged row, stage() from a row given value by value), its node
// quantities (Node: f and what the adjoint reuses), node() and adjoint().
// K6 (fe_kernel.cu) and K1-K4's walk by thread (row_ag_block.cuh) take
// the model as a template argument; kStim, kRow and kMaxThreads are K6's.
#pragma once

#include "colpitts.cuh"
#include "l63.cuh"
#include "nakl.cuh"

namespace {

// NaKL (D = 4, 19 parameters, the stimulus as the injected current).
// Its kernels are row-level (kRow): a thread owns an interval
// (Hermite–Simpson) or a node (one-step), evaluates each of its nodes
// once (nakl_node: three tanh and three divisions) and reuses those values
// in the residuals, Jᵀv and the parameter adjoint, so no warp splits by
// component.
struct NaKL {
    static constexpr int kNP = nakl::kNP;
    static constexpr int kNPX = nakl::kNPX;
    static constexpr int kD = 4;
    static constexpr bool kStim = true;
    static constexpr bool kRow = true;
    static constexpr int kMaxThreads = 256;
    template <typename T>
    using Node = nakl::Node<T>;
    // entry j of the extended parameter row (nakl_node) from the 19
    template <typename T>
    __device__ static T param(const T* p, int j) {
        return j < kNP ? p[j] : nakl::derived(p, j);
    }
    // the same from the 19 values as row(i) gives them (K1's walk reads
    // the estimated ones from the decision vector)
    template <typename T, typename Row>
    __device__ static T stage(const Row& row, int j) {
        return j < kNP ? row(j) : T(1) / row(nakl::derived_of(j));
    }
    template <typename T>
    __device__ static void node(const T* x, const T* px, T I, Node<T>& nd) {
        nakl_node(x, px, I, nd);
    }
    template <typename T>
    __device__ static void adjoint(const T* x, const T* px,
                                   const Node<T>& nd, const T* v, T* jt,
                                   T* acc) {
        nakl_adjoint_row(x, px, nd, v, jt, acc);
    }
};

// Colpitts (D = 3, p = [alpha, gamma, q, eta], no stimulus): row-level
// as NaKL, its node f and e = exp(-x1) (colpitts_node).
struct Colpitts {
    static constexpr int kNP = colpitts::kNP;
    static constexpr int kNPX = kNP;
    static constexpr int kD = 3;
    static constexpr bool kStim = false;
    static constexpr bool kRow = true;
    static constexpr int kMaxThreads = 256;
    template <typename T>
    using Node = colpitts::Node<T>;
    template <typename T>
    __device__ static T param(const T* p, int j) {
        return p[j];
    }
    template <typename T, typename Row>
    __device__ static T stage(const Row& row, int j) {
        return row(j);
    }
    template <typename T>
    __device__ static void node(const T* x, const T* px, T, Node<T>& nd) {
        colpitts_node(x, px, nd);
    }
    template <typename T>
    __device__ static void adjoint(const T* x, const T* px,
                                   const Node<T>& nd, const T* v, T* jt,
                                   T* acc) {
        colpitts_adjoint_row(x, px, nd, v, jt, acc);
    }
};

// Lorenz-63 (D = 3, p = [sigma, rho, beta], no stimulus): row-level as
// NaKL, its node f alone (l63_node).
struct L63 {
    static constexpr int kNP = l63::kNP;
    static constexpr int kNPX = kNP;
    static constexpr int kD = 3;
    static constexpr bool kStim = false;
    static constexpr bool kRow = true;
    static constexpr int kMaxThreads = 256;
    template <typename T>
    using Node = l63::Node<T>;
    template <typename T>
    __device__ static T param(const T* p, int j) {
        return p[j];
    }
    template <typename T, typename Row>
    __device__ static T stage(const Row& row, int j) {
        return row(j);
    }
    template <typename T>
    __device__ static void node(const T* x, const T* px, T, Node<T>& nd) {
        l63_node(x, px, nd);
    }
    template <typename T>
    __device__ static void adjoint(const T* x, const T* px, const Node<T>&,
                                   const T* v, T* jt, T* acc) {
        l63_adjoint_row(x, px, v, jt, acc);
    }
};

}  // namespace
