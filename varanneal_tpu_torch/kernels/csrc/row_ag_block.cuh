// The action and its full gradient of one member of a row-level model
// (NaKL with or without its stimulus, Colpitts, Lorenz-63; row_models.cuh)
// by one group of threads, under the four rules of the walk with a scalar
// or (N-1, D) rf: the body of K1 and K4 on those models
// (ag_models_kernel.cu) and of the evaluation inside K2 and K3
// (solve_models_*.cu, through l96_solve.cuh's evaluate).
//
// Replaces, for those models, what varanneal_tpu/kernels/ag_pallas.py's
// _ag_kernel computes with jax.vjp of the model inside the kernel
// (ag_pallas.py:331-346; the stimulus embedded as shifted views,
// embed_consts :436-446). Here f, J^T v and the parameter adjoint are the
// models' hand-written device functions (nakl.cuh, colpitts.cuh, l63.cuh,
// shared with K6), and the adjoint of each rule is written out:
//
//   one-step  r_n = x_{n+1} - x_n - (h/2)(f_n + f_{n+1})   trapezoid
//                 = x_{n+1} - x_n - h f_n                   euler
//                 = x_{n+1} - f_n                           forwardmap
//             q_n = w_n r_n (w the (N-1, D) rf's row; 1 at a scalar rf,
//             whose value is then in c = fe_norm rf), v_n = q_{n-1} + q_n
//             (trapezoid) or q_n, and
//             gX_n = 2c (q_{n-1} - q_n - k J(x_n)^T v_n)  (forwardmap:
//             q_{n-1} - J^T v_n), k = h/2, h, 1;
//             dA/dp_j = -2c k sum_n sum_d df_d/dp_j(x_n) v_{n,d}
//   Hermite-Simpson, interval k over rows 2k..2k+2 (l96_ag_block.cuh's
//             note): a_k = w_s s_k, b_k = w_m m_k,
//             v_k = (h/6)(a_{k-1} + a_k) + (h/8)(b_k - b_{k-1}),
//             gX_{2k} = 2c (a_{k-1} - a_k - (b_{k-1} + b_k)/2
//                           - J(x_{2k})^T v_k),
//             gX_{2k+1} = 2c (b_k - J(x_{2k+1})^T ((2h/3) a_k)),
//             dA/dp_j = -2c sum over rows of df/dp_j^T of the same v
//
// plus ME = me_norm sum W (x_obs - Y)^2 and its gradient at the observed
// rows (every obs_stride-th model row, the columns of lpos).
//
// The walk in time by thread. A row-level model has D = 3 or 4, so a
// Lorenz-96 warp's lanes over the columns would sit idle; instead each
// thread of the group owns a contiguous range of rows (Hermite-Simpson:
// of steps, step k holding rows 2k and 2k+1) and walks it alone. It
// evaluates each node once (Model::node: f and what the adjoint reuses:
// NaKL's tanh and 1/tau, Colpitts' exp(-x1)) and keeps the previous node
// in registers; the node where two ranges meet is evaluated by both
// threads (and, under Hermite-Simpson, the midpoint before it), so no f
// is stored and the walk needs no barrier. Each thread writes the
// gradient rows it owns, their ME terms included, and sums FE, ME and
// the kNP parameter adjoints in registers; the group reduces those in a
// fixed order (a warp's shuffle tree, then the warps in order), with no
// atomics, so a repeated launch gives the same bits. The parameter row
// (the fixed values and the estimated ones from x, NaKL's 1/Cm and 1/dva
// formed from them) is staged once an evaluation in the group's area.
// Two group barriers an evaluation: after the staging, and after the
// partials.
//
// The area (row_area_elems): the staged row (kNPX values), the warps'
// partials (2 + kNP a warp: FE, ME, the parameter sums) and, with kComp
// (K4), the warps' (hi, lo) pairs of the ME terms, the FE terms and the
// Hermite plane. The solvers give it the place of Lorenz-96's rings
// (ring_cols), so their layouts and workspaces need no other case.
#pragma once

#include "l96_ag_block.cuh"
#include "row_models.cuh"

// The problem of a row-level model, shared by every member: the data, the
// rule (WalkDisc) and rf kind, the stimulus and the parameters.
template <typename Model, typename T>
struct RowProblem {
    int n_dof, N;               // n_dof = N * kD + n_est
    const T* Y;                 // (N_data, L)
    const T* W;                 // (N_data, L) RM weights
    const int* lpos;            // (kD,) position in the observed columns, or -1
    int N_data, L, obs_stride;
    T h, me_norm, fe_norm;
    int disc;                   // WalkDisc
    const T* rfd;               // (N-1, kD) rf, or nullptr for a scalar rf
    const T* stim;              // (N,) injected current, or nullptr
    const T* pfix;              // (kNP,) the parameters, linear
    const int* pmap;            // (kNP,) position among the estimated, or -1
    const int* pidx;            // (n_est,) the estimated parameters
    int n_est;
};

// The warps' sums: FE, ME and the kNP parameter adjoints.
template <typename Model>
__host__ __device__ constexpr int row_sums() {
    return 2 + Model::kNP;
}

// A group's area in elements (the note at the top).
template <typename Model>
__host__ __device__ inline size_t row_area_elems(bool comp,
                                                 int warps = kAgWarps) {
    return Model::kNPX + (size_t)(row_sums<Model>() + (comp ? 6 : 0)) * warps;
}

// The width whose rings (l96_ag_ring_elems) hold the area of a group of
// `warps` warps: the solvers size and place a problem's evaluation area
// by it. The area's partials grow with the warps and its staged row does
// not, so a width for K2's eight warps is too narrow for one or two (K8's
// groups of 32 and 64 threads): each group size takes its own.
template <typename Model, typename T>
__host__ __device__ inline int ring_cols(const RowProblem<Model, T>&,
                                         int warps = kAgWarps) {
    const size_t per = (size_t)kRingRows * warps;
    return (int)((row_area_elems<Model>(false, warps) + per - 1) / per);
}

// Rows [a, b) of count for the thread of rank t of a group of `size`,
// split as evenly as the threads allow.
__device__ __forceinline__ void thread_range(int count, unsigned t,
                                             int size, int& a, int& b) {
    const int q = count / size;
    const int rem = count - q * size;
    const int r = (int)t;
    a = r * q + (r < rem ? r : rem);
    b = a + q + (r < rem ? 1 : 0);
}

// One node: its row of x and the model's quantities there.
template <typename Model, typename T>
struct RowNode {
    T x[Model::kD];
    typename Model::template Node<T> nd;
};

template <typename Model, typename T>
__device__ __forceinline__ void load_node(const RowProblem<Model, T>& p,
                                          const T* x, const T* sp, int n,
                                          RowNode<Model, T>& o) {
#pragma unroll
    for (int d = 0; d < Model::kD; ++d)
        o.x[d] = x[(size_t)n * Model::kD + d];
    Model::node(o.x, sp, p.stim ? p.stim[n] : T(0), o.nd);
}

// ME's term of row n (when observed) added to the row's gradient gx and
// summed; oc walks the rows in order.
template <typename Model, typename T, bool kComp>
__device__ __forceinline__ void row_observe(const RowProblem<Model, T>& p,
                                            const int (&lp)[Model::kD],
                                            ObsCursor& oc, int n,
                                            const T* xr, T* gx,
                                            AgPartials<T, kComp>& s) {
    if (oc.at(n, p.N_data)) {
#pragma unroll
        for (int d = 0; d < Model::kD; ++d) {
            if (lp[d] >= 0) {
                const T wv = p.W[oc.k * p.L + lp[d]];
                const T diff = xr[d] - p.Y[oc.k * p.L + lp[d]];
                gx[d] += T(2) * p.me_norm * wv * diff;
                s.misfit(wv, diff);
            }
        }
    }
    oc.pass(n, p.obs_stride);
}

// The one-step rules: the thread's gradient rows [n0, n1), residuals
// n0 - 1 .. n1 - 1 (it sums those of its rows, n0 .. n1 - 1).
template <typename Model, typename T, bool kComp, int kDisc, bool kDiag>
__device__ __forceinline__ void row_walk_onestep(
        const RowProblem<Model, T>& p, const T* x, T* g, const T* sp, T c2,
        int n0, int n1, AgPartials<T, kComp>& s, T* acc) {
    constexpr int D = Model::kD;
    const T hh = p.h / T(2);
    int lp[D];
#pragma unroll
    for (int d = 0; d < D; ++d) lp[d] = p.lpos[d];
    RowNode<Model, T> a, b;         // nodes n and n + 1
    T qp[D];                        // q_{n-1}
    load_node(p, x, sp, n0, a);
    if (n0 > 0) {                   // the halo residual n0 - 1
        load_node(p, x, sp, n0 - 1, b);
#pragma unroll
        for (int d = 0; d < D; ++d) {
            const T r = step_residual<kDisc>(b.x[d], a.x[d], b.nd.f[d],
                                             a.nd.f[d], hh, p.h);
            qp[d] = kDiag ? p.rfd[(size_t)(n0 - 1) * D + d] * r : r;
        }
    } else {
#pragma unroll
        for (int d = 0; d < D; ++d) qp[d] = T(0);
    }
    ObsCursor oc(n0, p.obs_stride);
    for (int n = n0; n < n1; ++n) {
        const bool has_next = n + 1 < p.N;
        if (has_next) load_node(p, x, sp, n + 1, b);
        T qc[D], v[D], jt[D], gx[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
            T q = T(0);
            if (has_next) {
                const T rr = step_residual<kDisc>(a.x[d], b.x[d], a.nd.f[d],
                                                  b.nd.f[d], hh, p.h);
                if constexpr (kDiag) {
                    q = p.rfd[(size_t)n * D + d] * rr;
                    s.weighted(q, rr);
                } else {
                    q = rr;
                    s.residual(rr);
                }
            }
            qc[d] = q;
            v[d] = kDisc == kWalkTrapezoid ? qp[d] + q : q;
        }
        Model::adjoint(a.x, sp, a.nd, v, jt, acc);
#pragma unroll
        for (int d = 0; d < D; ++d)
            gx[d] = step_grad<kDisc>(
                c2, kDisc == kWalkForwardMap ? qp[d] : qp[d] - qc[d], jt[d],
                hh, p.h);
        row_observe(p, lp, oc, n, a.x, gx, s);
#pragma unroll
        for (int d = 0; d < D; ++d) {
            g[(size_t)n * D + d] = gx[d];
            qp[d] = qc[d];
        }
        a = b;
    }
}

// Hermite-Simpson: the thread's steps [k0, k1) of the M + 1 (step k: row
// 2k and, for k < M, interval k and row 2k + 1), interval k0 - 1 the
// halo.
template <typename Model, typename T, bool kComp, bool kDiag>
__device__ __forceinline__ void row_walk_sh(
        const RowProblem<Model, T>& p, const T* x, T* g, const T* sp, T c2,
        int k0, int k1, AgPartials<T, kComp>& s, T* acc) {
    constexpr int D = Model::kD;
    const int M = (p.N - 1) / 2;
    const ShCoeffs<T> k6(p.h);
    int lp[D];
#pragma unroll
    for (int d = 0; d < D; ++d) lp[d] = p.lpos[d];
    RowNode<Model, T> e, m, o;      // rows 2k, 2k + 1, 2k + 2
    T ap[D], bp[D];                 // a_{k-1}, b_{k-1}
    load_node(p, x, sp, 2 * k0, e);
    if (k0 > 0) {
        load_node(p, x, sp, 2 * k0 - 2, o);
        load_node(p, x, sp, 2 * k0 - 1, m);
#pragma unroll
        for (int d = 0; d < D; ++d) {
            T sres, mres;
            sh_residuals(o.x[d], m.x[d], e.x[d], o.nd.f[d], m.nd.f[d],
                         e.nd.f[d], k6, sres, mres);
            ap[d] = kDiag ? p.rfd[(size_t)(2 * k0 - 2) * D + d] * sres : sres;
            bp[d] = kDiag ? p.rfd[(size_t)(2 * k0 - 1) * D + d] * mres : mres;
        }
    } else {
#pragma unroll
        for (int d = 0; d < D; ++d) ap[d] = bp[d] = T(0);
    }
    ObsCursor oc(2 * k0, p.obs_stride);
    for (int k = k0; k < k1; ++k) {
        const bool has_int = k < M;
        T ak[D], bk[D], v[D], jt[D], gx[D];
        if (has_int) {
            load_node(p, x, sp, 2 * k + 1, m);
            load_node(p, x, sp, 2 * k + 2, o);
#pragma unroll
            for (int d = 0; d < D; ++d) {
                T sres, mres;
                sh_residuals(e.x[d], m.x[d], o.x[d], e.nd.f[d], m.nd.f[d],
                             o.nd.f[d], k6, sres, mres);
                ak[d] = kDiag ? p.rfd[(size_t)(2 * k) * D + d] * sres : sres;
                bk[d] = kDiag ? p.rfd[(size_t)(2 * k + 1) * D + d] * mres
                              : mres;
                s.interval(ak[d], sres, bk[d], mres);
            }
        } else {
#pragma unroll
            for (int d = 0; d < D; ++d) ak[d] = bk[d] = T(0);
        }
        // row 2k
#pragma unroll
        for (int d = 0; d < D; ++d)
            v[d] = k6.h6 * (ap[d] + ak[d]) + k6.h8 * (bk[d] - bp[d]);
        Model::adjoint(e.x, sp, e.nd, v, jt, acc);
#pragma unroll
        for (int d = 0; d < D; ++d)
            gx[d] = c2 * ((ap[d] - ak[d]) - T(0.5) * (bp[d] + bk[d]) - jt[d]);
        row_observe(p, lp, oc, 2 * k, e.x, gx, s);
#pragma unroll
        for (int d = 0; d < D; ++d) g[(size_t)(2 * k) * D + d] = gx[d];
        if (has_int) {
            // row 2k + 1
#pragma unroll
            for (int d = 0; d < D; ++d) v[d] = k6.h23 * ak[d];
            Model::adjoint(m.x, sp, m.nd, v, jt, acc);
#pragma unroll
            for (int d = 0; d < D; ++d) gx[d] = c2 * (bk[d] - jt[d]);
            row_observe(p, lp, oc, 2 * k + 1, m.x, gx, s);
#pragma unroll
            for (int d = 0; d < D; ++d)
                g[(size_t)(2 * k + 1) * D + d] = gx[d];
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
            ap[d] = ak[d];
            bp[d] = bk[d];
        }
        e = o;
    }
}

// The walk, the sums and the parameter gradient of one member under rule
// kDisc at a scalar rf or (kDiag) the (N-1, D) rf p.rfd. Every thread of
// the group Grp calls it, after a barrier when other threads wrote x.
// Writes the gradient to g (n_dof values) and returns the action and the
// normalized ME to every thread; with kComp rank 0 also writes comp[0..5]
// = [me_hi, me_lo, fe1_hi, fe1_lo, fe2_hi, fe2_lo] (fe2 the Hermite
// plane's, zero under a one-step rule). area: row_area_elems(kComp,
// Grp::kWarps) values of the group's shared memory; every thread reads
// its partials before it reaches the group's next barrier. The estimated
// parameters' entries of g are written after the partials' barrier, each
// by the thread of rank (its index) % Grp::kSize, their owner in the
// solvers' strided passes; every other entry before it. Not inlined: one
// body for each rule and rf kind, whose registers stay its own in the
// solvers (l96_rule_walk's reason); the problem is copied on entry.
template <typename Model, typename T, bool kComp, typename Grp, int kDisc,
          bool kDiag>
__device__ __noinline__ AgSums<T> row_walk_block(
        const RowProblem<Model, T>& problem, const T* x, T rf,
        T* __restrict__ g, T* area, T* comp) {
    const RowProblem<Model, T> p = problem;
    constexpr int NP = Model::kNP, W = Grp::kWarps, S = row_sums<Model>();
    const unsigned rank = Grp::rank();
    const unsigned lane = rank & 31u, warp = rank >> 5;
    const int n_state = p.N * Model::kD;
    T* sp = area;
    T* red = area + Model::kNPX;
    auto raw = [&](int i) {
        const int e = p.pmap[i];
        return e >= 0 ? x[n_state + e] : p.pfix[i];
    };
    for (int j = (int)rank; j < Model::kNPX; j += Grp::kSize)
        sp[j] = Model::template stage<T>(raw, j);
    Grp::sync();
    const T c2 = kDiag ? T(2) * p.fe_norm : T(2) * p.fe_norm * rf;
    AgPartials<T, kComp> s;
    T acc[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) acc[j] = T(0);
    int r0, r1;
    if constexpr (kDisc == kWalkSimpsonHermite) {
        thread_range((p.N + 1) / 2, rank, Grp::kSize, r0, r1);
        if (r0 < r1)
            row_walk_sh<Model, T, kComp, kDiag>(p, x, g, sp, c2, r0, r1, s,
                                                acc);
    } else {
        thread_range(p.N, rank, Grp::kSize, r0, r1);
        if (r0 < r1)
            row_walk_onestep<Model, T, kComp, kDisc, kDiag>(p, x, g, sp, c2,
                                                            r0, r1, s, acc);
    }
    // fixed-order reduction: the warp's tree, then the warps in order
    s.fe = warp_sum(s.fe);
    s.me = warp_sum(s.me);
#pragma unroll
    for (int j = 0; j < NP; ++j) acc[j] = warp_sum(acc[j]);
    if (lane == 0) {
        red[warp] = s.fe;
        red[W + warp] = s.me;
#pragma unroll
        for (int j = 0; j < NP; ++j) red[(2 + j) * W + warp] = acc[j];
    }
    if constexpr (kComp) {
        warp_two_sum(s.me_hi, s.me_lo);
        warp_two_sum(s.fe_hi, s.fe_lo);
        warp_two_sum(s.f2_hi, s.f2_lo);
        if (lane == 0) {
            T* cr = red + S * W;
            cr[warp] = s.me_hi;
            cr[W + warp] = s.me_lo;
            cr[2 * W + warp] = s.fe_hi;
            cr[3 * W + warp] = s.fe_lo;
            cr[4 * W + warp] = s.f2_hi;
            cr[5 * W + warp] = s.f2_lo;
        }
    }
    Grp::sync();   // the warps' partials (and every row of g) complete
    T fe_t = red[0], me_t = red[W];
    for (int w = 1; w < W; ++w) {
        fe_t += red[w];
        me_t += red[W + w];
    }
    // estimated parameter j's entry, n_state + j, by its owner
    const int j = ((int)rank - n_state % Grp::kSize + Grp::kSize)
                  % Grp::kSize;
    if (j < p.n_est) {
        const T* pr = red + (2 + p.pidx[j]) * W;
        T t = pr[0];
        for (int w = 1; w < W; ++w) t += pr[w];
        const T k = kDisc == kWalkTrapezoid ? p.h / T(2)
                    : kDisc == kWalkEuler   ? p.h
                                            : T(1);
        g[n_state + j] = -(c2 * k) * t;
    }
    if constexpr (kComp) {
        if (rank == 0) {
            const T* cr = red + S * W;
#pragma unroll
            for (int q = 0; q < 3; ++q) {
                T hi = cr[2 * q * W], lo = cr[(2 * q + 1) * W];
                for (int w = 1; w < W; ++w)
                    two_join(hi, lo, cr[2 * q * W + w],
                             cr[(2 * q + 1) * W + w]);
                comp[2 * q] = hi;
                comp[2 * q + 1] = lo;
            }
        }
    }
    // rounded apart, as l96_walk_block's value
    const T me = mul_rn(p.me_norm, me_t);
    const T fe = kDiag ? fe_t : mul_rn(rf, fe_t);
    return AgSums<T>{add_rn(me, mul_rn(p.fe_norm, fe)), me};
}

// row_walk_block under the problem's rule and rf kind, chosen at run time
// (each pair its own not-inlined body, which K1/K4's entries and K2/K3's
// evaluation call alike).
template <typename Model, typename T, bool kComp = false,
          typename Grp = BlockGroup>
__device__ __forceinline__ AgSums<T> row_rule_block(
        const RowProblem<Model, T>& p, const T* x, T rf, T* __restrict__ g,
        T* area, T* comp = nullptr) {
    const bool diag = p.rfd != nullptr;
    switch (p.disc) {
        case kWalkEuler:
            return diag ? row_walk_block<Model, T, kComp, Grp, kWalkEuler,
                                         true>(p, x, rf, g, area, comp)
                        : row_walk_block<Model, T, kComp, Grp, kWalkEuler,
                                         false>(p, x, rf, g, area, comp);
        case kWalkForwardMap:
            return diag ? row_walk_block<Model, T, kComp, Grp,
                                         kWalkForwardMap, true>(
                              p, x, rf, g, area, comp)
                        : row_walk_block<Model, T, kComp, Grp,
                                         kWalkForwardMap, false>(
                              p, x, rf, g, area, comp);
        case kWalkSimpsonHermite:
            return diag ? row_walk_block<Model, T, kComp, Grp,
                                         kWalkSimpsonHermite, true>(
                              p, x, rf, g, area, comp)
                        : row_walk_block<Model, T, kComp, Grp,
                                         kWalkSimpsonHermite, false>(
                              p, x, rf, g, area, comp);
        default:
            return diag ? row_walk_block<Model, T, kComp, Grp,
                                         kWalkTrapezoid, true>(
                              p, x, rf, g, area, comp)
                        : row_walk_block<Model, T, kComp, Grp,
                                         kWalkTrapezoid, false>(
                              p, x, rf, g, area, comp);
    }
}

// The problem of an entry's arguments, and whether the entries take it:
// a rule of the walk (whole intervals under Hermite-Simpson), n_dof the
// states and the estimated parameters, at most kNP of them.
template <typename Model, typename T>
RowProblem<Model, T> row_problem(int n_dof, int N, const void* Y,
                                 const void* W, const void* lpos, int N_data,
                                 int L, int obs_stride, double h,
                                 double me_norm, double fe_norm, int disc,
                                 const void* rfd, const void* stim,
                                 const void* pfix, const void* pmap,
                                 const void* pidx, int n_est) {
    return RowProblem<Model, T>{
        n_dof, N, static_cast<const T*>(Y), static_cast<const T*>(W),
        static_cast<const int*>(lpos), N_data, L, obs_stride, (T)h,
        (T)me_norm, (T)fe_norm, disc, static_cast<const T*>(rfd),
        static_cast<const T*>(stim), static_cast<const T*>(pfix),
        static_cast<const int*>(pmap), static_cast<const int*>(pidx),
        n_est};
}

template <typename Model>
__host__ inline bool row_ok(int disc, int N, int n_dof, int n_est) {
    return disc >= kWalkTrapezoid && disc <= kWalkSimpsonHermite
           && N >= 2 && (disc != kWalkSimpsonHermite || N % 2 == 1)
           && n_est >= 0 && n_est <= Model::kNP
           && n_dof == N * Model::kD + n_est;
}

// The entries' arguments: the problem's, as row_problem takes them.
#define VA_ROW_ARGS                                                         \
    int n_dof, int N, const void *Y, const void *W, const void *lpos,      \
        int N_data, int L, int obs_stride, double h, double me_norm,       \
        double fe_norm, int disc, const void *rfd, const void *stim,       \
        const void *pfix, const void *pmap, const void *pidx, int n_est
#define VA_ROW_PASS                                                         \
    n_dof, N, Y, W, lpos, N_data, L, obs_stride, h, me_norm, fe_norm, disc, \
        rfd, stim, pfix, pmap, pidx, n_est
