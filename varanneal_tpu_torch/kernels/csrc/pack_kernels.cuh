// The kernel of K8 and its launch, generic over the problem type Prob:
// L96Problem<T> (the trapezoid rule with a scalar rf; pack_kernel.cu's
// entries, at G = 256, 64 and 32), L96RuleProblem<T> (Lorenz-96's other
// rules and the (N-1, D) rf; pack_rules_f32.cu and _f64.cu) or
// RowProblem<Model, T> (a row-level model; pack_models_*.cu), those two
// at G = 64 and 32. pack_kernel.cu's notes say what K8 computes, what
// bounds it and how; the body is l96_solve.cuh's solve_one over
// WarpGroup<G>, whose evaluation is the problem's (l96_ag_block,
// l96_rule_block or row_rule_block, each over the group).
//
// A packed member's evaluation area is sized for its group: ring_cols(p,
// G / 32). Lorenz-96's rings are D columns whatever the group; a
// row-level model's area (its staged parameter row and a warp's partials
// each) is sized by the group's warps, since a width for K2's eight warps
// would leave a group of one or two warps too little room (NaKL needs 44
// values at one warp, where eight warps' width gives 24), and its staged
// row and partials would run into the next group's area.
//
// At G = 256 (packs of 1 and 2, one member a block) K8 is K2's
// arrangement; the wrapper (kernels/solve_pack.py) launches the rules'
// and the row models' K2 entries there, so these problems instantiate
// the kernel at G = 64 and 32 only.

#pragma once

#include <cuda_runtime.h>

#include "l96_solve.cuh"

namespace {

constexpr int kPackMaxThreads = 256;

// Groups a block holds for a pack of `pack` at group size G.
inline int block_groups(int G, int pack) {
    return G == 256 ? 1 : pack;
}

// K8: blockIdx.x's `groups` members, member blockIdx.x * groups + the
// thread's group; outputs as K2's (x, g, fp = [f, pgnorm], cnt = [niter,
// nfev, status]) for members below B. Bounded: lo/hi hold the bounds,
// bnd_stride apart per member (0: shared by every member). `layout`: the
// groups of a member's vectors on chip (G = 256 only) and kRingOffChip.
template <typename Prob, typename T, int G, bool kBounded, int kChunk>
__global__ void __launch_bounds__(kPackMaxThreads, 1) l96_pack_kernel(
        Prob p, SolveOpts<T> o, T rf, int groups, int layout, int B,
        const T* __restrict__ XP, const T* __restrict__ lo,
        const T* __restrict__ hi, int bnd_stride, T* __restrict__ work,
        T* __restrict__ X_out, T* __restrict__ G_out,
        T* __restrict__ fp_out, int* __restrict__ cnt_out) {
    using Grp = WarpGroup<G>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int b = blockIdx.x * groups + Grp::id();
    if (b >= B) return;             // no barrier is shared across groups
    const int n = p.n_dof;
    // ring_cols at each use, as K8's Lorenz-96 entries read p.D there:
    // their code, and the ptxas lines phase 32 (a) holds, stay as built
    T* s = reinterpret_cast<T*>(smem_raw)
           + (size_t)Grp::id()
                 * layout_smem_elems(ring_cols(p, Grp::kWarps), n, o.m,
                                     layout, Grp::kWarps);
    T* work_b = work + (size_t)b * work_elems(n, o.m,
                                              ring_cols(p, Grp::kWarps),
                                              layout, Grp::kWarps);
    const Smem<T> sm = group_smem(s, work_b, n, o.m,
                                  ring_cols(p, Grp::kWarps), layout,
                                  Grp::kWarps);
    T* chip = s + solve_smem_elems(ring_cols(p, Grp::kWarps), Grp::kWarps,
                                   !(layout & kRingOffChip));
    Bufs<T> w = member_bufs(chip, work_b, n, o.m, layout);
    Box<T> bx{nullptr, nullptr};
    if (kBounded) {
        const T* lo_b = lo + (size_t)b * bnd_stride;
        const T* hi_b = hi + (size_t)b * bnd_stride;
        if (layout & kBoundsOnChip) {      // each thread its own entries
            T* lc = chip_bounds(chip, n, o.m, layout);
            for (int k = Grp::rank(); k < n; k += G) {
                lc[k] = lo_b[k];
                lc[n + k] = hi_b[k];
            }
            bx = Box<T>{lc, lc + n};
        } else {
            bx = Box<T>{lo_b, hi_b};
        }
    }
    for (int k = Grp::rank(); k < n; k += G) w.x[k] = XP[(size_t)b * n + k];
    const SolveResult<T> r =
        solve_one<Grp, kBounded, kChunk>(p, rf, o, w, bx, sm);
    for (int k = Grp::rank(); k < n; k += G) {
        X_out[(size_t)b * n + k] = w.x[k];
        G_out[(size_t)b * n + k] = w.g[k];
    }
    if (Grp::rank() == 0) {
        fp_out[2 * b] = r.f;
        fp_out[2 * b + 1] = r.pgnorm;
        cnt_out[3 * b] = r.niter;
        cnt_out[3 * b + 1] = r.nfev;
        cnt_out[3 * b + 2] = r.status;
    }
}

template <typename Prob, typename T>
using PackFn = void (*)(Prob, SolveOpts<T>, T, int, int, int, const T*,
                        const T*, const T*, int, T*, T*, T*, T*, int*);

// The kernel of a G = 64 or 32 launch of (Prob, T, bounded) under
// `layout` (0 or kRingOffChip: every vector in the workspace), or nullptr.
template <typename Prob, typename T>
PackFn<Prob, T> group_pack_fn(int G, bool bounded, int layout) {
    if ((layout & ~kRingOffChip) != 0) return nullptr;
    switch (G) {
        case 64:
            return bounded ? &l96_pack_kernel<Prob, T, 64, true, kChunkGlobal>
                           : &l96_pack_kernel<Prob, T, 64, false,
                                              kChunkGlobal>;
        case 32:
            return bounded ? &l96_pack_kernel<Prob, T, 32, true, kChunkGlobal>
                           : &l96_pack_kernel<Prob, T, 32, false,
                                              kChunkGlobal>;
        default: return nullptr;
    }
}

// The attributes of a kernel: out = [registers a thread, local memory a
// thread in bytes (spills and stack), the most threads a block can launch
// with].
inline int pack_attrs_of(const void* fn, int* out) {
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, fn);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = a.maxThreadsPerBlock;
    return 0;
}

// K8 on the problem p under the options o through the kernel fn (nullptr:
// none built for the launch's G, bound and layout): the batch of B
// members in blocks of block_groups(G, pack) groups of G threads, each
// group's area sized by ring_cols(p, G / 32).
template <typename T, typename Prob>
int launch_pack(PackFn<Prob, T> fn, const Prob& p, const SolveOpts<T>& o,
                int B, int pack, int G, int layout, double rf,
                const void* XP, const void* lo, const void* hi,
                int bnd_stride, void* work, void* X_out, void* G_out,
                void* fp_out, void* cnt_out, void* stream) {
    if (o.m < 1 || o.m > kMaxM || fn == nullptr || pack < 1
            || block_groups(G, pack) * G > kPackMaxThreads
            || (lo == nullptr) != (hi == nullptr))
        return (int)cudaErrorInvalidValue;
    const int groups = block_groups(G, pack);
    const size_t smem =
        (size_t)groups
        * layout_smem_elems(ring_cols(p, G / 32), p.n_dof, o.m, layout,
                            G / 32)
        * sizeof(T);
    const cudaError_t e = opt_in(fn, smem);
    if (e != cudaSuccess) return (int)e;
    fn<<<(B + groups - 1) / groups, groups * G, smem,
         (cudaStream_t)stream>>>(
        p, o, (T)rf, groups, layout, B, static_cast<const T*>(XP),
        static_cast<const T*>(lo), static_cast<const T*>(hi), bnd_stride,
        static_cast<T*>(work), static_cast<T*>(X_out),
        static_cast<T*>(G_out), static_cast<T*>(fp_out),
        static_cast<int*>(cnt_out));
    return (int)cudaGetLastError();
}

}  // namespace

// The entries of K8 on the row-level model MODEL in T (name, sfx: their
// names' parts). Arguments: the batch XP (B, n_dof), ag_models_kernel.cu's
// problem (VA_ROW_ARGS, the (N-1, D) rf rfd among them), the options as
// solve_kernel.cu's entries take them, then the pack, the group size G
// (64 or 32, pack * G <= 256), the layout (0 or kRingOffChip), the scalar
// rf, the box (lo/hi NULL when unbounded, bnd_stride 0 when shared by the
// members), the workspace (B, work_elems(n_dof, m, ring_cols(p, G / 32),
// layout, G / 32)) and K2's outputs. Each returns the cudaError_t of the
// launch; _attrs gives the kernel's attributes as va_l96_pack_attrs.
#define VA_ROW_PACK_ENTRIES(MODEL, T, name, sfx)                            \
    int va_##name##_pack_##sfx(                                             \
            const void* XP, int B, VA_ROW_ARGS, int m, int maxiter,         \
            int maxls, double c1, double c2, double pgtol, double ftol,     \
            int pack, int G, int layout, double rf, const void* lo,         \
            const void* hi, int bnd_stride, void* work, void* X_out,        \
            void* G_out, void* fp_out, void* cnt_out, void* stream) {       \
        if (!row_ok<MODEL>(disc, N, n_dof, n_est))                          \
            return (int)cudaErrorInvalidValue;                              \
        return launch_pack<T>(                                              \
            group_pack_fn<RowProblem<MODEL, T>, T>(G, lo != nullptr,        \
                                                   layout),                 \
            row_problem<MODEL, T>(VA_ROW_PASS),                             \
            solve_opts<T>(m, maxiter, maxls, c1, c2, pgtol, ftol), B, pack, \
            G, layout, rf, XP, lo, hi, bnd_stride, work, X_out, G_out,      \
            fp_out, cnt_out, stream);                                       \
    }                                                                       \
    int va_##name##_pack_attrs_##sfx(int G, int bounded, int layout,        \
                                     int* out) {                            \
        return pack_attrs_of(                                               \
            (const void*)group_pack_fn<RowProblem<MODEL, T>, T>(            \
                G, bounded != 0, layout),                                   \
            out);                                                           \
    }                                                                       \
    const char* va_cuda_error_string(int code) {                            \
        return cudaGetErrorString((cudaError_t)code);                       \
    }

// The entries of K8 under Lorenz-96's other rules in T (sfx: their names'
// part): Euler, the forward map, Hermite-Simpson and the trapezoid rule
// with a scalar or (N-1, D) rf (every pair but trapezoid/scalar, which is
// pack_kernel.cu's), each evaluation l96_rule_block over the group.
// Arguments as va_l96_pack_<sfx> (pack_kernel.cu) at G = 64 or 32, plus
// disc (0 trapezoid, with an (N-1, D) rf only; 1 euler, 2 forwardmap, 3
// SimpsonHermite with N odd) and rfd: the (N-1, D) rf (a device pointer
// of T), or NULL for the scalar rf. A source that expands this includes
// l96_solve_rules.cuh first.
#define VA_RULE_PACK_ENTRIES(T, sfx)                                        \
    int va_l96_rule_pack_##sfx(VA_SOLVE_ARGS, int pack, int G, int layout,  \
                               int disc, double rf, const void* rfd,        \
                               const void* lo, const void* hi,              \
                               int bnd_stride, void* work, void* X_out,     \
                               void* G_out, void* fp_out, void* cnt_out,    \
                               void* stream) {                              \
        if (!rule_ok(disc, N, rfd != nullptr))                              \
            return (int)cudaErrorInvalidValue;                              \
        return launch_pack<T>(                                              \
            group_pack_fn<L96RuleProblem<T>, T>(G, lo != nullptr, layout),  \
            rule_problem(VA_PROBLEM(T), disc, rfd), VA_OPTS(T), B, pack, G, \
            layout, rf, XP, lo, hi, bnd_stride, work, X_out, G_out, fp_out, \
            cnt_out, stream);                                               \
    }                                                                       \
    int va_l96_rule_pack_attrs_##sfx(int G, int bounded, int layout,        \
                                     int* out) {                            \
        return pack_attrs_of(                                               \
            (const void*)group_pack_fn<L96RuleProblem<T>, T>(               \
                G, bounded != 0, layout),                                   \
            out);                                                           \
    }                                                                       \
    const char* va_cuda_error_string(int code) {                            \
        return cudaGetErrorString((cudaError_t)code);                       \
    }
