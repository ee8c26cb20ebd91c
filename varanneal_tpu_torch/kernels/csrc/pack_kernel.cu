// K8 on Hopper: the whole L-BFGS rung solves of k members (a pack) in one
// thread block, each member solved by its own warp-aligned group of G
// threads.
//
// Replaces varanneal_tpu/kernels/solve_pack_pallas.py::_pack_kernel
// (launched by _pack_batched), which packs k members into one grid program
// of the TPU and runs them in lockstep through one shared loop
// (shared_line_search, shared_proj_ls), a member that is done masked to a
// frozen no-op, so that each member's iterates, niter, nfev and status are
// those of the one-member kernel (solve_pallas.py::_solve_kernel, K2).
// That is the function: per member exactly what K2 computes, unbounded or,
// with box bounds, by the projection algorithm. Lockstep was how the TPU's
// one instruction stream interleaved k independent chains; on the card
// warps of different members interleave by themselves, so here each group
// runs its member's solve independently (solve_one of l96_solve.cuh over
// WarpGroup<G>), and no group ever waits for another: a member that
// finishes early leaves its group's threads idle, as a masked member left
// its lanes idle on the TPU. Every barrier inside a solve is the group's
// named barrier (bar.sync 1 + group, G): a __syncthreads() there would
// deadlock once the groups' control flow parts.
//
// Groups and registers. G = 256 for packs of 1 or 2, 128 for 3 or 4, 64
// for 5 to 8 (the wrapper's choice, solve_pack.pack_group). A block holds
// at most 65,536 registers: k groups of G threads in one block would give
// each thread at most 65,536 / (k G), and at 128 (k G = 512) the solver
// and the evaluation's walk spill. So at G = 256 a block holds one group
// (__launch_bounds__(256, 1), up to 255 registers a thread, as K2 and K3
// have) and a pack of 2 is two blocks; at G = 128 and 64 a block holds
// the pack's groups within kPackMaxThreads = 512 threads
// (__launch_bounds__(512, 1): 128 registers a thread; without the 1, nvcc
// held the kernel to 64), and spills (PERF.md §6). At G = 256 a member's
// arithmetic, its reduction order included, is K2's, so its outputs equal
// K2's bit for bit; at smaller G the strided partials and the warp tree
// are summed in another order, and the outputs differ from K2's by
// rounding only.
//
// Memory: each group of a block has its own shared area (the solver's two
// partials areas, which the evaluation's partials share, alpha, and the
// evaluation's rings of rows: solve_smem_elems(D, G / 32) values), so a
// block needs its groups' times one member's; where they do not fit in
// 227 KB (layout 8, kRingOffChip) the rings go to the members' workspaces.
// Each member's vectors and history live in its own slice of the global
// workspace, work_elems(n_dof, m, D, layout, G / 32) values, as in K2's
// global layout (K2 and K3 keep them in shared memory where they fit; a
// pack's layout is not redesigned). The wrapper pads a
// batch to a multiple of the pack by repeating the last member and drops
// the padding's outputs (the reference's semantics).
//
// What bounds it on the card: as K2, the serial depth of each member's
// chain of evaluations and group reductions (L2 latency and barriers, one
// a reduction, as l96_solve.cuh says),
// far from bytes or operations; a pack puts k such chains on one SM
// instead of k SMs, so it can only be faster than K2 where the card has
// more members than SMs, or where the chains' latencies overlap well.
// Sums are reduced in a fixed order with no atomics: a repeated launch
// gives bit-identical outputs.

#include <cuda_runtime.h>

#include "l96_solve.cuh"

namespace {

constexpr int kPackMaxThreads = 512;

// Threads a block of group size G may have: one group at G = 256, else
// kPackMaxThreads (the kernel's launch bound).
template <int G>
constexpr int block_threads() {
    return G == 256 ? 256 : kPackMaxThreads;
}

// Groups a block holds for a pack of `pack` at group size G.
inline int block_groups(int G, int pack) {
    return G == 256 ? 1 : pack;
}

// K8: blockIdx.x's `groups` members, member blockIdx.x * groups + the
// thread's group; outputs as K2's (x, g, fp = [f, pgnorm], cnt = [niter,
// nfev, status]) for members below B. Bounded: lo/hi hold the bounds,
// bnd_stride apart per member (0: shared by every member).
template <typename T, int G, bool kBounded>
__global__ void __launch_bounds__(block_threads<G>(), 1) l96_pack_kernel(
        L96Problem<T> p, SolveOpts<T> o, T rf, int groups, int layout, int B,
        const T* __restrict__ XP, const T* __restrict__ lo,
        const T* __restrict__ hi, int bnd_stride, T* __restrict__ work,
        T* __restrict__ X_out, T* __restrict__ G_out,
        T* __restrict__ fp_out, int* __restrict__ cnt_out) {
    using Grp = WarpGroup<G>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int b = blockIdx.x * groups + Grp::id();
    if (b >= B) return;             // no barrier is shared across groups
    const int n = p.n_dof;
    T* s = reinterpret_cast<T*>(smem_raw)
           + (size_t)Grp::id()
                 * solve_smem_elems(p.D, Grp::kWarps,
                                    !(layout & kRingOffChip));
    T* work_b = work + (size_t)b * work_elems(n, o.m, p.D, layout,
                                              Grp::kWarps);
    const Smem<T> sm = group_smem(s, work_b, n, o.m, p.D, layout,
                                  Grp::kWarps);
    Bufs<T> w = member_bufs(s, work_b, n, o.m, 0);
    const Box<T> bx = kBounded
        ? Box<T>{lo + (size_t)b * bnd_stride, hi + (size_t)b * bnd_stride}
        : Box<T>{nullptr, nullptr};
    for (int k = Grp::rank(); k < n; k += G) w.x[k] = XP[(size_t)b * n + k];
    const SolveResult<T> r =
        solve_one<Grp, kBounded, kChunkGlobal>(p, rf, o, w, bx, sm);
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

template <typename T, int G, bool kBounded>
const void* pack_fn() {
    return (const void*)l96_pack_kernel<T, G, kBounded>;
}

// The kernel for (T, G, bounded), or nullptr for a G that is not built.
template <typename T>
const void* pack_fn_for(int G, bool bounded) {
    switch (G) {
        case 256: return bounded ? pack_fn<T, 256, true>()
                                 : pack_fn<T, 256, false>();
        case 128: return bounded ? pack_fn<T, 128, true>()
                                 : pack_fn<T, 128, false>();
        case 64: return bounded ? pack_fn<T, 64, true>()
                                : pack_fn<T, 64, false>();
        default: return nullptr;
    }
}

template <typename T, int G, bool kBounded>
void launch_g(const L96Problem<T>& p, const SolveOpts<T>& o, double rf,
              int pack, int layout, int B, const void* XP, const void* lo,
              const void* hi, int bnd_stride, void* work, void* X_out,
              void* G_out, void* fp_out, void* cnt_out, size_t smem,
              void* stream) {
    const int groups = block_groups(G, pack);
    l96_pack_kernel<T, G, kBounded>
        <<<(B + groups - 1) / groups, groups * G, smem,
           (cudaStream_t)stream>>>(
            p, o, (T)rf, groups, layout, B, static_cast<const T*>(XP),
            static_cast<const T*>(lo), static_cast<const T*>(hi),
            bnd_stride, static_cast<T*>(work), static_cast<T*>(X_out),
            static_cast<T*>(G_out), static_cast<T*>(fp_out),
            static_cast<int*>(cnt_out));
}

template <typename T, int G>
void launch_bounded(bool bounded, const L96Problem<T>& p,
                    const SolveOpts<T>& o, double rf, int pack, int layout,
                    int B, const void* XP, const void* lo, const void* hi,
                    int bnd_stride, void* work, void* X_out, void* G_out,
                    void* fp_out, void* cnt_out, size_t smem,
                    void* stream) {
    if (bounded)
        launch_g<T, G, true>(p, o, rf, pack, layout, B, XP, lo, hi,
                             bnd_stride, work, X_out, G_out, fp_out,
                             cnt_out, smem, stream);
    else
        launch_g<T, G, false>(p, o, rf, pack, layout, B, XP, lo, hi,
                              bnd_stride, work, X_out, G_out, fp_out,
                              cnt_out, smem, stream);
}

template <typename T>
int launch_pack(const void* XP, int B, int n_dof, int N, int D, int pslot,
                double F_fixed, const void* Y, const void* W,
                const void* lidx, const void* lpos, int N_data, int L,
                int obs_stride, double h, double me_norm, double fe_norm,
                int m, int maxiter, int maxls, double c1, double c2,
                double pgtol, double ftol, int pack, int G, int layout,
                double rf, const void* lo, const void* hi, int bnd_stride,
                void* work, void* X_out, void* G_out, void* fp_out,
                void* cnt_out, void* stream) {
    const bool bounded = lo != nullptr;
    const void* fn = pack_fn_for<T>(G, bounded);
    if (m < 1 || m > kMaxM || fn == nullptr || pack < 1
            || pack * G > kPackMaxThreads
            || (lo == nullptr) != (hi == nullptr)
            || (layout & ~kRingOffChip) != 0)
        return (int)cudaErrorInvalidValue;
    const size_t smem =
        (size_t)block_groups(G, pack)
        * solve_smem_elems(D, G / 32, !(layout & kRingOffChip)) * sizeof(T);
    const cudaError_t e = opt_in(fn, smem);
    if (e != cudaSuccess) return (int)e;
    const L96Problem<T> p = problem<T>(n_dof, N, D, pslot, F_fixed, Y, W,
                                       lidx, lpos, N_data, L, obs_stride, h,
                                       me_norm, fe_norm);
    const SolveOpts<T> o = solve_opts<T>(m, maxiter, maxls, c1, c2, pgtol,
                                         ftol);
    switch (G) {
        case 256:
            launch_bounded<T, 256>(bounded, p, o, rf, pack, layout, B, XP,
                                   lo, hi, bnd_stride, work, X_out, G_out,
                                   fp_out, cnt_out, smem, stream);
            break;
        case 128:
            launch_bounded<T, 128>(bounded, p, o, rf, pack, layout, B, XP,
                                   lo, hi, bnd_stride, work, X_out, G_out,
                                   fp_out, cnt_out, smem, stream);
            break;
        default:
            launch_bounded<T, 64>(bounded, p, o, rf, pack, layout, B, XP,
                                  lo, hi, bnd_stride, work, X_out, G_out,
                                  fp_out, cnt_out, smem, stream);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess). The
// arguments are K2's (solve_kernel.cu) plus the pack and the group size
// G (256, 128 or 64, pack * G <= 512; at G = 256 one member a block),
// with a layout of 0 or 8 (every vector in the workspace, and with 8 the
// evaluation's rings too: (B, work_elems(n_dof, m, D, layout, G / 32)));
// B members, padded by the caller to a multiple of the pack or not
// (members from B on are not computed).
int va_l96_pack_f32(VA_SOLVE_ARGS, int pack, int G, int layout, double rf,
                    const void* lo, const void* hi, int bnd_stride,
                    void* work, void* X_out, void* G_out, void* fp_out,
                    void* cnt_out, void* stream) {
    return launch_pack<float>(VA_SOLVE_PASS, pack, G, layout, rf, lo, hi,
                              bnd_stride, work, X_out, G_out, fp_out,
                              cnt_out, stream);
}

int va_l96_pack_f64(VA_SOLVE_ARGS, int pack, int G, int layout, double rf,
                    const void* lo, const void* hi, int bnd_stride,
                    void* work, void* X_out, void* G_out, void* fp_out,
                    void* cnt_out, void* stream) {
    return launch_pack<double>(VA_SOLVE_PASS, pack, G, layout, rf, lo, hi,
                               bnd_stride, work, X_out, G_out, fp_out,
                               cnt_out, stream);
}

// The built kernel's attributes for (G, f64, bounded): out = [registers a
// thread, local memory a thread in bytes (spills and stack), the most
// threads a block can launch with].
int va_l96_pack_attrs(int G, int f64, int bounded, int* out) {
    const void* fn = f64 ? pack_fn_for<double>(G, bounded != 0)
                         : pack_fn_for<float>(G, bounded != 0);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, fn);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = a.maxThreadsPerBlock;
    return 0;
}

const char* va_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
