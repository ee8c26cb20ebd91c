// K8 on Hopper: the whole L-BFGS rung solves of k members (a pack) in one
// thread block, each member solved by its own warp-aligned group of G
// threads.
//
// This source holds K8's entries on Lorenz-96 under the trapezoid rule
// with a scalar rf; the kernel is pack_kernels.cuh's, generic over the
// problem, which pack_rules_f32.cu / _f64.cu (Lorenz-96's other rules and
// the (N-1, D) rf) and pack_models_<model>_<f32|f64>.cu (NaKL, Colpitts,
// Lorenz-63) instantiate at G = 64 and 32 too. The notes below hold for
// every problem; a row-level model's evaluation is the walk by thread of
// row_ag_block.cuh, whose area takes the place of the rings.
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
// own (the named barrier bar.sync 1 + group, G; __syncwarp for a group of
// one warp): a __syncthreads() there would deadlock once the groups'
// control flow parts.
//
// Groups and registers. G = 256 for packs of 1 or 2, 64 for 3 or 4, 32
// for 5 to 8 (the wrapper's choice, solve_pack.pack_group). A block holds
// at most kPackMaxThreads = 256 threads (__launch_bounds__(256, 1)), so
// each thread may keep up to 255 registers, as K2's and K3's do: 65,536
// registers / 255 leave room for 256 threads. The first port put a pack of
// 3–8 into 512 threads, which capped a thread at 128 registers, and the
// solver's walk spilled (472 B of local memory in f32). Smaller groups
// were chosen over a pack spread across two blocks: a group's barrier
// stays a named barrier (or the warp's own), and a member never needs
// another block. At G = 256 a block holds one group and a pack of 2 is
// two blocks; at G = 64 and 32 a block holds the pack's groups. At G = 256
// a member's arithmetic, its reduction order included, is K2's, so its
// outputs equal K2's bit for bit; at smaller G the strided partials and
// the warp tree are summed in another order, and the outputs differ from
// K2's by rounding only.
//
// Memory. At G = 256 (one member a block) the kernel takes K2's layout
// plan, kernels/solve.plan_layout itself: a member's vectors, history and
// bounds in shared memory where they fit, at up to one member an SM, else
// in its global workspace, with the layout's chunk (chunk_of) and the
// parent's bits in every layout, as K2. At G = 64 and 32 each group of a
// block has its own shared area (the solver's two partials areas, which
// the evaluation's partials share, alpha, and the evaluation's rings of
// rows: solve_smem_elems(ring_cols(p, G / 32), G / 32) values), so a block needs its groups'
// times one member's; where they do not fit in 227 KB (layout 8,
// kRingOffChip) the rings go to the members' workspaces. There each
// member's vectors and history live in its own slice of the global
// workspace, work_elems(n_dof, m, D, layout, G / 32) values: k members'
// vectors (5 n_dof values each, 64 KB at the main shape in f32) do not fit
// beside each other. The wrapper pads a batch to a multiple of the pack by
// repeating the last member and drops the padding's outputs (the
// reference's semantics).
//
// What bounds it on the card: as K2, the serial depth of each member's
// chain of evaluations and group reductions (L2 latency and barriers, one
// a reduction, as l96_solve.cuh says), far from bytes or operations; a
// pack puts k such chains on one SM instead of k SMs, so it can only be
// faster than K2 where the card has more members than SMs, and there only
// if k chains of G threads finish before k one-block chains of K2 would,
// wave after wave.
// Sums are reduced in a fixed order with no atomics: a repeated launch
// gives bit-identical outputs.

#include <cuda_runtime.h>

#include "pack_kernels.cuh"

namespace {

template <typename T>
using L96PackFn = PackFn<L96Problem<T>, T>;

template <typename T, int G, bool kBounded>
L96PackFn<T> pack_fn_chunk(int chunk) {
    using P = L96Problem<T>;
    if (chunk == 1) return &l96_pack_kernel<P, T, G, kBounded, 1>;
    return &l96_pack_kernel<P, T, G, kBounded, kChunkGlobal>;
}

// The kernel a launch of (T, G, bounded) under `layout` runs, or nullptr
// for a G that is not built or a layout it does not take (vectors on chip
// only at G = 256, one member a block; the box on chip only bounded).
template <typename T>
L96PackFn<T> pack_fn_for(int G, bool bounded, int layout) {
    if ((layout & ~kLayoutFlags) != 0
            || (!bounded && (layout & kBoundsOnChip))
            || (G != 256 && (layout & ~kRingOffChip) != 0))
        return nullptr;
    const int chunk = chunk_of(layout);
    switch (G) {
        case 256: return bounded ? pack_fn_chunk<T, 256, true>(chunk)
                                 : pack_fn_chunk<T, 256, false>(chunk);
        case 64:
            return bounded
                ? &l96_pack_kernel<L96Problem<T>, T, 64, true, kChunkGlobal>
                : &l96_pack_kernel<L96Problem<T>, T, 64, false, kChunkGlobal>;
        case 32:
            return bounded
                ? &l96_pack_kernel<L96Problem<T>, T, 32, true, kChunkGlobal>
                : &l96_pack_kernel<L96Problem<T>, T, 32, false, kChunkGlobal>;
        default: return nullptr;
    }
}

template <typename T>
int launch_l96_pack(const void* XP, int B, int n_dof, int N, int D,
                    int pslot, double F_fixed, const void* Y, const void* W,
                    const void* lidx, const void* lpos, int N_data, int L,
                    int obs_stride, double h, double me_norm,
                    double fe_norm, int m, int maxiter, int maxls, double c1,
                    double c2, double pgtol, double ftol, int pack, int G,
                    int layout, double rf, const void* lo, const void* hi,
                    int bnd_stride, void* work, void* X_out, void* G_out,
                    void* fp_out, void* cnt_out, void* stream) {
    return launch_pack<T>(
        pack_fn_for<T>(G, lo != nullptr, layout),
        problem<T>(n_dof, N, D, pslot, F_fixed, Y, W, lidx, lpos, N_data, L,
                   obs_stride, h, me_norm, fe_norm),
        solve_opts<T>(m, maxiter, maxls, c1, c2, pgtol, ftol), B, pack, G,
        layout, rf, XP, lo, hi, bnd_stride, work, X_out, G_out, fp_out,
        cnt_out, stream);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess). The
// arguments are K2's (solve_kernel.cu) plus the pack and the group size
// G (256, 64 or 32; pack * G <= 256 below 256; at G = 256 one member a
// block), with a layout: at G = 256 any of K2's (the groups of a member's
// vectors on chip, solve.plan_layout), else 0 or 8 (every vector in the
// workspace, and with 8 the evaluation's rings too). work is (B,
// work_elems(n_dof, m, D, layout, G / 32)); B members, padded by the
// caller to a multiple of the pack or not (members from B on are not
// computed).
int va_l96_pack_f32(VA_SOLVE_ARGS, int pack, int G, int layout, double rf,
                    const void* lo, const void* hi, int bnd_stride,
                    void* work, void* X_out, void* G_out, void* fp_out,
                    void* cnt_out, void* stream) {
    return launch_l96_pack<float>(VA_SOLVE_PASS, pack, G, layout, rf, lo,
                                  hi, bnd_stride, work, X_out, G_out,
                                  fp_out, cnt_out, stream);
}

int va_l96_pack_f64(VA_SOLVE_ARGS, int pack, int G, int layout, double rf,
                    const void* lo, const void* hi, int bnd_stride,
                    void* work, void* X_out, void* G_out, void* fp_out,
                    void* cnt_out, void* stream) {
    return launch_l96_pack<double>(VA_SOLVE_PASS, pack, G, layout, rf, lo,
                                   hi, bnd_stride, work, X_out, G_out,
                                   fp_out, cnt_out, stream);
}

// A block's dynamic shared memory in bytes for a pack of `pack` at group
// size G under `layout`, as the launches compute it.
long long va_l96_pack_smem(int D, int n_dof, int m, int pack, int G,
                           int layout, int f64) {
    return (long long)block_groups(G, pack)
           * (long long)layout_smem_elems(D, n_dof, m, layout, G / 32)
           * (f64 ? sizeof(double) : sizeof(float));
}

// The built kernel's attributes for (G, f64, bounded) under `layout`:
// out = [registers a thread, local memory a thread in bytes (spills and
// stack), the most threads a block can launch with].
int va_l96_pack_attrs(int G, int f64, int bounded, int layout, int* out) {
    return pack_attrs_of(
        f64 ? (const void*)pack_fn_for<double>(G, bounded != 0, layout)
            : (const void*)pack_fn_for<float>(G, bounded != 0, layout),
        out);
}

const char* va_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
