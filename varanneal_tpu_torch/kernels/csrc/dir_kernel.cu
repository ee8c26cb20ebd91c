// K7a and K7b on Hopper: the compact-form L-BFGS direction (K7a) and the
// fused post-line-search step (K7b), one thread-block cluster per
// ensemble member, float32.
//
// Replaces varanneal_tpu/kernels/dir_pallas.py::_dir_kernel (K7a,
// launched by _dir_batched) and ::_step_kernel (K7b, launched by
// _step_batched), whose shared body _dir_math is the device routine
// compact_direction below:
//
//   Hinv g = γg + [S γY] [[R^{-T}(D+γYᵀY)R^{-1}, -R^{-T}], [-R^{-1}, 0]]
//                [Sᵀg; γYᵀg],   R = triu(SᵀY), D = diag(SᵀY),
//   d = -Hinv g, γ = s_newᵀy_new / max(y_newᵀy_new, 1e-30) (1 if empty),
//
// over a circular history of m pairs, with the chronological reorder of
// the slots (slot (head - m + j) mod m holds the j-th oldest pair, the
// first m - hlen invalid: their rows and columns masked out and a unit
// diagonal put into R). K7b adds, before it, the curvature gate
// ls_ok & sᵀy > 1e-10·sqrt(sᵀs·yᵀy) & sᵀy > 0 on s = x_new - x_old,
// y = g_new - g_old, the history write of s and y at head when the gate
// holds, and max|g_new|, Σ|g_new|; after it, the -g_new fallback on a
// non-descent direction and the next line search's g_newᵀd (the
// reference's explicit gᵀd, dir_pallas.py:259-261). A member whose loop
// has ended (run = 0) keeps its history, head and hlen bit for bit, the
// lockstep rule of opt/lbfgs.py.
//
// The port's layout: the history is the joint (B, 2m, n) tensor of
// opt/lbfgs.py (rows [0, m) the steps, [m, 2m) the gradient
// differences), g and the vectors are (B, n). The TPU kernel's (16,
// n_pad) augmented block, its one-hot selection matmuls (Mosaic could
// neither slice rows nor gather) and its 128-lane padding have no
// counterpart: each thread reads its own entries of every row, and the
// chronological reorder is index arithmetic.
//
// What bounds it on the card. Per member the function reads 2m + 1 rows
// of n values (K7b: 2m + 4) and writes d (K7b: and s, y into the
// history): at the main shape (n = 3,221, m = 5, B = 4) ~0.2 MB a member
// and ~0.5 MFLOP, a fraction of a microsecond at the card's rates. So
// the launch is bound by latency: the depth of its dependent phases and
// how many SMs a member's bytes pass through. The first port ran one
// 256-thread block a member (4 of 132 SMs at B = 4), read the history
// twice (for the Gram and for the contraction) and made three dependent
// block reductions with thread 0's (m, m) solve between them. This
// design:
//
// - A member is a cluster of c blocks (cooperative_groups::this_cluster,
//   launched by cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension,
//   c <= 8, the portable limit), on c SMs; block r owns the contiguous
//   column slice [r W, (r + 1) W). kernels/dir.py::cluster_plan chooses c,
//   W and the rows a slice keeps on chip from n, m, B and the SM count
//   (one block for every 512 columns, fewer where B fills the card).
// - One read pass. A block copies its slice of the 2m history rows and of
//   g (K7b: x_new, g_old and g_new; x_old through registers) into shared
//   memory by cp.async, every copy in flight at once, before it reads its
//   flags. From there it forms s and y in place and accumulates in
//   registers, in the same pass, every sum the launch needs: the Gram of
//   the history with g (m² sᵢ·yⱼ, m(m+1)/2 yᵢ·yⱼ, sᵢ·g, yᵢ·g), and for K7b
//   the new pair against every slot and g (s·yⱼ, sᵢ·y, y·yⱼ, s·g, y·g) and
//   the gate's sᵀy, sᵀs, yᵀy, Σ|g|, Σg², max|g|. The gate then picks,
//   after the reduction, which pair slot head holds: the Gram of the
//   updated history is read from these sums (GramView), with no pass of
//   its own.
// - One reduction before the solve. A warp reduce-scatter (each shuffle
//   step halves the values a lane carries: ~K shuffles for K sums, where
//   a shuffle tree per sum takes 5K), the warps summed in order; then each
//   block stores its totals into every block's inbox in distributed
//   shared memory (st.async, each store counted on the receiver's
//   mbarrier, which completes when all c blocks' bytes have landed), and
//   every block sums the inbox in rank order. So every block has the same
//   bits; the block's threads lay out the (m, m) system in parallel and
//   thread 0 solves it, with no broadcast. The only cluster barrier is a
//   split one around the read pass (arrive once the mbarriers are set up,
//   wait before the first store to a peer).
// - Then each block writes its slice of d from the rows it holds, with no
//   second read of the history; K7b writes s and y into the history where
//   the gate holds, exchanges its gᵀd partial the same way (the
//   reference's explicit gᵀd, dir_pallas.py:259-261), and applies the -g
//   fallback to its own slice. A block leaves once every byte addressed
//   to it has landed; no block reads another's shared memory.
//
// Where a slice's rows do not all fit in the block's 227 KB (n past
// ~30k at m = 6, ~26k at m = 7, with c = 8), the plan keeps the history
// rows first, then s, y and g, and the block streams its columns through
// registers, reading the rows that do not fit again from global memory
// (L2) in the write pass. At m <= 5 every row fits at every n <= 32k, and
// the history's rows fit at m <= 6; at m = 7 and n past ~32,500 one
// history row is read twice.
//
// Sums are reduced in a fixed order (per-thread partials over the
// thread's columns, the fixed reduce-scatter, the warps in order, the
// blocks in rank order), with no atomics: a repeated launch on the same
// inputs gives bit-identical outputs. The sums run in another order than
// the first port's, so a direction differs from it by rounding.

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr size_t kSmemLimit = 232448;
// Columns a thread loads together where its slice streams through
// registers (their loads in flight at once): 4 up to m = 5, 2 above,
// within the registers the sums leave.
template <int M>
constexpr int kChunk = M <= 5 ? 4 : 2;

// Gram entries of the history with g, by raw slot: s_i·y_j (all m²
// pairs), y_i·y_j (i <= j), s_i·g and y_i·g (GramView reads them).
template <int M>
struct Gram {
    static constexpr int kSY = M * M;
    static constexpr int kYY = M * (M + 1) / 2;
    static constexpr int kN = kSY + kYY + 2 * M;
    __host__ __device__ static constexpr int yy(int i, int j) {
        // i <= j, row-major upper triangle
        return kSY + i * M - i * (i - 1) / 2 + (j - i);
    }
    static constexpr int kSg = kSY + kYY;
    static constexpr int kYg = kSg + M;
};

// The sums a block accumulates in its read pass: the Gram, then, for K7b
// (kStep), the new pair (s, y) against every slot and g, and the gate's
// sums; max|g| is reduced apart. kPad rounds the count up to the warp's
// 32 lanes for the reduce-scatter. The slice's rows, in the order the
// plan keeps them on chip: the 2M history rows, then s, y, g (K7a: g).
template <int M, bool kStep>
struct Sums {
    using Gm = Gram<M>;
    static constexpr int kNsY = Gm::kN;        // s·y_j, every slot j
    static constexpr int kSiN = kNsY + M;      // s_i·y
    static constexpr int kNyY = kSiN + M;      // y·y_j
    static constexpr int kNsg = kNyY + M;      // s·g
    static constexpr int kNyg = kNsg + 1;      // y·g
    static constexpr int kGate = kNyg + 1;     // sᵀy sᵀs yᵀy Σ|g| Σg²
    static constexpr int kSums = kStep ? kGate + 5 : Gm::kN;
    static constexpr int kPad = (kSums + 31) / 32 * 32;
    static constexpr int kPer = kPad / 32;     // sums a lane ends with
    static constexpr int kTot = kSums + (kStep ? 1 : 0);   // and max|g|
    static constexpr int kRows = 2 * M + (kStep ? 3 : 1);
    static constexpr int kRowS = 2 * M, kRowY = 2 * M + 1;
    static constexpr int kRowG = kRows - 1;
};

// The chronological (m, m) system of _dir_math, in shared memory: R =
// triu(SᵀY) with a unit diagonal for invalid slots, D = diag(SᵀY), YᵀY, a
// = Sᵀg and b = Yᵀg, the invalid slots' rows and columns zero. The block
// fills it in parallel (prepare_system), one entry a thread.
template <int M>
struct System {
    float R[M][M], YY[M][M], dg[M], a[M], b[M];
};

// A block's shared memory: this fixed area, then the rows of its slice
// (dir_smem_bytes). The blocks of a cluster store their totals into each
// other's inbox (and K7b its gᵀd partial into gd_in), each store counted
// on the receiver's mbarrier.
template <int M, bool kStep>
struct DirSmem {
    using S = Sums<M, kStep>;
    unsigned long long bar[2];      // mbarriers: the totals', gᵀd's
    float red[kWarps * S::kPad + kWarps];     // the warps' partials
    float inbox[kMaxCluster][S::kTot];        // every block's totals
    float tot[S::kTot];             // the cluster's totals
    System<M> sys;                  // the (m, m) system after the gate
    float coef[2 * M + 1];          // contraction weights per raw row, γ
    float gd_in[kMaxCluster];       // the blocks' gᵀd partials (K7b)
    int state[4];                   // good, head, hlen after the gate
};

template <int M, bool kStep>
__host__ __device__ constexpr size_t fixed_bytes() {
    return (sizeof(DirSmem<M, kStep>) + 15) / 16 * 16;
}

template <int M, bool kStep>
size_t dir_smem_bytes(int W, int R) {
    return fixed_bytes<M, kStep>() + (size_t)R * W * sizeof(float);
}

__device__ __forceinline__ float nanmax(float a, float b) {
    return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ bool is_finite(float x) {
    return fabsf(x) <= FLT_MAX;
}

// The split cluster barrier: every block arrives once its mbarriers are
// set up, and waits before its first store into another block.
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" : : : "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" : : : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// An mbarrier that completes once `bytes` have been stored into this
// block by st.async (one arrival, this call's, with the bytes expected).
__device__ __forceinline__ void expect_bytes(unsigned long long* bar,
                                             unsigned bytes) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 : : "r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" : : : "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 : : "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for the mbarrier's first phase: every expected byte has landed.
__device__ __forceinline__ void wait_bytes(unsigned long long* bar) {
    asm volatile(
        "{\n\t.reg .pred P1;\n\tLAB_WAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n\t"
        "@P1 bra DONE;\n\tbra LAB_WAIT;\n\tDONE:\n\t}"
        : : "r"(smem_addr(bar)) : "memory");
}

// v into block `rank`'s copy of this block's shared float *dst, counted on
// that block's copy of *bar (distributed shared memory, st.async).
__device__ __forceinline__ void store_to(float* dst, unsigned long long* bar,
                                         unsigned rank, float v) {
    unsigned rdst, rbar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(rdst) : "r"(smem_addr(dst)), "r"(rank));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(rbar) : "r"(smem_addr(bar)), "r"(rank));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], "
        "%1, [%2];"
        : : "r"(rdst), "r"(__float_as_uint(v)), "r"(rbar) : "memory");
}

// One float from global into shared memory by cp.async, in the
// background; copy_wait_all waits for the thread's copies.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 : : "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
                 : "memory");
}
__device__ __forceinline__ void copy_wait_all() {
    asm volatile("cp.async.wait_all;" : : : "memory");
}

// One step of the warp's reduce-scatter over v[0, L): lanes with bit O
// keep the upper half, the others the lower, each adding its partner's
// copy of the half it keeps. After the five steps (O = 16 .. 1) lane l
// holds the warp's sums of entries [l·N/32, (l+1)·N/32) in v[0, N/32).
template <int L, int O, int N>
__device__ __forceinline__ void scatter_step(float (&v)[N], unsigned lane) {
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < L / 2; ++i) {
        const float keep = up ? v[L / 2 + i] : v[i];
        const float send = up ? v[i] : v[L / 2 + i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    if constexpr (O > 1) scatter_step<L / 2, O / 2, N>(v, lane);
}

// Slot (head - M + j) mod M holds the j-th oldest pair, valid from
// M - hlen on.
__device__ __forceinline__ int slot_of(int j, int head, int M) {
    return ((head - M + j) % M + M) % M;
}

// The (m, m) solve on one thread: from the prepared system to the
// contraction weights coef[r] (raw row r of the history) and coef[2M] =
// γ. Every loop is unrolled, so the small matrices live in registers and
// their loads from shared memory do not wait on each other.
template <int M>
__device__ __forceinline__ void small_solve(const System<M>& Q, int head,
                                            int hlen, float* coef) {
    float R[M][M], YY[M][M], dg[M], a[M], b[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
        for (int j = 0; j < M; ++j) {
            R[i][j] = Q.R[i][j];
            YY[i][j] = Q.YY[i][j];
        }
        dg[i] = Q.dg[i];
        a[i] = Q.a[i];
        b[i] = Q.b[i];
    }
    const float gamma = hlen > 0
        ? dg[M - 1] / fmaxf(YY[M - 1][M - 1], 1e-30f) : 1.f;
    // the diagonal's reciprocals first, independent of each other, so that
    // the triangular solves chain multiplications, not divisions
    float inv[M];
#pragma unroll
    for (int i = 0; i < M; ++i) inv[i] = 1.f / R[i][i];
    float u[M], w[M], v[M];
#pragma unroll
    for (int i = M - 1; i >= 0; --i) {          // R u = a
        float t = a[i];
#pragma unroll
        for (int j = i + 1; j < M; ++j) t -= R[i][j] * u[j];
        u[i] = t * inv[i];
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {                // (D + γ YᵀY) u - γ b
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < M; ++j) t += YY[i][j] * u[j];
        v[i] = dg[i] * u[i] + gamma * t - gamma * b[i];
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {                // Rᵀ w = v
        float t = v[i];
#pragma unroll
        for (int j = 0; j < i; ++j) t -= R[j][i] * w[j];
        w[i] = t * inv[i];
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {                // back to raw slots
        const int o = slot_of(j, head, M);
        const bool valid = j >= M - hlen;
        coef[o] = valid ? w[j] : 0.f;
        coef[M + o] = valid ? -gamma * u[j] : 0.f;
    }
    coef[2 * M] = gamma;
}

// One member, as a cluster block sees it. H (2M, n) is written by K7b
// (s and y at head); xo, xn, go (K7b) make s = xn - xo and y = g - go.
struct Member {
    float* H;
    const float* g;        // the gradient the direction is taken at
    const float* xo;
    const float* xn;
    const float* go;
    float* d;
    int n, head, hlen;
    bool ls_ok;            // K7b: the line search took a step
};

// The slice of one block: columns [k0, k0 + w) of the member, its rows
// kept on chip at rows + r·W for r < R.
struct Slice {
    float* rows;
    int k0, w, W, R;
};

// Row r of the slice at local column kk (global column k): from shared
// memory where the plan keeps it, else from global memory.
template <int M, bool kStep>
__device__ __forceinline__ float row_at(const Member& a, const Slice& s,
                                        int r, int kk, int k) {
    using S = Sums<M, kStep>;
    if (r < s.R) return s.rows[(size_t)r * s.W + kk];
    if (r < 2 * M) return a.H[(size_t)r * a.n + k];
    if constexpr (kStep) {
        if (r == S::kRowS) return a.xn[k] - a.xo[k];
        if (r == S::kRowY) return a.g[k] - a.go[k];
    }
    return a.g[k];
}

// The read pass's loads of global column k: the history rows, then s, y,
// g (K7a: g).
template <int M, bool kStep>
__device__ __forceinline__ void load_column(const Member& a, int k,
                                            float (&v)[Sums<M, kStep>::kRows]) {
    using S = Sums<M, kStep>;
#pragma unroll
    for (int r = 0; r < 2 * M; ++r) v[r] = a.H[(size_t)r * a.n + k];
    v[S::kRowG] = a.g[k];
    if constexpr (kStep) {
        v[S::kRowS] = a.xn[k] - a.xo[k];
        v[S::kRowY] = v[S::kRowG] - a.go[k];
    }
}

template <int M, bool kStep>
__device__ __forceinline__ void accumulate(
        float (&acc)[Sums<M, kStep>::kPad], float& mx,
        const float (&v)[Sums<M, kStep>::kRows]) {
    using S = Sums<M, kStep>;
    using Gm = Gram<M>;
    const float g = v[S::kRowG];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
        for (int j = 0; j < M; ++j) acc[i * M + j] += v[i] * v[M + j];
#pragma unroll
        for (int j = i; j < M; ++j) acc[Gm::yy(i, j)] += v[M + i] * v[M + j];
        acc[Gm::kSg + i] += v[i] * g;
        acc[Gm::kYg + i] += v[M + i] * g;
    }
    if constexpr (kStep) {
        const float s = v[S::kRowS], y = v[S::kRowY];
#pragma unroll
        for (int j = 0; j < M; ++j) {
            acc[S::kNsY + j] += s * v[M + j];
            acc[S::kSiN + j] += v[j] * y;
            acc[S::kNyY + j] += y * v[M + j];
        }
        acc[S::kNsg] += s * g;
        acc[S::kNyg] += y * g;
        acc[S::kGate] += s * y;
        acc[S::kGate + 1] += s * s;
        acc[S::kGate + 2] += y * y;
        acc[S::kGate + 3] += fabsf(g);
        acc[S::kGate + 4] += g * g;
        mx = nanmax(mx, fabsf(g));
    }
}

// The Gram of the history after the gate, by raw slot, read from the
// cluster's totals T: where the pair is taken (good), slot h holds (s, y),
// whose entries the read pass summed apart; no copy is made.
template <int M, bool kStep>
struct GramView {
    using S = Sums<M, kStep>;
    using Gm = Gram<M>;
    const float* T;
    int h;
    bool good;
    __device__ __forceinline__ float sy(int i, int j) const {   // s_i·y_j
        if (kStep && good && i == h)
            return T[j == h ? S::kGate : S::kNsY + j];
        if (kStep && good && j == h) return T[S::kSiN + i];
        return T[i * M + j];
    }
    __device__ __forceinline__ float yy(int i, int j) const {   // y_i·y_j
        if (kStep && good && (i == h || j == h))
            return T[i == j ? S::kGate + 2 : S::kNyY + (i == h ? j : i)];
        return T[i <= j ? Gm::yy(i, j) : Gm::yy(j, i)];
    }
    __device__ __forceinline__ float sg(int i) const {
        return T[kStep && good && i == h ? S::kNsg : Gm::kSg + i];
    }
    __device__ __forceinline__ float yg(int i) const {
        return T[kStep && good && i == h ? S::kNyg : Gm::kYg + i];
    }
};

// One entry a thread (the block's threads together): the chronological
// system of the history (head, hlen) from the Gram view G.
template <int M, bool kStep>
__device__ __forceinline__ void prepare_system(const GramView<M, kStep>& G,
                                               int head, int hlen,
                                               System<M>& Q) {
    for (int t = threadIdx.x; t < M * M + M; t += kThreads) {
        if (t < M * M) {
            const int i = t / M, j = t % M;
            const bool v = j >= M - hlen && i >= M - hlen;
            const int oi = slot_of(i, head, M), oj = slot_of(j, head, M);
            const float sy = v ? G.sy(oi, oj) : 0.f;
            Q.R[i][j] = j > i ? sy : (j == i ? (v ? sy : 1.f) : 0.f);
            if (i == j) Q.dg[i] = sy;
            Q.YY[i][j] = v ? G.yy(oi, oj) : 0.f;
        } else {
            const int i = t - M * M;
            const bool v = i >= M - hlen;
            const int oi = slot_of(i, head, M);
            Q.a[i] = v ? G.sg(oi) : 0.f;
            Q.b[i] = v ? G.yg(oi) : 0.f;
        }
    }
}

// Where every row of the slice is kept on chip: the thread's columns of
// each source row copied in by cp.async, all in flight together (K7b:
// x_new into s's row and g_old into y's, which compact_direction turns
// into s and y). The kernels call it first, so that the copies fly while
// they read their flags.
template <int M, bool kStep>
__device__ __forceinline__ void stage_slice(const Member a, const Slice s) {
    using S = Sums<M, kStep>;
    if (s.R != S::kRows) return;
    for (int kk = threadIdx.x; kk < s.w; kk += kThreads) {
        const int k = s.k0 + kk;
#pragma unroll
        for (int r = 0; r < 2 * M; ++r)
            copy_async(&s.rows[(size_t)r * s.W + kk],
                       a.H + (size_t)r * a.n + k);
        copy_async(&s.rows[(size_t)S::kRowG * s.W + kk], a.g + k);
        if constexpr (kStep) {
            copy_async(&s.rows[(size_t)S::kRowS * s.W + kk], a.xn + k);
            copy_async(&s.rows[(size_t)S::kRowY * s.W + kk], a.go + k);
        }
    }
}

// compact_direction: d = -Hinv g for one member, its cluster's blocks
// calling it together after stage_slice; K7b (kStep) first gates the pair
// (s, y) into the history. Leaves every block's sm.state = [good, head,
// hlen] after the gate and sm.tot the cluster's totals; returns K7b's gᵀd
// over the whole member (before any fallback) to every thread, K7a 0.
template <int M, bool kStep>
__device__ __forceinline__ float compact_direction(const Member a,
                                                   const Slice s,
                                                   DirSmem<M, kStep>& sm) {
    using S = Sums<M, kStep>;
    const cg::cluster_group cl = cg::this_cluster();
    const int c = cl.num_blocks();
    const unsigned tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned me = cl.block_rank();
    if (tid == 0) {
        expect_bytes(&sm.bar[0], c * S::kTot * sizeof(float));
        if constexpr (kStep) expect_bytes(&sm.bar[1], c * sizeof(float));
    }
    cluster_arrive();       // waited for before the first store to a peer

    // the read pass: every sum in registers, the rows into shared memory
    float acc[S::kPad];
#pragma unroll
    for (int p = 0; p < S::kPad; ++p) acc[p] = 0.f;
    float mx = 0.f;
    if (s.R == S::kRows) {
        // every row on chip, copied in by stage_slice (x_old, which has no
        // row of its own, through registers, a chunk of columns ahead):
        // the sums from shared memory, s and y formed in place
        constexpr int kC = 4;
        float xo[kC], xo_next[kC];
        if constexpr (kStep) {
#pragma unroll
            for (int u = 0; u < kC; ++u) {
                const int kk = tid + u * kThreads;
                xo[u] = kk < s.w ? a.xo[s.k0 + kk] : 0.f;
            }
        }
        copy_wait_all();
        for (int kk0 = tid; kk0 < s.w; kk0 += kC * kThreads) {
            if constexpr (kStep) {
#pragma unroll
                for (int u = 0; u < kC; ++u) {
                    const int kk = kk0 + (kC + u) * kThreads;
                    xo_next[u] = kk < s.w ? a.xo[s.k0 + kk] : 0.f;
                }
            }
#pragma unroll
            for (int u = 0; u < kC; ++u) {
                const int kk = kk0 + u * kThreads;
                if (kk < s.w) {
                    float v[S::kRows];
#pragma unroll
                    for (int r = 0; r < S::kRows; ++r)
                        v[r] = s.rows[(size_t)r * s.W + kk];
                    if constexpr (kStep) {
                        v[S::kRowS] -= xo[u];                 // x_new - x_old
                        v[S::kRowY] = v[S::kRowG] - v[S::kRowY];  // g - g_old
                        s.rows[(size_t)S::kRowS * s.W + kk] = v[S::kRowS];
                        s.rows[(size_t)S::kRowY * s.W + kk] = v[S::kRowY];
                    }
                    accumulate<M, kStep>(acc, mx, v);
                }
            }
            if constexpr (kStep) {
#pragma unroll
                for (int u = 0; u < kC; ++u) xo[u] = xo_next[u];
            }
        }
    }
    // otherwise the rows stream through registers, those that fit kept
    for (int kk0 = tid; s.R < S::kRows && kk0 < s.w;
         kk0 += kChunk<M> * kThreads) {
        float v[kChunk<M>][S::kRows];
#pragma unroll
        for (int u = 0; u < kChunk<M>; ++u) {
            const int kk = kk0 + u * kThreads;
            if (kk < s.w) load_column<M, kStep>(a, s.k0 + kk, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kChunk<M>; ++u) {
            const int kk = kk0 + u * kThreads;
            if (kk < s.w) {
                accumulate<M, kStep>(acc, mx, v[u]);
#pragma unroll
                for (int r = 0; r < S::kRows; ++r)
                    if (r < s.R) s.rows[(size_t)r * s.W + kk] = v[u][r];
            }
        }
    }

    // the block's totals: the warps' reduce-scatter, the warps in order
    scatter_step<S::kPad, 16, S::kPad>(acc, lane);
#pragma unroll
    for (int i = 0; i < S::kPer; ++i)          // entry lane·kPer + i
        sm.red[warp * S::kPad + i * 32 + lane] = acc[i];
    if constexpr (kStep) {
        for (int o = 16; o > 0; o >>= 1)
            mx = nanmax(mx, __shfl_down_sync(0xffffffffu, mx, o));
        if (lane == 0) sm.red[kWarps * S::kPad + warp] = mx;
    }
    __syncthreads();
    cluster_wait();         // every block's mbarriers are set up
    for (int t = tid; t < S::kTot; t += kThreads) {
        float x;
        if (t < S::kSums) {
            const int at = (t % S::kPer) * 32 + t / S::kPer;
            x = sm.red[at];
            for (int w = 1; w < kWarps; ++w) x += sm.red[w * S::kPad + at];
        } else {
            x = sm.red[kWarps * S::kPad];
            for (int w = 1; w < kWarps; ++w)
                x = nanmax(x, sm.red[kWarps * S::kPad + w]);
        }
        for (int r = 0; r < c; ++r)     // into every block's inbox
            store_to(&sm.inbox[me][t], &sm.bar[0], r, x);
    }
    wait_bytes(&sm.bar[0]);   // every block's totals are in

    // the cluster's totals, the blocks in rank order: the same bits in
    // every block
    for (int t = tid; t < S::kTot; t += kThreads) {
        float x = sm.inbox[0][t];
        for (int r = 1; r < c; ++r)
            x = t < S::kSums ? x + sm.inbox[r][t] : nanmax(x, sm.inbox[r][t]);
        sm.tot[t] = x;
    }
    __syncthreads();

    // the gate, on every thread from the same totals; the system in
    // parallel; the (m, m) solve on thread 0
    const float* T = sm.tot;
    bool good = false;
    int h = a.head, l = a.hlen;
    if constexpr (kStep) {
        const float sy = T[S::kGate], s2 = T[S::kGate + 1];
        const float y2 = T[S::kGate + 2];
        good = a.ls_ok && (sy > 1e-10f * sqrtf(s2 * y2)) && (sy > 0.f);
    }
    const GramView<M, kStep> G{T, h, good};
    if (good) {
        h = (h + 1) % M;
        l = min(l + 1, M);
    }
    prepare_system<M, kStep>(G, h, l, sm.sys);
    __syncthreads();
    if (tid == 0) {
        small_solve<M>(sm.sys, h, l, sm.coef);
        sm.state[0] = good;
        sm.state[1] = h;
        sm.state[2] = l;
    }
    __syncthreads();

    // the write pass: d from the rows the block holds
    float coef[2 * M];
    int src[2 * M];        // where raw row r's values are now
#pragma unroll
    for (int r = 0; r < 2 * M; ++r) {
        coef[r] = sm.coef[r];
        src[r] = (good && r == a.head) ? S::kRowS
                 : (good && r == M + a.head) ? S::kRowY : r;
    }
    const float gamma = sm.coef[2 * M];
    float gd = 0.f;
    if (s.R == S::kRows) {          // every row on chip: offsets, no branch
        const float* rows = s.rows;
        int off[2 * M];
#pragma unroll
        for (int r = 0; r < 2 * M; ++r) off[r] = src[r] * s.W;
        for (int kk = tid; kk < s.w; kk += kThreads) {
            const int k = s.k0 + kk;
            float t = 0.f;
#pragma unroll
            for (int r = 0; r < 2 * M; ++r) t += coef[r] * rows[off[r] + kk];
            const float gk = rows[S::kRowG * s.W + kk];
            const float dk = -(gamma * gk + t);
            a.d[k] = dk;
            if constexpr (kStep) {
                if (good) {
                    a.H[(size_t)a.head * a.n + k] = rows[S::kRowS * s.W + kk];
                    a.H[(size_t)(M + a.head) * a.n + k] =
                        rows[S::kRowY * s.W + kk];
                }
                gd += dk * gk;
            }
        }
    } else {                        // rows past R from global memory
        for (int kk = tid; kk < s.w; kk += kThreads) {
            const int k = s.k0 + kk;
            float t = 0.f;
#pragma unroll
            for (int r = 0; r < 2 * M; ++r)
                t += coef[r] * row_at<M, kStep>(a, s, src[r], kk, k);
            const float gk = row_at<M, kStep>(a, s, S::kRowG, kk, k);
            const float dk = -(gamma * gk + t);
            a.d[k] = dk;
            if constexpr (kStep) {
                if (good) {
                    a.H[(size_t)a.head * a.n + k] =
                        row_at<M, kStep>(a, s, S::kRowS, kk, k);
                    a.H[(size_t)(M + a.head) * a.n + k] =
                        row_at<M, kStep>(a, s, S::kRowY, kk, k);
                }
                gd += dk * gk;
            }
        }
    }
    if constexpr (!kStep) {
        return 0.f;
    } else {
        // gᵀd: the warps in order, each block's partial stored into every
        // block's gd_in, the blocks in rank order. The warps' partials
        // take the area of max|g|'s, free since the block's totals.
        float* part = sm.red + kWarps * S::kPad;
        for (int o = 16; o > 0; o >>= 1)
            gd += __shfl_down_sync(0xffffffffu, gd, o);
        if (lane == 0) part[warp] = gd;
        __syncthreads();
        if (tid < (unsigned)c) {
            float x = part[0];
            for (int w = 1; w < kWarps; ++w) x += part[w];
            store_to(&sm.gd_in[me], &sm.bar[1], tid, x);
        }
        wait_bytes(&sm.bar[1]);
        float desc = sm.gd_in[0];
        for (int r = 1; r < c; ++r) desc += sm.gd_in[r];
        return desc;
    }
}

// The slice of this block of a cluster of c over n columns.
__device__ __forceinline__ Slice slice_of(float* rows, int n, int W, int R) {
    const int k0 = (int)cg::this_cluster().block_rank() * W;
    return Slice{rows, k0, max(0, min(W, n - k0)), W, R};
}

template <int M, bool kStep>
__device__ __forceinline__ DirSmem<M, kStep>& smem_of(float*& rows) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    rows = reinterpret_cast<float*>(smem_raw + fixed_bytes<M, kStep>());
    return *reinterpret_cast<DirSmem<M, kStep>*>(smem_raw);
}

// K7a: d (B, n) for g (B, n), H (B, 2M, n), head/hlen (B,); a cluster of
// c blocks a member, W columns a block, R rows of a slice on chip.
template <int M>
__global__ void __launch_bounds__(kThreads, 1) dir_kernel(
        const float* __restrict__ G, const float* __restrict__ H,
        const int* __restrict__ head, const int* __restrict__ hlen, int n,
        int W, int R, float* __restrict__ D) {
    float* rows;
    DirSmem<M, false>& sm = smem_of<M, false>(rows);
    const size_t b = blockIdx.x / cg::this_cluster().num_blocks();
    const Member a{const_cast<float*>(H) + b * 2 * M * n, G + b * n,
                   nullptr, nullptr, nullptr, D + b * n, n, head[b],
                   hlen[b], false};
    const Slice s = slice_of(rows, n, W, R);
    stage_slice<M, false>(a, s);
    compact_direction<M, false>(a, s, sm);
}

// K7b: one post-line-search step per member. flags (B, 2) int32 =
// [ls_ok, run]; H, head and hlen updated in place; d (B, n) and sc (B, 7)
// = [good, max|g_new|, Σ|g_new|, head, hlen, sᵀy, g_newᵀd] written.
template <int M>
__global__ void __launch_bounds__(kThreads, 1) step_kernel(
        float* __restrict__ H, const float* __restrict__ XO,
        const float* __restrict__ XN, const float* __restrict__ GO,
        const float* __restrict__ GN, int* __restrict__ head,
        int* __restrict__ hlen, const int* __restrict__ flags, int n,
        int W, int R, float* __restrict__ D, float* __restrict__ sc) {
    using S = Sums<M, true>;
    float* rows;
    DirSmem<M, true>& sm = smem_of<M, true>(rows);
    const cg::cluster_group cl = cg::this_cluster();
    const size_t b = blockIdx.x / cl.num_blocks();
    const bool lead = cl.block_rank() == 0 && threadIdx.x == 0;
    const size_t off = b * n;
    float* out = sc + b * 7;
    const int h = head[b];
    const int l = hlen[b];
    const Slice s = slice_of(rows, n, W, R);
    const Member a{H + b * 2 * M * n, GN + off, XO + off, XN + off,
                   GO + off, D + off, n, h, l, flags[2 * b] != 0};
    stage_slice<M, true>(a, s);
    if (!flags[2 * b + 1]) {   // ended: touch nothing of its state; the
                               // whole cluster leaves here, no barrier
        copy_wait_all();
        for (int kk = threadIdx.x; kk < s.w; kk += kThreads)
            D[off + s.k0 + kk] = 0.f;
        if (lead) {
            out[0] = 0.f; out[1] = 0.f; out[2] = 0.f;
            out[3] = (float)h; out[4] = (float)l;
            out[5] = 0.f; out[6] = 0.f;
        }
        return;
    }
    const float desc = compact_direction<M, true>(a, s, sm);
    const bool bad = desc >= 0.f || !is_finite(desc);
    if (bad)        // each thread rewrites only the entries it wrote
        for (int kk = threadIdx.x; kk < s.w; kk += kThreads)
            a.d[s.k0 + kk] = -row_at<M, true>(a, s, S::kRowG, kk, s.k0 + kk);
    if (lead) {
        const float* T = sm.tot;
        head[b] = sm.state[1];
        hlen[b] = sm.state[2];
        out[0] = sm.state[0] ? 1.f : 0.f;
        out[1] = T[S::kSums];              // max|g_new|
        out[2] = T[S::kGate + 3];          // Σ|g_new|
        out[3] = (float)sm.state[1];
        out[4] = (float)sm.state[2];
        out[5] = T[S::kGate];              // sᵀy
        out[6] = bad ? -T[S::kGate + 4] : desc;
    }
}

template <template <int> class Launch, typename... Args>
int dispatch_m(int m, Args... args) {
    switch (m) {
        case 1: return Launch<1>::run(args...);
        case 2: return Launch<2>::run(args...);
        case 3: return Launch<3>::run(args...);
        case 4: return Launch<4>::run(args...);
        case 5: return Launch<5>::run(args...);
        case 6: return Launch<6>::run(args...);
        case 7: return Launch<7>::run(args...);
        default: return (int)cudaErrorInvalidValue;
    }
}

// A launch of B clusters of c blocks; a launch the card refuses returns
// its error, read back so that the next launch does not report it.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int B, int c, size_t smem,
                    void* stream, Args... args) {
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) {
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3((unsigned)B * c, 1, 1);
        cfg.blockDim = dim3(kThreads, 1, 1);
        cfg.dynamicSmemBytes = smem;
        cfg.stream = (cudaStream_t)stream;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = c;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        e = cudaLaunchKernelEx(&cfg, kernel, args...);
    }
    const cudaError_t last = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : last);
}

// The plan's arguments, as kernels/dir.py::cluster_plan makes them: c
// blocks of W columns cover n, R rows on chip, within the block's limit.
template <int M, bool kStep>
bool plan_ok(int n, int c, int W, int R) {
    return n >= 1 && c >= 1 && c <= kMaxCluster && W >= 1
           && (long long)W * c >= n && R >= 0
           && R <= Sums<M, kStep>::kRows
           && dir_smem_bytes<M, kStep>(W, R) <= kSmemLimit;
}

template <int M>
struct LaunchDir {
    static int run(const void* g, const void* H, const void* head,
                   const void* hlen, int B, int n, int c, int W, int R,
                   void* d, void* stream) {
        if (!plan_ok<M, false>(n, c, W, R)) return (int)cudaErrorInvalidValue;
        return launch_clusters(
            dir_kernel<M>, B, c, dir_smem_bytes<M, false>(W, R), stream,
            static_cast<const float*>(g), static_cast<const float*>(H),
            static_cast<const int*>(head), static_cast<const int*>(hlen), n,
            W, R, static_cast<float*>(d));
    }
};

template <int M>
struct LaunchStep {
    static int run(void* H, const void* xo, const void* xn, const void* go,
                   const void* gn, void* head, void* hlen, const void* flags,
                   int B, int n, int c, int W, int R, void* d, void* sc,
                   void* stream) {
        if (!plan_ok<M, true>(n, c, W, R)) return (int)cudaErrorInvalidValue;
        return launch_clusters(
            step_kernel<M>, B, c, dir_smem_bytes<M, true>(W, R), stream,
            static_cast<float*>(H), static_cast<const float*>(xo),
            static_cast<const float*>(xn), static_cast<const float*>(go),
            static_cast<const float*>(gn), static_cast<int*>(head),
            static_cast<int*>(hlen), static_cast<const int*>(flags), n, W, R,
            static_cast<float*>(d), static_cast<float*>(sc));
    }
};

template <int M>
struct SmemOf {
    static int run(int step, int W, int R, long long* out) {
        *out = (long long)(step ? dir_smem_bytes<M, true>(W, R)
                                : dir_smem_bytes<M, false>(W, R));
        return 0;
    }
};

template <int M>
struct AttrsOf {
    static int run(int step, int* out) {
        cudaFuncAttributes a;
        const cudaError_t e = cudaFuncGetAttributes(
            &a, step ? (const void*)step_kernel<M> : (const void*)dir_kernel<M>);
        if (e != cudaSuccess) return (int)e;
        out[0] = a.numRegs;
        out[1] = (int)a.localSizeBytes;
        out[2] = a.maxThreadsPerBlock;
        return 0;
    }
};

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess). Pointers
// are device pointers to row-major float32 / int32 arrays: g, d, x_old,
// x_new, g_old, g_new (B, n); H (B, 2m, n); head, hlen (B,); flags (B, 2)
// [ls_ok, run]; sc (B, 7). 1 <= m <= 7 (2m + 1 <= 16 rows, the wrapper's
// envelope). The cluster plan
// (kernels/dir.py::cluster_plan): c blocks a member (1..8), W columns a
// block, R rows of a slice in shared memory.
int va_compact_dir_f32(const void* g, const void* H, const void* head,
                       const void* hlen, int B, int m, int n, int c, int W,
                       int R, void* d, void* stream) {
    return dispatch_m<LaunchDir>(m, g, H, head, hlen, B, n, c, W, R, d,
                                 stream);
}

int va_fused_step_f32(void* H, const void* x_old, const void* x_new,
                      const void* g_old, const void* g_new, void* head,
                      void* hlen, const void* flags, int B, int m, int n,
                      int c, int W, int R, void* d, void* sc, void* stream) {
    return dispatch_m<LaunchStep>(m, H, x_old, x_new, g_old, g_new, head,
                                  hlen, flags, B, n, c, W, R, d, sc, stream);
}

// A block's dynamic shared memory in bytes for K7b (step = 1) or K7a at
// W columns a block and R rows on chip, as the launches compute it.
long long va_dir_smem(int m, int step, int W, int R) {
    long long out = -1;
    dispatch_m<SmemOf>(m, step, W, R, &out);
    return out;
}

// The built kernel's attributes, K7b (step = 1) or K7a, at m: out =
// [registers a thread, local memory a thread in bytes, the most threads a
// block can launch with].
int va_dir_attrs(int m, int step, int* out) {
    return dispatch_m<AttrsOf>(m, step, out);
}

const char* va_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
