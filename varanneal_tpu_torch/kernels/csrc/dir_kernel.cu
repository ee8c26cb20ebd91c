// K7a and K7b on Hopper: the compact-form L-BFGS direction (K7a) and the
// fused post-line-search step (K7b), one thread block per ensemble
// member, float32.
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
// ls_ok & sᵀy > 1e-10·sqrt(sᵀs·yᵀy) & sᵀy > 0, the history write of s and
// y at head when the gate holds, and max|g_new|, Σ|g_new|; after it, the
// -g_new fallback on a non-descent direction and the next line search's
// g_newᵀd. A member whose loop has ended (run = 0) keeps its history,
// head and hlen bit for bit, the lockstep rule of opt/lbfgs.py.
//
// The port's layout: the history is the joint (B, 2m, n) tensor of
// opt/lbfgs.py (rows [0, m) the steps, [m, 2m) the gradient
// differences), g and the vectors are (B, n). The TPU kernel's (16,
// n_pad) augmented block, its one-hot selection matmuls (Mosaic could
// neither slice rows nor gather) and its 128-lane padding have no
// counterpart: each thread reads its own strided entries of every row,
// and the chronological reorder is index arithmetic.
//
// What bounds it on the card: per member it reads 2m + 1 rows of n
// values once for the Gram (and 4 vectors for K7b's gate), writes d once,
// and reads the 2m + 1 rows again for the closing contraction; at the
// main shape (n = 3,221, m = 5, B = 4) that is ~0.6 MB and ~0.6 MFLOP, a
// fraction of a microsecond at the card's rates. With B blocks on B of
// the 132 SMs and three dependent block-wide phases (Gram reduction, the
// (m, m) solves on one thread, the contraction), it is bound by launch
// latency and that serial depth, not by bytes or operations. The design
// keeps the depth at one read pass, one reduction, one small solve and
// one write pass: every thread accumulates all m² + m(m+1)/2 + 2m Gram
// entries it needs in registers (the count fixed at compile time by the
// template on m), so the rows are read once.
//
// Sums are reduced in a fixed order (per-thread strided partials, a warp
// shuffle tree, then the warps in order), with no atomics: a repeated
// launch on the same inputs gives bit-identical outputs.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 7;      // 2m + 1 <= 16 rows (the wrapper's envelope)

// Gram entries one member needs: s_i·y_j (all m² raw-slot pairs), y_i·y_j
// (i <= j), s_i·g and y_i·g.
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

constexpr int kMaxGram = Gram<kMaxM>::kN;

struct DirSmem {
    float red[kMaxGram * kWarps];   // per-warp partials
    float gram[kMaxGram];
    float coef[2 * kMaxM + 1];      // contraction weights per raw row, γ
    float out[8];                   // scalars broadcast to the block
};

__device__ __forceinline__ float nanmax(float a, float b) {
    return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ bool is_finite(float x) {
    return fabsf(x) <= FLT_MAX;
}

// Fixed-order block reduction of K values: entries [0, first_max) are
// sums, the rest NaN-propagating maxima. The totals land in out[0, K).
template <int K>
__device__ void block_reduce(float (&v)[K], int first_max, float* red,
                             float* out) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        for (int o = 16; o > 0; o >>= 1) {
            const float u = __shfl_down_sync(0xffffffffu, v[k], o);
            v[k] = k < first_max ? v[k] + u : nanmax(v[k], u);
        }
        if (lane == 0) red[k * kWarps + warp] = v[k];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += kThreads) {
        float t = red[k * kWarps];
        for (int w = 1; w < kWarps; ++w)
            t = k < first_max ? t + red[k * kWarps + w]
                              : nanmax(t, red[k * kWarps + w]);
        out[k] = t;
    }
    __syncthreads();
}

// The (m, m) part of _dir_math on one thread: from the raw-slot Gram
// entries to the contraction weights coef[r] (raw row r of the history)
// and coef[2M] = γ.
template <int M>
__device__ void small_solve(const float* gram, int head, int hlen,
                            float* coef) {
    using Gm = Gram<M>;
    int ord[M];
    bool valid[M];
    for (int j = 0; j < M; ++j) {
        ord[j] = ((head - M + j) % M + M) % M;
        valid[j] = j >= M - hlen;
    }
    float SY[M][M], YY[M][M], R[M][M], a[M], b[M];
    for (int i = 0; i < M; ++i) {
        for (int j = 0; j < M; ++j) {
            const bool v = valid[i] && valid[j];
            const int oi = ord[i], oj = ord[j];
            SY[i][j] = v ? gram[oi * M + oj] : 0.f;
            YY[i][j] = v ? gram[oi <= oj ? Gm::yy(oi, oj) : Gm::yy(oj, oi)]
                         : 0.f;
            R[i][j] = j >= i ? SY[i][j] : 0.f;
        }
        if (!valid[i]) R[i][i] += 1.f;
        a[i] = valid[i] ? gram[Gm::kSg + ord[i]] : 0.f;
        b[i] = valid[i] ? gram[Gm::kYg + ord[i]] : 0.f;
    }
    const float gamma = hlen > 0
        ? SY[M - 1][M - 1] / fmaxf(YY[M - 1][M - 1], 1e-30f) : 1.f;
    float u[M], w[M];
    for (int i = M - 1; i >= 0; --i) {          // R u = a
        float t = a[i];
        for (int j = i + 1; j < M; ++j) t -= R[i][j] * u[j];
        u[i] = t / R[i][i];
    }
    float v[M];
    for (int i = 0; i < M; ++i) {                // (D + γ YᵀY) u - γ b
        float t = 0.f;
        for (int j = 0; j < M; ++j) t += YY[i][j] * u[j];
        v[i] = SY[i][i] * u[i] + gamma * t - gamma * b[i];
    }
    for (int i = 0; i < M; ++i) {                // Rᵀ w = v
        float t = v[i];
        for (int j = 0; j < i; ++j) t -= R[j][i] * w[j];
        w[i] = t / R[i][i];
    }
    for (int j = 0; j < M; ++j) {                // back to raw slots
        coef[ord[j]] = valid[j] ? w[j] : 0.f;
        coef[M + ord[j]] = valid[j] ? -gamma * u[j] : 0.f;
    }
    coef[2 * M] = gamma;
}

// d = -Hinv g for one member (the whole block calls it): g, d (n,), H
// (2M, n). Returns g·d (before any fallback) to every thread.
template <int M>
__device__ float compact_direction(const float* g, const float* H, int n,
                                   int head, int hlen, float* d,
                                   DirSmem& sm) {
    using Gm = Gram<M>;
    float acc[Gm::kN];
#pragma unroll
    for (int p = 0; p < Gm::kN; ++p) acc[p] = 0.f;
    for (int k = threadIdx.x; k < n; k += kThreads) {
        float s[M], y[M];
#pragma unroll
        for (int i = 0; i < M; ++i) {
            s[i] = H[(size_t)i * n + k];
            y[i] = H[(size_t)(M + i) * n + k];
        }
        const float gk = g[k];
#pragma unroll
        for (int i = 0; i < M; ++i) {
#pragma unroll
            for (int j = 0; j < M; ++j) acc[i * M + j] += s[i] * y[j];
#pragma unroll
            for (int j = i; j < M; ++j) acc[Gm::yy(i, j)] += y[i] * y[j];
            acc[Gm::kSg + i] += s[i] * gk;
            acc[Gm::kYg + i] += y[i] * gk;
        }
    }
    block_reduce(acc, Gm::kN, sm.red, sm.gram);
    if (threadIdx.x == 0) small_solve<M>(sm.gram, head, hlen, sm.coef);
    __syncthreads();
    float coef[2 * M];
#pragma unroll
    for (int r = 0; r < 2 * M; ++r) coef[r] = sm.coef[r];
    const float gamma = sm.coef[2 * M];
    float v[1] = {0.f};
    for (int k = threadIdx.x; k < n; k += kThreads) {
        float t = 0.f;
#pragma unroll
        for (int r = 0; r < 2 * M; ++r) t += coef[r] * H[(size_t)r * n + k];
        const float dk = -(gamma * g[k] + t);
        d[k] = dk;
        v[0] += dk * g[k];
    }
    block_reduce(v, 1, sm.red, sm.out);
    return sm.out[0];
}

// K7a: d (B, n) for g (B, n), H (B, 2M, n), head/hlen (B,).
template <int M>
__global__ void __launch_bounds__(kThreads) dir_kernel(
        const float* __restrict__ G, const float* __restrict__ H,
        const int* __restrict__ head, const int* __restrict__ hlen, int n,
        float* __restrict__ D) {
    __shared__ DirSmem sm;
    const size_t b = blockIdx.x;
    compact_direction<M>(G + b * n, H + b * 2 * M * n, n, head[b], hlen[b],
                         D + b * n, sm);
}

// K7b: one post-line-search step per member. flags (B, 2) int32 =
// [ls_ok, run]; H, head and hlen updated in place; d (B, n) and sc (B, 7)
// = [good, max|g_new|, Σ|g_new|, head, hlen, sᵀy, g_newᵀd] written.
template <int M>
__global__ void __launch_bounds__(kThreads) step_kernel(
        float* __restrict__ H, const float* __restrict__ XO,
        const float* __restrict__ XN, const float* __restrict__ GO,
        const float* __restrict__ GN, int* __restrict__ head,
        int* __restrict__ hlen, const int* __restrict__ flags, int n,
        float* __restrict__ D, float* __restrict__ sc) {
    __shared__ DirSmem sm;
    const size_t b = blockIdx.x;
    const size_t off = b * n;
    float* Hb = H + b * 2 * M * n;
    float* d = D + off;
    float* out = sc + b * 7;
    const int h = head[b];
    const int l = hlen[b];
    if (!flags[2 * b + 1]) {           // ended: touch nothing of its state
        for (int k = threadIdx.x; k < n; k += kThreads) d[k] = 0.f;
        if (threadIdx.x == 0) {
            out[0] = 0.f; out[1] = 0.f; out[2] = 0.f;
            out[3] = (float)h; out[4] = (float)l;
            out[5] = 0.f; out[6] = 0.f;
        }
        return;
    }
    const float* xo = XO + off;
    const float* xn = XN + off;
    const float* go = GO + off;
    const float* gn = GN + off;
    // sy s2 y2 Σ|gn| Σgn² | max|gn|
    float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = threadIdx.x; k < n; k += kThreads) {
        const float s = xn[k] - xo[k];
        const float y = gn[k] - go[k];
        const float g = gn[k];
        v[0] += s * y;
        v[1] += s * s;
        v[2] += y * y;
        v[3] += fabsf(g);
        v[4] += g * g;
        v[5] = nanmax(v[5], fabsf(g));
    }
    block_reduce(v, 5, sm.red, sm.out);
    const float sy = sm.out[0], s2 = sm.out[1], y2 = sm.out[2];
    const float gnorm1 = sm.out[3], gg = sm.out[4], pgn = sm.out[5];
    const bool good = flags[2 * b] && (sy > 1e-10f * sqrtf(s2 * y2))
                      && (sy > 0.f);
    int h_n = h, l_n = l;
    if (good) {
        for (int k = threadIdx.x; k < n; k += kThreads) {
            Hb[(size_t)h * n + k] = xn[k] - xo[k];
            Hb[(size_t)(M + h) * n + k] = gn[k] - go[k];
        }
        __syncthreads();               // the new rows, before they are read
        h_n = (h + 1) % M;
        l_n = min(l + 1, M);
    }
    const float desc = compact_direction<M>(gn, Hb, n, h_n, l_n, d, sm);
    const bool bad = desc >= 0.f || !is_finite(desc);
    if (bad)        // each thread rewrites only the entries it wrote
        for (int k = threadIdx.x; k < n; k += kThreads) d[k] = -gn[k];
    if (threadIdx.x == 0) {
        head[b] = h_n;
        hlen[b] = l_n;
        out[0] = good ? 1.f : 0.f;
        out[1] = pgn;
        out[2] = gnorm1;
        out[3] = (float)h_n;
        out[4] = (float)l_n;
        out[5] = sy;
        out[6] = bad ? -gg : desc;
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

template <int M>
struct LaunchDir {
    static int run(const void* g, const void* H, const void* head,
                   const void* hlen, int B, int n, void* d, void* stream) {
        dir_kernel<M><<<B, kThreads, 0, (cudaStream_t)stream>>>(
            static_cast<const float*>(g), static_cast<const float*>(H),
            static_cast<const int*>(head), static_cast<const int*>(hlen), n,
            static_cast<float*>(d));
        return (int)cudaGetLastError();
    }
};

template <int M>
struct LaunchStep {
    static int run(void* H, const void* xo, const void* xn, const void* go,
                   const void* gn, void* head, void* hlen, const void* flags,
                   int B, int n, void* d, void* sc, void* stream) {
        step_kernel<M><<<B, kThreads, 0, (cudaStream_t)stream>>>(
            static_cast<float*>(H), static_cast<const float*>(xo),
            static_cast<const float*>(xn), static_cast<const float*>(go),
            static_cast<const float*>(gn), static_cast<int*>(head),
            static_cast<int*>(hlen), static_cast<const int*>(flags), n,
            static_cast<float*>(d), static_cast<float*>(sc));
        return (int)cudaGetLastError();
    }
};

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess). Pointers
// are device pointers to row-major float32 / int32 arrays: g, d, x_old,
// x_new, g_old, g_new (B, n); H (B, 2m, n); head, hlen (B,); flags (B, 2)
// [ls_ok, run]; sc (B, 7). 1 <= m <= 7.
int va_compact_dir_f32(const void* g, const void* H, const void* head,
                       const void* hlen, int B, int m, int n, void* d,
                       void* stream) {
    return dispatch_m<LaunchDir>(m, g, H, head, hlen, B, n, d, stream);
}

int va_fused_step_f32(void* H, const void* x_old, const void* x_new,
                      const void* g_old, const void* g_new, void* head,
                      void* hlen, const void* flags, int B, int m, int n,
                      void* d, void* sc, void* stream) {
    return dispatch_m<LaunchStep>(m, H, x_old, x_new, g_old, g_new, head,
                                  hlen, flags, B, n, d, sc, stream);
}

const char* va_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
