// Banded one-piece gap-affine fill of a read batch against a POA graph, in
// tilted coordinates: one kernel template for the global span on shared
// windows (B1), drifting windows (B3), ends-free spans on shared windows
// (B5), and drifting windows under a bounded ends-free span (B6).
//
// Replaces, in poasta_tpu/ops/pallas_fill.py:
//   VARIANT_GLOBAL    _banded_kernel           (pallas_banded_scores)
//   VARIANT_DRIFT     _banded_kernel_drift     (pallas_banded_scores_drift)
//   VARIANT_EF        _banded_kernel_ef        (pallas_banded_scores_ef)
//   VARIANT_DRIFT_EF  _banded_kernel_drift_ef  (pallas_banded_scores_drift_ef)
// Same inputs, same output rows, bit for bit.
//
// Recurrence, per read and per topological rank r, over the rank's window
// of Wb lanes starting at the 128-aligned global offset w_r.  Rows store
// X'(j) = X(j) - e*j for the global offset j = w_r + lane:
//   min_pm, min_pd = min over predecessors of their stored M', D' rows,
//                    each read shifted by clip(w_r - w_p, -MARGIN, MARGIN)
//                    (lanes outside a stored window read INF)
//   D    = min(min_pm + o + e, min_pd + e)
//   diag = min_pm(lane - 1) + (match ? -e : x - e), INF at lane 0
//   A    = min(diag, D), and min(A, 0) at (rank 0, j = 0)
//   I    = min(prefix_min_cap(A)(lane - 1) + o, INF)
//   M    = min(A, I)
// At the end rank M = min_pm, the stored D is INF, and min_pm is written
// out as the read's end row; the caller un-tilts it.  M is not clamped, so
// INF erodes by at most e per rank: the caller's INF/2 threshold relies
// on that.
//
// Drift.  Read b's window at rank r is the shared frame start w_r (which
// may be negative) shifted right by sigma_b(r) = 128 * ((nbs_b * s_r) >> log2 S),
// so lane i holds the global offset j = w_r + i + sigma_b(r).  At a rank
// where sigma_b advances the TPU kernel rolls the read's query row and every
// ring row 128 lanes left, INF (0 for the query) entering on the right.
// Here a block owns one read, so the roll is one number: ring rows are
// circular over their 2*margin + Wb lanes, logical lane t lives at
// (t + rot) mod TOT, and a step sets the 128 lanes that wrap round to INF
// and adds 128 to rot.  Whatever a roll left in a row's margin stays
// readable exactly as on the TPU, so over-estimated scores agree too.  The
// query needs no copy: lane i reads q[w_r + MQ + i + rolled], 0 past the row.
//
// Ends-free, shared windows (ENDS == 1).  A free graph begin seeds j = 0 at
// every rank but the end rank.  A best row of Lq lanes, positional in the
// global offset and still tilted, takes min(best[w_r + i], M'[i]) at every
// rank whose graph-end bound passes (end_ok); the caller un-tilts it and
// takes the min over each read's [jlo, n].
//
// Ends-free, drifting windows (ENDS == 2).  Lanes have no fixed global
// offset across ranks, so the end window is applied here: at end_ok ranks
// best[i] = min(best[i], M'[i] + e*j) for jlo_b <= j <= n_b.  The caller
// reduces the (Wb,) tile.
//
// What bounds it on the H100: each rank depends on the previous ones, so a
// read's rank loop is sequential and the block synchronises 3 + log2(cap)
// times per rank.  The work per rank is only ~Wb lanes x (P ring reads +
// log2(cap) scan rounds), so the barriers and the shared-memory latency
// they expose bound it, not DRAM bandwidth or arithmetic.
//
// What the design does about it: one block per read, so the 1024 reads of
// a batch fill the card's 132 SMs in waves with no cross-block traffic; the
// rings and rows stay in shared memory where they fit (87 KB of rings at
// the bench's first tier), so a rank step touches DRAM only for its query
// window; the launcher moves the rings, then the rows, to a per-block
// global-memory slab when they do not fit (wide tiers, large W).  The best
// row of an ends-free fill lives with the scratch rows under the same rule.
// The template's flags are compile-time, so the global instantiation
// carries none of the others' rotation, seeding or best-row code.
#include "common.cuh"
#include "prefix_min.cuh"

enum {
    VARIANT_GLOBAL = 1,
    VARIANT_DRIFT = 3,
    VARIANT_EF = 5,
    VARIANT_DRIFT_EF = 6,
};

struct BandedShape {
    int Lq, mq, log2S, n_nodes, end_rank, W, P, Wb, margin, o, e, x, cap;
    int free_start;
    long long global_ints;
    int mode;
};

static inline int banded_best_lanes(int variant, int Wb, int Lq) {
    return variant == VARIANT_EF ? Lq : (variant == VARIANT_DRIFT_EF ? Wb : 0);
}

// Index of logical lane `lane + i` of the ring row that starts at `row`.
// Rows are circular over TOT lanes with drift (lane + i < 2*TOT); without,
// row + lane is one loop-invariant 64-bit base, as a plain array has.
template <bool DRIFT>
__device__ __forceinline__ long long ring_at(long long row, int lane, int i,
                                             int TOT) {
    if (!DRIFT) return (row + lane) + i;
    int t = lane + i;
    if (t >= TOT) t -= TOT;
    return row + t;
}

// The read-only pointers are kernel parameters of their own, const and
// __restrict__ (not members of the shape struct), so the compiler may keep
// a rank's table entries in registers across the stores of a lane loop.
template <bool DRIFT, int ENDS>
__global__ void banded_kernel(
    const int* __restrict__ symbols,       // (Np,)
    const int* __restrict__ pred_slots,    // (Np*P,) ring slot per predecessor
    const int* __restrict__ pred_valid,    // (Np*P,) 0/1
    const int* __restrict__ pred_wstarts,  // (Np*P,) predecessor window starts
    const int* __restrict__ wstarts,       // (Np,) frame starts (may be
                                           // negative with drift)
    const int* __restrict__ wslots,        // (Np,) ring slot each rank writes
    const int* __restrict__ s_ranks,       // (Np,) cumulative drift steps (drift)
    const int* __restrict__ s_prev,        // (Np,) the previous rank's (drift)
    const int* __restrict__ end_ok,        // (Np,) 0/1 (ends-free)
    const int* __restrict__ qrows,         // (B, Lq); MQ zero lanes on the left
                                           // with drift
    const int* __restrict__ nbs_b,         // (B,) drift units per read (drift)
    const int* __restrict__ jlo_b,         // (B,) lowest permitted end offset
                                           // (ENDS == 2)
    const int* __restrict__ len_b,         // (B,) read lengths (ENDS == 2)
    BandedShape a,
    int* __restrict__ out_rows,            // (B, Wb), or (B, Lq) for ENDS == 1
    int* gws) {
    extern __shared__ int smem[];
    const int Wb = a.Wb, W = a.W, P = a.P, margin = a.margin;
    const int o = a.o, e = a.e, x = a.x, cap = a.cap;
    const int n_nodes = a.n_nodes, end_rank = a.end_rank;
    const int TOT = Wb + 2 * margin;
    const int best_lanes = ENDS == 1 ? a.Lq : (ENDS == 2 ? Wb : 0);
    int* rows;
    int* mring;
    poasta_workspace(a.mode, smem, gws, a.global_ints,
                     (long long)POASTA_ROWS * Wb + best_lanes, &rows, &mring);
    const long long ring_ints = (long long)W * TOT;
    int* dring = mring + ring_ints;
    int* pm_row = rows;
    int* d_row = rows + Wb;
    int* a_row = rows + 2 * Wb;
    int* s0 = rows + 3 * Wb;
    int* s1 = rows + 4 * Wb;
    int* best = rows + 5 * Wb;
    const int b = blockIdx.x;
    const int* q = qrows + (long long)b * a.Lq;
    int* out = out_rows + (long long)b * (ENDS == 1 ? a.Lq : Wb);
    const int nbs = DRIFT ? nbs_b[b] : 0;
    const int jlo = ENDS == 2 ? jlo_b[b] : 0;
    const int len = ENDS == 2 ? len_b[b] : 0;
    int rot = 0;     // ring rotation in lanes, < TOT (drift)
    int rolled = 0;  // lanes the read's frame has rolled left so far (drift)

    for (long long i = threadIdx.x; i < 2 * ring_ints; i += blockDim.x)
        mring[i] = POASTA_INF;  // the D ring follows the M ring
    for (int i = threadIdx.x; i < best_lanes; i += blockDim.x)
        best[i] = POASTA_INF;
    __syncthreads();

    for (int r = 0; r < n_nodes; ++r) {
        const int sym = symbols[r];
        const int w_r = wstarts[r];
        const int* ps = pred_slots + (long long)r * P;
        const int* pv = pred_valid + (long long)r * P;
        const int* pw = pred_wstarts + (long long)r * P;
        int sig = 0;
        if (DRIFT) {
            const int s_r = s_ranks[r], s_p = s_prev[r];
            sig = ((nbs * s_r) >> a.log2S) * 128;
            if (s_r > s_p && sig > ((nbs * s_p) >> a.log2S) * 128) {
                // the read re-frames: the 128 lanes that wrap round are the
                // new right edge of every M and D row
                for (int i = threadIdx.x; i < 2 * W * 128; i += blockDim.x) {
                    int t = rot + (i & 127);
                    if (t >= TOT) t -= TOT;
                    mring[(long long)(i >> 7) * TOT + t] = POASTA_INF;
                }
                rot += 128;
                if (rot >= TOT) rot -= TOT;
                rolled += 128;
                __syncthreads();
            }
        }

        // gather: p = 0 is unconditional (rank 0 reads an all-INF row)
        const int lane0 = margin + (DRIFT ? rot : 0);
        const int d0 = min(max(w_r - pw[0], -margin), margin);
        const long long row0 = (long long)ps[0] * TOT;
        for (int i = threadIdx.x; i < Wb; i += blockDim.x) {
            const long long off0 = ring_at<DRIFT>(row0, lane0 + d0, i, TOT);
            int pm = mring[off0];
            int pd = dring[off0];
            for (int p = 1; p < P; ++p) {
                if (pv[p] == 1) {
                    const int dp = min(max(w_r - pw[p], -margin), margin);
                    const long long off = ring_at<DRIFT>(
                        (long long)ps[p] * TOT, lane0 + dp, i, TOT);
                    pm = min(pm, mring[off]);
                    pd = min(pd, dring[off]);
                }
            }
            pm_row[i] = pm;
            d_row[i] = min(pm + (o + e), pd + e);
        }
        __syncthreads();

        const bool is_end = r == end_rank;
        const bool seeds = r == 0 || (ENDS == 1 && a.free_start && !is_end);
        for (int i = threadIdx.x; i < Wb; i += blockDim.x) {
            const int src = i >= 1 ? pm_row[i - 1] : POASTA_INF;
            int qv;
            if (DRIFT) {
                const int qi = w_r + a.mq + i + rolled;
                qv = qi < a.Lq ? q[qi] : 0;
            } else {
                qv = q[w_r + i];
            }
            int av = min(src + (qv == sym ? -e : x - e), d_row[i]);
            if (seeds && w_r + i + sig == 0) av = min(av, 0);
            a_row[i] = av;
            s0[i] = av;
        }
        __syncthreads();
        const int* pref = block_prefix_min(s0, s1, Wb, cap);

        const bool permitted = ENDS != 0 && end_ok[r] == 1;
        const long long wrow = (long long)wslots[r] * TOT;
        for (int i = threadIdx.x; i < Wb; i += blockDim.x) {
            int m, d;
            if (is_end) {
                m = pm_row[i];
                d = POASTA_INF;
                if (ENDS == 0) out[i] = m;
            } else {
                const int pm1 = i >= 1 ? pref[i - 1] : POASTA_INF;
                m = min(a_row[i], min(pm1 + o, POASTA_INF));
                d = min(d_row[i], POASTA_INF);
            }
            const long long woff = ring_at<DRIFT>(wrow, lane0, i, TOT);
            mring[woff] = m;
            dring[woff] = d;
            if (permitted) {
                if (ENDS == 1) {
                    best[w_r + i] = min(best[w_r + i], m);
                } else {
                    const int j = w_r + i + sig;
                    if (j >= jlo && j <= len)
                        best[i] = min(best[i], m + e * j);
                }
            }
        }
        __syncthreads();
    }
    if (ENDS != 0)
        for (int i = threadIdx.x; i < best_lanes; i += blockDim.x)
            out[i] = best[i];
}

static cudaError_t banded_plan(int variant, int W, int Wb, int margin, int Lq,
                               PoastaPlan* plan) {
    if (variant != VARIANT_GLOBAL && variant != VARIANT_DRIFT
        && variant != VARIANT_EF && variant != VARIANT_DRIFT_EF)
        return cudaErrorInvalidValue;
    return poasta_plan(
        Wb, (long long)POASTA_ROWS * Wb + banded_best_lanes(variant, Wb, Lq),
        2LL * W * (Wb + 2 * margin), plan);
}

extern "C" int poasta_banded_plan(int variant, int W, int Wb, int margin,
                                  int Lq, int* threads, int* mode,
                                  int* smem_bytes, long long* global_ints) {
    PoastaPlan plan;
    cudaError_t err = banded_plan(variant, W, Wb, margin, Lq, &plan);
    if (err != cudaSuccess) return (int)err;
    *threads = plan.threads;
    *mode = plan.mode;
    *smem_bytes = plan.smem_bytes;
    *global_ints = plan.global_ints;
    return 0;
}

extern "C" int poasta_banded_fill(
    int variant, const int* symbols, const int* pred_slots,
    const int* pred_valid, const int* pred_wstarts, const int* wstarts,
    const int* wslots, const int* s_ranks, const int* s_prev,
    const int* end_ok, const int* q, const int* nbs, const int* jlo,
    const int* len, int B, int Lq, int mq, int log2S, int n_nodes,
    int end_rank, int W, int P, int Wb, int margin, int o, int e, int x,
    int cap, int free_start, int* out, int* gws, long long gws_ints,
    void* stream) {
    PoastaPlan plan;
    cudaError_t err = banded_plan(variant, W, Wb, margin, Lq, &plan);
    if (err != cudaSuccess) return (int)err;
    if (gws_ints < plan.global_ints * (long long)B)
        return (int)cudaErrorInvalidValue;
    BandedShape a = {Lq, mq, log2S, n_nodes, end_rank, W, P, Wb, margin, o, e,
                     x, cap, free_start, plan.global_ints, plan.mode};
    cudaStream_t st = (cudaStream_t)stream;
#define BANDED_LAUNCH(DRIFT, ENDS)                                            \
    (int)poasta_launch(banded_kernel<DRIFT, ENDS>, B, plan, st, symbols,      \
                       pred_slots, pred_valid, pred_wstarts, wstarts, wslots, \
                       s_ranks, s_prev, end_ok, q, nbs, jlo, len, a, out, gws)
    if (variant == VARIANT_GLOBAL) return BANDED_LAUNCH(false, 0);
    if (variant == VARIANT_DRIFT) return BANDED_LAUNCH(true, 0);
    if (variant == VARIANT_EF) return BANDED_LAUNCH(false, 1);
    return BANDED_LAUNCH(true, 2);
#undef BANDED_LAUNCH
}

extern "C" const char* poasta_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
