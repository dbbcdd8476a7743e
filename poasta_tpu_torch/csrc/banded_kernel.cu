// Banded gap-affine fill of a read batch against a POA graph: one kernel
// template for the global span on shared windows (B1), drifting windows
// (B3), ends-free spans on shared windows (B5), drifting windows under a
// bounded ends-free span (B6), and two-piece costs under the global span on
// shared (B16) and drifting (B17) windows.
//
// Replaces, in poasta_tpu/ops/pallas_fill.py:
//   VARIANT_GLOBAL     _banded_kernel           (pallas_banded_scores)
//   VARIANT_DRIFT      _banded_kernel_drift     (pallas_banded_scores_drift)
//   VARIANT_EF         _banded_kernel_ef        (pallas_banded_scores_ef)
//   VARIANT_DRIFT_EF   _banded_kernel_drift_ef  (pallas_banded_scores_drift_ef)
//   VARIANT_GLOBAL_2P  _banded_kernel_2p        (pallas_banded_scores_2p)
//   VARIANT_DRIFT_2P   _banded_kernel_drift_2p  (pallas_banded_scores_drift_2p)
// Same inputs, same output rows, bit for bit.
//
// Recurrence, per read and per topological rank r, over the rank's window
// of Wb lanes starting at the 128-aligned global offset w_r.  One-piece
// rows store X'(j) = X(j) - e*j for the global offset j = w_r + lane:
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
// Two-piece costs (TWO_PIECE).  The launcher passes o = o1 + e1 - e2,
// e = e2 and ed = e1 (ops/cuda_fill.py:fill_constants); a third ring
// holds D2 (and, in the rows body, one more scratch row its new value).
// Rows are untilted, as the TPU's two-piece kernels keep them (with drift
// a ring margin keeps values a roll left behind, C7, and a tilted row
// would read them at another offset's tilt); with j = w_r + lane
// (+ sigma_b(r)):
//   D    = min(min_pm + o + e, min_pd + ed)        (D1; o + e = o1 + e1)
//   D2   = min(min_pd, min_pd2) + e
//   diag = min_pm(lane - 1) + (match ? 0 : x), INF at lane 0
//   A    = min(diag, D, D2), and min(A, 0) at (rank 0, j = 0)
//   I    = min(prefix_min_cap(A - e*lane)(lane - 1) + e*lane + o, INF),
//          INF at lane 0 (tilted over the lane, not the offset: the two
//          differ by one constant a rank, and A - e*lane never passes INF
//          where drift makes offsets negative)
//   M    = min(A, I)
// The TPU kernels scan the coupled (I1, I2) pair as a 2x2 min-plus
// doubling scan.  Only M = min(A, I1, I2) enters a ring, and with
// e1 >= e2 (GapAffine2Piece) a run of k >= 1 inserted lanes costs
// o1 + e1 + (k - 1) * e2 at best, so min(I1, I2) is the one-piece
// insertion with slope e2: one truncated prefix-min, the same look-back
// window as the TPU's truncated scan (tests/test_torch_two_piece.py holds
// the two equal, capped and uncapped).
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
// read's rank loop is sequential.  The work per rank is ~Wb lanes x (P ring
// reads + 13 operations), a few hundred KB of shared-memory traffic and a
// few thousand instructions for the whole band, so what bounds a rank is
// how many passes over the band it takes, the barriers between them and
// the latency each exposes, not DRAM bandwidth or arithmetic.
//
// What the design does about it (the register body, banded_reg_kernel;
// its gather, scan, DPX helpers and placement are reg_body.cuh's, shared
// with fill_kernel.cu's register body):
//   * one block per read, so the 1024 reads of a batch fill the card's 132
//     SMs in waves with no cross-block traffic;
//   * thread t owns K contiguous lanes [tK, tK + K), K in {4, 8, 16} the
//     smallest that keeps the block at or under its thread limit
//     (banded_lanes, banded_reg_max_threads: no spills).  The rank's
//     min_pm, D, D2, A, I and M stay in its registers: no scratch row in
//     shared memory;
//   * each thread gathers K + 1 lanes of every predecessor row, its own and
//     lane tK - 1, so the diagonal min_pm(lane - 1) is its own register
//     (INF at lane 0; index -1 is never read).  Window starts, predecessor
//     starts, margin, the drift rotation and TOT are all multiples of 128,
//     so a K-lane group is 16-byte aligned and never straddles the drift
//     wrap: rings, query and the ENDS == 1 best row move as int4;
//   * the truncated prefix-min is van Herk / Gil-Werman over segments of w
//     lanes (prefix_min.cuh: window_scan_warp / window_scan_block): serial
//     over the thread's lanes, shuffles across the warp, one array of warp
//     carries across warps, and the suffix w lanes left through one shared
//     row;
//   * BANDED_REG_BARRIERS = 2 barriers a rank: one for the scan's carries
//     and suffix row, one after the ring write; a drift re-frame adds one
//     where it clears its 128 wrapped lanes (3 + log2(cap) before).  D and
//     D2 are stored before the first (a rank never gathers from the slot
//     it writes), so only the scan's input and M cross it in registers;
//   * Hopper's DPX instructions where they give the same bits:
//     __viaddmin_s32 = min(a + b, c) for D and the INF clamps, __vimin3_s32
//     for the two-piece A = min(diag, D1, D2); every value stays within
//     +-2^29, so no add wraps.
// The rings keep their layout, contents, ring_at and 128-lane wrap (C7's
// stale drift margins stay bit for bit).  Placement is decided on the rings
// alone: they stay in shared memory where they fit beside the suffix row,
// the warp carries and (ENDS == 1) the Lq-lane best row; two-piece rings
// that do not fit whole keep M and D1 there and D2 in a per-block global
// slab (PLACE_RINGS_SPLIT: B16 153.9 against 200.0 ms with all three in the
// slab, B17 124.0 against 170.0, chip_kernel_times.py on an H100); else
// all go to the slab.  The ENDS == 2 best row lives in registers: each
// thread owns its lanes across all ranks.
//
// Rows wider than the register body takes (10,752 lanes for B1, 8,192 for
// B3, B5, B6 and B16, 6,144 for B17: banded_lanes), such as a clamped
// full-width tier of a read past 6-10 kb or the card test at L 40,960,
// take the rows body (banded_rows_kernel): the template's first body, with
// scratch rows and each pass strided over the band (coalesced where the
// rows live in global memory), now with the same window scan over
// per-thread chunks of a power of two >= Wb / 1024 lanes, int4 a step, in
// two passes that leave Ex and the whole suffix in its two scan rows:
// BANDED_ROWS_BARRIERS = 5 barriers a rank.  banded_plan chooses by shape
// alone (banded_lanes), never on a failure.
// The template's flags are compile-time, so the global instantiation
// carries none of the others' rotation, seeding, best-row or D2 code.
#include <stdint.h>

#include "common.cuh"
#include "prefix_min.cuh"
#include "reg_body.cuh"

enum {
    VARIANT_GLOBAL = 1,
    VARIANT_DRIFT = 3,
    VARIANT_EF = 5,
    VARIANT_DRIFT_EF = 6,
    VARIANT_GLOBAL_2P = 16,
    VARIANT_DRIFT_2P = 17,
};

// Barriers a rank takes, a drift re-frame's one not counted.
#define BANDED_REG_BARRIERS REG_BARRIERS
#define BANDED_ROWS_BARRIERS 5
// Threads a register-body block may have at K lanes a thread, so that its
// registers (65,536 over the threads, rounded as ptxas rounds them to 4
// warps) hold the K-lane gather without spilling: min_pm, D and D2 of K
// lanes are live at once, and ENDS == 2's best tile throughout.  K 4:
// 1,024 threads, 64 registers.  K 8: 768, 80; 640, 96 with ENDS == 2.
// K 16: 672, 80 for the one-piece global body (10,752 lanes: B11's first
// tier at 40 kb); else 512, 128.  Each limit is the largest at which ptxas
// reported no spill.  The drifting two-piece body has no K 16: it spills
// past 384 threads there, which reach no further than K 8's 768
// (banded_max_lanes).
__host__ __device__ constexpr int banded_reg_max_threads(bool drift, int ends,
                                                         bool two_piece,
                                                         int K) {
    return K == 4   ? 1024
           : K == 8 ? (ends == 2 ? 640 : 768)
           : (!drift && ends == 0 && !two_piece) ? 672
                                                 : 512;
}
struct BandedShape {
    int Lq, mq, log2S, n_nodes, end_rank, W, P, Wb, margin, o, e, ed, x, cap;
    int free_start;
    long long global_ints;
    int mode;
    int lanes;     // the rows body's lanes a thread
    int side_ints; // the register body's best row + suffix row
    int qvec;      // query rows 16-byte aligned: int4 loads
};

static inline bool banded_two_piece(int variant) {
    return variant == VARIANT_GLOBAL_2P || variant == VARIANT_DRIFT_2P;
}

static inline int banded_rings(int variant) {
    return banded_two_piece(variant) ? 3 : 2;
}

static inline bool banded_drift(int variant) {
    return variant == VARIANT_DRIFT || variant == VARIANT_DRIFT_EF
           || variant == VARIANT_DRIFT_2P;
}

static inline int banded_ends(int variant) {
    return variant == VARIANT_EF ? 1 : (variant == VARIANT_DRIFT_EF ? 2 : 0);
}

// The register body's widest K: 8 for the drifting two-piece body (B17),
// 16 for the others.
static inline int banded_max_lanes(int variant) {
    return variant == VARIANT_DRIFT_2P ? 8 : 16;
}

// Lanes a thread of the register body owns at band width Wb: the smallest
// K in {4, 8, 16} whose ceil(Wb / K) threads, rounded up to a warp, fit the
// variant's thread limit; 0 past it (10,752 lanes for B1, 8,192 for B3,
// B5, B6 and B16, 6,144 for B17), where the rows body takes the band.
static inline int banded_lanes(int variant, int Wb) {
    for (int K = 4; K <= banded_max_lanes(variant); K *= 2)
        if (round_up((Wb + K - 1) / K, 32)
            <= banded_reg_max_threads(banded_drift(variant),
                                      banded_ends(variant),
                                      banded_two_piece(variant), K))
            return K;
    return 0;
}

// The rows body's chunk: a power of two >= Wb / 1024 lanes a thread.
static inline int banded_rows_chunk(int Wb) {
    int c = 1;
    while ((long long)c * 1024 < Wb) c <<= 1;
    return c;
}

// ---- the register body --------------------------------------------------

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
#define BANDED_PARAMS                                                         \
    const int* __restrict__ symbols,      /* (Np,) */                         \
    const int* __restrict__ pred_slots,   /* (Np*P,) ring slot per pred */    \
    const int* __restrict__ pred_valid,   /* (Np*P,) 0/1 */                   \
    const int* __restrict__ pred_wstarts, /* (Np*P,) pred window starts */    \
    const int* __restrict__ wstarts,      /* (Np,) frame starts (may be    */ \
                                          /* negative with drift) */          \
    const int* __restrict__ wslots,       /* (Np,) ring slot each rank    */  \
                                          /* writes */                        \
    const int* __restrict__ s_ranks,      /* (Np,) cumulative drift steps */  \
    const int* __restrict__ s_prev,       /* (Np,) the previous rank's */     \
    const int* __restrict__ end_ok,       /* (Np,) 0/1 (ends-free) */         \
    const int* __restrict__ qrows,        /* (B, Lq); MQ zero lanes on the */ \
                                          /* left with drift */               \
    const int* __restrict__ nbs_b,        /* (B,) drift units per read */     \
    const int* __restrict__ jlo_b,        /* (B,) lowest end offset (E2) */   \
    const int* __restrict__ len_b,        /* (B,) read lengths (ENDS 2) */    \
    BandedShape a,                                                            \
    int* __restrict__ out_rows, /* (B, Wb), or (B, Lq) for ENDS == 1 */       \
    int* gws

template <bool DRIFT, int ENDS, bool TWO_PIECE, int K>
__global__ void __launch_bounds__(
    banded_reg_max_threads(DRIFT, ENDS, TWO_PIECE, K), 1)
banded_reg_kernel(BANDED_PARAMS) {
    extern __shared__ __align__(16) int smem[];
    const int Wb = a.Wb, W = a.W, P = a.P, margin = a.margin;
    const int o = a.o, e = a.e, x = a.x;
    const int ed = TWO_PIECE ? a.ed : e;  // the deletion extension
    const int tilt = TWO_PIECE ? 0 : e;   // the rows' tilt
    const int n_nodes = a.n_nodes, end_rank = a.end_rank;
    const int TOT = Wb + 2 * margin;
    const int n_rings = TWO_PIECE ? 3 : 2;
    int w = 1;  // the scan's window: the first power of two >= cap
    while (w < a.cap) w <<= 1;
    const bool windowed = w < Wb;  // else the window is the whole prefix
    const long long ring_ints = (long long)W * TOT;
    int *carry, *side, *mring, *d2ring;  // D2: two-piece only
    reg_workspace(a.mode, smem, gws, a.global_ints, a.side_ints,
                         ring_ints, &carry, &side, &mring, &d2ring);
    int* dring = mring + ring_ints;
    int* best = side;                 // ENDS == 1: (Lq,) positional
    int* suf = side + (ENDS == 1 ? round_up(a.Lq, 4) : 0);  // (Wb,)
    const int b = blockIdx.x;
    const int* q = qrows + (long long)b * a.Lq;
    int* out = out_rows + (long long)b * (ENDS == 1 ? a.Lq : Wb);
    const int nbs = DRIFT ? nbs_b[b] : 0;
    const int jlo = ENDS == 2 ? jlo_b[b] : 0;
    const int len = ENDS == 2 ? len_b[b] : 0;
    const int base = threadIdx.x * K;  // this thread's lanes [base, base + K)
    const bool active = base < Wb;     // Wb is a multiple of 128
    int rot = 0;     // ring rotation in lanes, < TOT (drift)
    int rolled = 0;  // lanes the read's frame has rolled left so far (drift)
    int bestr[K];    // ENDS == 2: this thread's lanes of the best tile
#pragma unroll
    for (int k = 0; k < K; ++k) bestr[k] = POASTA_INF;

    for (long long i = threadIdx.x; i < 2 * ring_ints; i += blockDim.x)
        mring[i] = POASTA_INF;  // the D ring follows the M ring
    if (TWO_PIECE)
        for (long long i = threadIdx.x; i < ring_ints; i += blockDim.x)
            d2ring[i] = POASTA_INF;
    if (ENDS == 1)
        for (int i = threadIdx.x; i < a.Lq; i += blockDim.x)
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
                // new right edge of every M and D (and D2) row
                for (int i = threadIdx.x; i < n_rings * W * 128;
                     i += blockDim.x) {
                    int t = rot + (i & 127);
                    if (t >= TOT) t -= TOT;
                    const int row = i >> 7;  // M rows, D rows, D2 rows
                    if (row < 2 * W)
                        mring[(long long)row * TOT + t] = POASTA_INF;
                    else
                        d2ring[(long long)(row - 2 * W) * TOT + t] =
                            POASTA_INF;
                }
                rot += 128;
                if (rot >= TOT) rot -= TOT;
                rolled += 128;
                __syncthreads();
            }
        }
        const int lane0 = margin + (DRIFT ? rot : 0);
        const bool is_end = r == end_rank;
        const bool seeds = r == 0 || (ENDS == 1 && a.free_start && !is_end);

        // this rank's ring row; a rank never gathers from the slot it
        // writes (the liveness colouring frees a slot only after the rank
        // of its last reader, aligner/wavefront.py:_color_ring_slots), so
        // D and D2 go out before the barrier and leave the registers
        const long long woff =
            ring_at<DRIFT>((long long)wslots[r] * TOT, lane0, base, TOT);
        const bool permitted = ENDS != 0 && end_ok[r] == 1;

        // gather K + 1 lanes of each predecessor row: p = 0 unconditionally
        // (rank 0 reads an all-INF row)
        int pm[K], pd[K], pd2[K], s[K];
        int pm_left = POASTA_INF;  // min_pm at lane base - 1
        int agg = POASTA_INF;      // min of s over this thread's lanes
        if (active) {
            {
                const int d0 = min(max(w_r - pw[0], -margin), margin);
                const long long row = (long long)ps[0] * TOT;
                gather_lanes<K, TWO_PIECE>(
                    mring, dring, d2ring,
                    ring_at<DRIFT>(row, lane0 + d0, base, TOT), true, pm, pd,
                    pd2);
                if (base > 0)
                    pm_left = mring[ring_at<DRIFT>(row, lane0 + d0, base - 1,
                                                   TOT)];
            }
            for (int p = 1; p < P; ++p) {
                if (pv[p] != 1) continue;
                const int dp = min(max(w_r - pw[p], -margin), margin);
                const long long row = (long long)ps[p] * TOT;
                gather_lanes<K, TWO_PIECE>(
                    mring, dring, d2ring,
                    ring_at<DRIFT>(row, lane0 + dp, base, TOT), false, pm, pd,
                    pd2);
                if (base > 0)
                    pm_left = min(pm_left, mring[ring_at<DRIFT>(
                                               row, lane0 + dp, base - 1,
                                               TOT)]);
            }
            if (is_end) {
                // M = min_pm, the stored D (and D2) INF
                const int4 inf4 = make_int4(POASTA_INF, POASTA_INF,
                                            POASTA_INF, POASTA_INF);
#pragma unroll
                for (int c = 0; c < K / 4; ++c) {
                    *reinterpret_cast<int4*>(dring + woff + 4 * c) = inf4;
                    if (TWO_PIECE)
                        *reinterpret_cast<int4*>(d2ring + woff + 4 * c) = inf4;
                }
            } else {
                // descending, so lane k's min_pm is still there for k + 1;
                // the query comes in 4-lane chunks as the loop reaches them
                const int qi = w_r + (DRIFT ? a.mq + rolled : 0) + base;
#pragma unroll
                for (int c = K / 4 - 1; c >= 0; --c) {
                    const int q0 = qi + 4 * c;
                    int qv[4], dc[4], d2c[4];
                    if (a.qvec && (!DRIFT || q0 + 3 < a.Lq)) {
                        const int4 t = *reinterpret_cast<const int4*>(q + q0);
                        qv[0] = t.x;
                        qv[1] = t.y;
                        qv[2] = t.z;
                        qv[3] = t.w;
                    } else {
#pragma unroll
                        for (int u = 0; u < 4; ++u)
                            qv[u] = !DRIFT || q0 + u < a.Lq ? q[q0 + u] : 0;
                    }
#pragma unroll
                    for (int u = 3; u >= 0; --u) {
                        const int k = 4 * c + u;
                        const int src = k ? pm[k - 1] : pm_left;
                        const int dv = add_min(pm[k], o + e, pd[k] + ed);
                        int av;
                        if (TWO_PIECE) {
                            const int d2v = min(pd[k], pd2[k]) + e;
                            av = min3(src + (qv[u] == sym ? 0 : x), dv, d2v);
                            d2c[u] = min(d2v, POASTA_INF);
                        } else {
                            av = min(src + (qv[u] == sym ? -tilt : x - tilt),
                                     dv);
                        }
                        if (seeds && w_r + base + k + sig == 0)
                            av = min(av, 0);
                        dc[u] = min(dv, POASTA_INF);
                        // two-piece rows are untilted: scan A - e*lane
                        s[k] = TWO_PIECE ? av - e * (base + k) : av;
                        agg = min(agg, s[k]);
                    }
                    *reinterpret_cast<int4*>(dring + woff + 4 * c) =
                        make_int4(dc[0], dc[1], dc[2], dc[3]);
                    if (TWO_PIECE)
                        *reinterpret_cast<int4*>(d2ring + woff + 4 * c) =
                            make_int4(d2c[0], d2c[1], d2c[2], d2c[3]);
                }
            }
        }

        if (!is_end) {  // uniform across the block
            // untilted (two-piece) rows: scanned tilted, M tilted back
            reg_insertion<K, TWO_PIECE>(s, agg, base, active, w, windowed, o,
                                        e, carry, suf, pm);
        } else if (active && ENDS == 0) {
            st_lanes<K>(out + base, pm);  // the end row: min_pm
        }

        if (active) {
            st_lanes<K>(mring + woff, pm);
            if (permitted) {
                if (ENDS == 1) {
                    int cur[K];
                    ld_lanes<K>(best + w_r + base, cur);
#pragma unroll
                    for (int k = 0; k < K; ++k) cur[k] = min(cur[k], pm[k]);
                    st_lanes<K>(best + w_r + base, cur);
                } else {
#pragma unroll
                    for (int k = 0; k < K; ++k) {
                        const int j = w_r + base + k + sig;
                        if (j >= jlo && j <= len)
                            bestr[k] = min(bestr[k], pm[k] + e * j);
                    }
                }
            }
        }
        __syncthreads();  // barrier 2: the rings are written
    }
    if (ENDS == 1)
        for (int i = threadIdx.x; i < a.Lq; i += blockDim.x) out[i] = best[i];
    if (ENDS == 2 && active) st_lanes<K>(out + base, bestr);
}

// ---- the rows body: bands wider than the register body takes -------------

// Scratch rows of the rows body: min_pm, D, A, the scan's input and its
// suffix row (POASTA_ROWS), and D2 for two-piece costs.
static inline int banded_rows_count(int variant) {
    return POASTA_ROWS + (banded_two_piece(variant) ? 1 : 0);
}

// The rows body's best row, rounded to 4 lanes so that the slab of each
// block, and its scan rows, stay 16-byte aligned for the int4 scan.
static inline int banded_rows_best_lanes(int variant, int Wb, int Lq) {
    const int ends = banded_ends(variant);
    return ends == 1 ? round_up(Lq, 4) : (ends == 2 ? Wb : 0);
}

template <bool DRIFT, int ENDS, bool TWO_PIECE>
__global__ void banded_rows_kernel(BANDED_PARAMS) {
    extern __shared__ __align__(16) int smem[];
    const int Wb = a.Wb, W = a.W, P = a.P, margin = a.margin;
    const int o = a.o, e = a.e, x = a.x;
    const int ed = TWO_PIECE ? a.ed : e;
    const int tilt = TWO_PIECE ? 0 : e;
    const int n_nodes = a.n_nodes, end_rank = a.end_rank;
    const int TOT = Wb + 2 * margin;
    const int best_lanes = ENDS == 1 ? a.Lq : (ENDS == 2 ? Wb : 0);
    const int best_ints = round_up(best_lanes, 4);  // banded_rows_best_lanes
    const int n_rows = POASTA_ROWS + (TWO_PIECE ? 1 : 0);
    const int n_rings = TWO_PIECE ? 3 : 2;
    int w = 1;
    while (w < a.cap) w <<= 1;
    const bool windowed = w < Wb;
    const int CH = a.lanes;  // lanes a thread owns in the scan
    int* rows;
    int* mring;
    poasta_workspace(a.mode, smem, gws, a.global_ints,
                     (long long)n_rows * Wb + best_ints + REG_CARRY_INTS,
                     &rows, &mring);
    const long long ring_ints = (long long)W * TOT;
    int* dring = mring + ring_ints;
    int* d2ring = dring + ring_ints;
    int* pm_row = rows;
    int* d_row = rows + Wb;
    int* a_row = rows + 2 * Wb;
    int* s0 = rows + 3 * Wb;  // the scan's input
    int* s1 = rows + 4 * Wb;  // its suffix row
    int* d2_row = rows + 5 * Wb;
    int* best = rows + n_rows * Wb;
    int* carry = best + best_ints;
    const int b = blockIdx.x;
    const int* q = qrows + (long long)b * a.Lq;
    int* out = out_rows + (long long)b * (ENDS == 1 ? a.Lq : Wb);
    const int nbs = DRIFT ? nbs_b[b] : 0;
    const int jlo = ENDS == 2 ? jlo_b[b] : 0;
    const int len = ENDS == 2 ? len_b[b] : 0;
    const int base = threadIdx.x * CH;
    const int end = min(base + CH, Wb);
    int rot = 0;
    int rolled = 0;

    for (long long i = threadIdx.x; i < n_rings * ring_ints; i += blockDim.x)
        mring[i] = POASTA_INF;
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
                for (int i = threadIdx.x; i < n_rings * W * 128;
                     i += blockDim.x) {
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

        const int lane0 = margin + (DRIFT ? rot : 0);
        const int d0 = min(max(w_r - pw[0], -margin), margin);
        const long long row0 = (long long)ps[0] * TOT;
        for (int i = threadIdx.x; i < Wb; i += blockDim.x) {
            const long long off0 = ring_at<DRIFT>(row0, lane0 + d0, i, TOT);
            int pm = mring[off0];
            int pd = dring[off0];
            int pd2 = TWO_PIECE ? d2ring[off0] : 0;
            for (int p = 1; p < P; ++p) {
                if (pv[p] == 1) {
                    const int dp = min(max(w_r - pw[p], -margin), margin);
                    const long long off = ring_at<DRIFT>(
                        (long long)ps[p] * TOT, lane0 + dp, i, TOT);
                    pm = min(pm, mring[off]);
                    pd = min(pd, dring[off]);
                    if (TWO_PIECE) pd2 = min(pd2, d2ring[off]);
                }
            }
            pm_row[i] = pm;
            d_row[i] = min(pm + (o + e), pd + ed);
            if (TWO_PIECE) d2_row[i] = min(pd, pd2) + e;
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
            const int j = w_r + i + sig;
            int av = min(src + (qv == sym ? -tilt : x - tilt), d_row[i]);
            if (TWO_PIECE) av = min(av, d2_row[i]);
            if (seeds && j == 0) av = min(av, 0);
            a_row[i] = av;
            s0[i] = TWO_PIECE ? av - e * i : av;
        }
        __syncthreads();

        // the window scan over this thread's chunk (prefix_min.cuh), 4
        // lanes an access; the write pass below goes back to strided,
        // coalesced lanes, so the scan leaves Ex in place of its input
        // and the whole suffix in s1
        int agg = POASTA_INF;
        for (int i = base; i < end; i += 4) {
            const int4 t = *reinterpret_cast<const int4*>(s0 + i);
            agg = min(agg, min(min(t.x, t.y), min(t.z, t.w)));
        }
        const WindowWarp ww = window_scan_warp(agg, CH, w, carry);
        if (windowed) {
            int run = ww.ex_suf;
            for (int i = end - 4; i >= base; i -= 4) {
                const int4 t = *reinterpret_cast<const int4*>(s0 + i);
                int v[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
                for (int u = 3; u >= 0; --u) {
                    run = min(run, v[u]);
                    v[u] = run;
                    if (((i + u) & (w - 1)) == 0) run = POASTA_INF;
                }
                *reinterpret_cast<int4*>(s1 + i) =
                    make_int4(v[0], v[1], v[2], v[3]);
            }
        }
        __syncthreads();
        // the prefix carry, and the carry of the warps right of this one
        const int2 cb = window_scan_block(ww.ex_pre, CH, w, carry, true);
        {
            int run = cb.x;
            for (int i = base; i < end; i += 4) {
                const int4 t = *reinterpret_cast<const int4*>(s0 + i);
                int v[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    if (((i + u) & (w - 1)) == 0) run = POASTA_INF;
                    const int sv = v[u];
                    v[u] = run;  // Ex(i + u)
                    run = min(run, sv);
                }
                *reinterpret_cast<int4*>(s0 + i) =
                    make_int4(v[0], v[1], v[2], v[3]);
                if (windowed && cb.y < POASTA_INF) {
                    int4 f = *reinterpret_cast<const int4*>(s1 + i);
                    f = make_int4(min(f.x, cb.y), min(f.y, cb.y),
                                  min(f.z, cb.y), min(f.w, cb.y));
                    *reinterpret_cast<int4*>(s1 + i) = f;
                }
            }
        }
        __syncthreads();

        const bool permitted = ENDS != 0 && end_ok[r] == 1;
        const long long wrow = (long long)wslots[r] * TOT;
        for (int i = threadIdx.x; i < Wb; i += blockDim.x) {
            int m, d, d2 = POASTA_INF;
            if (is_end) {
                m = pm_row[i];
                d = POASTA_INF;
                if (ENDS == 0) out[i] = m;
            } else {
                int win = s0[i];  // Ex(i) ...
                if (windowed && i >= w) win = min(win, s1[i - w]);  // Suf
                const int back = TWO_PIECE ? e * i : 0;
                m = min(a_row[i], min(win + o + back, POASTA_INF));
                d = min(d_row[i], POASTA_INF);
                if (TWO_PIECE) d2 = min(d2_row[i], POASTA_INF);
            }
            const long long woff = ring_at<DRIFT>(wrow, lane0, i, TOT);
            mring[woff] = m;
            dring[woff] = d;
            if (TWO_PIECE) d2ring[woff] = d2;
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

// ---- plan and launch ------------------------------------------------------

struct BandedPlan {
    PoastaPlan p;
    int body;       // BODY_REGISTERS or BODY_ROWS
    int lanes;      // lanes a thread owns
    int side_ints;  // register body: best row + suffix row
};

static cudaError_t banded_plan(int variant, int W, int Wb, int margin, int Lq,
                               BandedPlan* plan) {
    if (variant != VARIANT_GLOBAL && variant != VARIANT_DRIFT
        && variant != VARIANT_EF && variant != VARIANT_DRIFT_EF
        && !banded_two_piece(variant))
        return cudaErrorInvalidValue;
    if (Wb <= 0 || Wb % 128 || margin % 128) return cudaErrorInvalidValue;
    const long long ring_ints =
        (long long)banded_rings(variant) * W * (Wb + 2 * margin);
    const int K = banded_lanes(variant, Wb);
    if (K == 0) {
        plan->body = BODY_ROWS;
        plan->lanes = banded_rows_chunk(Wb);
        plan->side_ints = 0;
        cudaError_t err = poasta_plan(
            Wb,
            (long long)banded_rows_count(variant) * Wb
                + banded_rows_best_lanes(variant, Wb, Lq) + REG_CARRY_INTS,
            ring_ints, &plan->p);
        plan->p.threads = round_up((Wb + plan->lanes - 1) / plan->lanes, 32);
        return err;
    }
    plan->body = BODY_REGISTERS;
    plan->lanes = K;
    plan->side_ints = (variant == VARIANT_EF ? round_up(Lq, 4) : 0) + Wb;
    plan->p.threads = round_up((Wb + K - 1) / K, 32);
    return reg_placement(plan->side_ints, ring_ints, banded_rings(variant),
                         &plan->p);
}

extern "C" int poasta_banded_plan(int variant, int W, int Wb, int margin,
                                  int Lq, int* threads, int* mode,
                                  int* smem_bytes, long long* global_ints,
                                  int* body, int* lanes, int* barriers) {
    BandedPlan plan;
    cudaError_t err = banded_plan(variant, W, Wb, margin, Lq, &plan);
    if (err != cudaSuccess) return (int)err;
    *threads = plan.p.threads;
    *mode = plan.p.mode;
    *smem_bytes = plan.p.smem_bytes;
    *global_ints = plan.p.global_ints;
    *body = plan.body;
    *lanes = plan.lanes;
    *barriers = plan.body == BODY_REGISTERS ? BANDED_REG_BARRIERS
                                            : BANDED_ROWS_BARRIERS;
    return 0;
}

extern "C" int poasta_banded_fill(
    int variant, const int* symbols, const int* pred_slots,
    const int* pred_valid, const int* pred_wstarts, const int* wstarts,
    const int* wslots, const int* s_ranks, const int* s_prev,
    const int* end_ok, const int* q, const int* nbs, const int* jlo,
    const int* len, int B, int Lq, int mq, int log2S, int n_nodes,
    int end_rank, int W, int P, int Wb, int margin, int o, int e, int ed,
    int x, int cap, int free_start, int* out, int* gws, long long gws_ints,
    void* stream) {
    BandedPlan plan;
    cudaError_t err = banded_plan(variant, W, Wb, margin, Lq, &plan);
    if (err != cudaSuccess) return (int)err;
    if (gws_ints < plan.p.global_ints * (long long)B)
        return (int)cudaErrorInvalidValue;
    const int qvec = Lq % 4 == 0 && ((uintptr_t)q & 15) == 0;
    BandedShape a = {Lq, mq, log2S, n_nodes, end_rank, W, P, Wb, margin, o, e,
                     ed, x, cap, free_start, plan.p.global_ints, plan.p.mode,
                     plan.lanes, plan.side_ints, qvec};
    cudaStream_t st = (cudaStream_t)stream;
    const int K = plan.body == BODY_REGISTERS ? plan.lanes : 0;
#define BANDED_ARGS                                                           \
    symbols, pred_slots, pred_valid, pred_wstarts, wstarts, wslots, s_ranks,  \
        s_prev, end_ok, q, nbs, jlo, len, a, out, gws
#define BANDED_LAUNCH_K8(DRIFT, ENDS, TP)                                     \
    (K == 4    ? poasta_launch(banded_reg_kernel<DRIFT, ENDS, TP, 4>, B,      \
                               plan.p, st, BANDED_ARGS)                       \
     : K == 8  ? poasta_launch(banded_reg_kernel<DRIFT, ENDS, TP, 8>, B,      \
                               plan.p, st, BANDED_ARGS)                       \
               : poasta_launch(banded_rows_kernel<DRIFT, ENDS, TP>, B,        \
                               plan.p, st, BANDED_ARGS))
#define BANDED_LAUNCH(DRIFT, ENDS, TP)                                        \
    (int)(K == 16 ? poasta_launch(banded_reg_kernel<DRIFT, ENDS, TP, 16>, B,  \
                                  plan.p, st, BANDED_ARGS)                    \
                  : BANDED_LAUNCH_K8(DRIFT, ENDS, TP))
    if (variant == VARIANT_GLOBAL) return BANDED_LAUNCH(false, 0, false);
    if (variant == VARIANT_DRIFT) return BANDED_LAUNCH(true, 0, false);
    if (variant == VARIANT_EF) return BANDED_LAUNCH(false, 1, false);
    if (variant == VARIANT_DRIFT_EF) return BANDED_LAUNCH(true, 2, false);
    if (variant == VARIANT_GLOBAL_2P) return BANDED_LAUNCH(false, 0, true);
    return (int)BANDED_LAUNCH_K8(true, 0, true);  // banded_max_lanes
#undef BANDED_LAUNCH
#undef BANDED_LAUNCH_K8
#undef BANDED_ARGS
}

extern "C" const char* poasta_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
