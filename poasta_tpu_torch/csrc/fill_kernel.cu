// Full-width gap-affine fill of a read batch against a POA graph (every
// offset of every rank): one kernel template for the global span (B2) and
// for ends-free spans (B4: a free graph begin where the span has one, a
// capped insertion scan, and a running min of the Match row over the ranks
// that may end the alignment; B7: beside that row, the first rank that
// reached each of its values, which anchors the traceback), and for
// two-piece costs under both (B12 global; B13 and B14 the two-piece B4 and
// B7).
//
// Replaces, in poasta_tpu/ops/pallas_fill.py:
//   BOUNDED == false         _fill_kernel with free_start = free_end = False
//                            (_pallas_exec / pallas_fill_scores)
//   BOUNDED == true          _fill_kernel_bounded
//                            (_pallas_exec_bounded / pallas_fill_scores_bounded)
//   BOUNDED and ENDS == true _fill_kernel_bounded_ends and its streamed twin
//                            _fill_kernel_bounded_big_ends
//                            (pallas_bounded_with_ends[_big]): the rank tables
//                            are read from global memory at any graph size
//   TWO_PIECE == true        _fill_kernel_2p with free_start = free_end = False
//                            (_pallas_exec_2p / pallas_fill_scores_2p)
//   BOUNDED and TWO_PIECE    _fill_kernel_bounded_2p
//                            (pallas_fill_scores_bounded_2p)
//   ... and ENDS             _fill_kernel_bounded_2p_ends and its streamed
//                            twin _fill_kernel_bounded_big_2p_ends
//                            (pallas_bounded_with_ends_2p[_big])
// Same inputs, same end row, best row or rank row, bit for bit.  The free
// graph ends of _fill_kernel and _fill_kernel_2p (free_start, free_end) are
// the bounded fills under an end mask (ops/cuda_fill.py:free_end_mask).
//
// Recurrence, per read and per topological rank r, over the offsets
// j = 0 .. L-1 (untilted):
//   min_pm, min_pd = min over predecessors of their M, D rows
//   D    = min(min_pm + o + e, min_pd + e)
//   diag = min_pm(j - 1) + (match ? 0 : x), INF at j = 0
//   A    = min(diag, D), and min(A, 0) at j = 0 of rank 0 or, bounded with a
//          free graph begin, of every rank but the end rank
//   I    = min(prefix_min_cap(A - e*j)(j - 1) + o + e*j, INF); the global
//          fill scans the whole row, the bounded one `cap` lanes (the capped
//          ladder's insertion-run bound)
//   M    = min(A, I)
//   best = min(best, M) at every rank r with end_ok[r] == 1 (bounded);
//          with ENDS, rank(j) = r wherever M < best: strictly, so the first
//          rank to reach a value keeps it; rank starts at 0
// At the end rank M = min_pm and the stored D is INF.  The global fill
// writes min_pm out there as the read's end row, which the caller reads at
// each read's length; the bounded fill writes `best` out after the last
// rank, and the caller takes the min over each read's [jlo, n].
//
// Two-piece costs (TWO_PIECE): the launcher passes o = o1 + e1 - e2, e = e2
// and ed = e1 (ops/cuda_fill.py:fill_constants); D (D1) extends at ed, a
// third ring holds D2 = min(min_pd, min_pd2) + e (INF at the end rank, as D
// is), and A = min(diag, D, D2).  The insertion term above is then the TPU
// kernel's coupled (I1, I2) scan folded into one prefix-min of A - e2*j,
// exact because only M = min(A, I1, I2) is stored and e1 >= e2 (see
// banded_kernel.cu).
//
// What bounds it on the H100: as for the banded kernel, a read's rank loop
// is sequential, and each rank spans the whole row (L = 5,120 lanes at the
// bench's 5 kb reads): ~L lanes x (P ring reads + ~15 operations) a rank,
// a few hundred KB of shared-memory traffic and a few thousand
// instructions for the whole row.  So what bounds a rank is the passes over
// the row it takes, the barriers between them and the latency each
// exposes, not DRAM bandwidth or arithmetic.  The first body took four
// passes a rank through scratch rows in shared memory (gather, A, the
// Hillis-Steele prefix-min's log2(cap) rounds, the write): 3 + log2(cap)
// barriers, 14 at the capped ladder's 2,048 and 16 uncapped at L 5,120,
// and with seven or eight scratch rows (143-164 KB) its rings never fit
// beside them: 2.0-2.5 ns per lane and rank per SM.
//
// What the design does about it (the register body, full_fill_reg_kernel;
// the gather, scan, DPX helpers and placement are reg_body.cuh's, shared
// with banded_kernel.cu's register body):
//   * one block per read, so a batch fills the card's 132 SMs in waves with
//     no cross-block traffic;
//   * thread t owns K contiguous lanes [tK, tK + K), K in {4, 8, 16} the
//     smallest that keeps the block at or under its instantiation's thread
//     limit (fill_lanes, fill_reg_max_threads: no spills).  The rank's
//     min_pm, D, D2, A, I and M stay in its registers, and so do the
//     bounded fill's best row and (ENDS) its rank row: each thread owns its
//     lanes across all ranks.  No scratch row in shared memory;
//   * each thread gathers K + 1 lanes of every valid predecessor row, its
//     own and lane tK - 1, so the diagonal min_pm(j - 1) is its own
//     register (INF at lane 0; index -1 is never read).  L is a multiple of
//     128 (pack_queries; the plan refuses other rows) and ring rows sit at
//     slot * L, so rings, the query row and the output rows move as int4;
//   * the insertion is van Herk / Gil-Werman over segments of w lanes, w
//     the first power of two >= cap (prefix_min.cuh: window_scan_warp /
//     window_scan_block), over A - e*j, then e*j added back and clamped at
//     INF: exactly block_prefix_min's window.  Uncapped (the global fills,
//     and B4 or B9 with max_run 0) w >= L and the scan is the plain prefix;
//   * FILL_REG_BARRIERS = 2 barriers a rank: one for the scan's carries and
//     suffix row, one after the ring write.  D and D2 are stored before the
//     first (a rank never gathers from the slot it writes), so only the
//     scan's input and M cross it in registers;
//   * DPX where it gives the same bits: __viaddmin_s32 for D and the INF
//     clamps, __vimin3_s32 for the two-piece A = min(diag, D1, D2); every
//     value stays within +-2^29, so no add wraps.
// On rows of 4-5 kb that is 0.43-0.60 ns per lane and rank per SM (B13
// 415.2 -> 101.9 ms at 1024 reads x 5,002 ranks, B14 544.9 -> 130.4 at 64
// reads x 50,002 ranks, both L 5,120: chip_kernel_times.py, parent and
// change in one call on an H100); 1.1-1.2 ns at L 1,024, whose 256-thread
// blocks hide less latency.
// Placement is decided on the rings alone (reg_placement): the rings go in
// shared memory where they fit beside the warp carries and the bounded
// fills' suffix row (reserved whatever the cap: the plan takes none), which
// holds B13's and B14's three rings at L 5,120 and W 3 (204,928 B); two-
// piece rings that do not fit whole keep M and D1 there and D2 in the
// block's global slab (PLACE_RINGS_SPLIT: B12 at W 5); else all go to the
// slab.
//
// Rows wider than the register body takes (8,192 lanes, 6,144 for B14:
// fill_reg_max_threads), such as the card tests' 12 kb reads, take the rows
// body (full_fill_rows_kernel): the template's first body, with scratch
// rows, passes strided over the row and block_prefix_min, 3 + log2(cap)
// barriers a rank, its rings placed by common.cuh's rule.  fill_plan
// chooses by shape alone (fill_lanes), never on a failure.  B2 and B4 are
// the ladders' last resort; B7 scores the first batch of a semi-global
// read stream, before the seeded corridor fill takes over; B12 is the
// two-piece ladder's last resort; B13 and B14 carry every two-piece
// ends-free batch, which has no banded or seeded kernel.  The rank tables
// are read from global memory at any graph size, so B14 also serves the
// graphs the TPU streamed (B15), and B4 runs B9's 50,002 ranks.
#include <stdint.h>

#include "common.cuh"
#include "prefix_min.cuh"
#include "reg_body.cuh"

struct FillFlags {
    bool bounded, ends, two_piece;
};

// variant codes: 0 global (B2), 1 bounded (B4), 2 bounded with end ranks
// (B7), 3 global with two-piece costs (B12), 4 bounded with two-piece costs
// (B13), 5 bounded with end ranks and two-piece costs (B14)
static inline bool fill_flags(int variant, FillFlags* flags) {
    static const FillFlags table[] = {
        {false, false, false}, {true, false, false}, {true, true, false},
        {false, false, true},  {true, false, true},  {true, true, true}};
    if (variant < 0 || variant > 5) return false;
    *flags = table[variant];
    return true;
}

// Barriers a rank of the register body takes.
#define FILL_REG_BARRIERS REG_BARRIERS

// Threads a register-body block may have at K lanes a thread, so that its
// registers (65,536 over the threads, rounded as ptxas rounds them to 4
// warps) hold the K-lane gather without spilling: min_pm, D and D2 of K
// lanes are live at once beside the bounded fill's best row and (ENDS) its
// rank row.  Each limit is the largest at which ptxas reported no spill
// (probed at 1,024, 896, 768, 704, 640, 576 and 512 threads at K 8, 512 to
// 256 at K 16).  K 4: 1,024 threads, 46-62 registers.  K 8: 1,024 for B2
// and B4 (64 registers), 896 for B7 and B12 (72; B7 spills 8 B at 1,024),
// 768 for B13 (80), 640 for B14 (96; it spills 20-56 B from 704 up, so its
// rank row stays in registers at K 8's 640: 5,120 lanes).  K 16: 512
// (108-128), 384 for B14 (166).  So the register body takes rows of up to
// 8,192 lanes, B14's up to 6,144.
__host__ __device__ constexpr int fill_reg_max_threads(bool bounded,
                                                       bool ends,
                                                       bool two_piece, int K) {
    return K == 4 ? 1024
           : K == 8
               ? (two_piece ? (!bounded ? 896 : !ends ? 768 : 640)
                            : (ends ? 896 : 1024))
           : (two_piece && ends) ? 384
                                 : 512;
}

// Lanes a thread of the register body owns on rows of L lanes: the
// smallest K in {4, 8, 16} whose L / K threads, rounded up to a warp, fit
// the variant's thread limit; 0 past it, where the rows body takes the row.
static inline int fill_lanes(FillFlags f, int L) {
    for (int K = 4; K <= 16; K *= 2)
        if (round_up(L / K, 32)
            <= fill_reg_max_threads(f.bounded, f.ends, f.two_piece, K))
            return K;
    return 0;
}

// the rows body's scratch rows: POASTA_ROWS, then D2 (two-piece), best
// (bounded) and the rank row (ends)
static inline long long fill_row_ints(FillFlags f, int L) {
    return (long long)(POASTA_ROWS + f.two_piece + f.bounded + f.ends) * L;
}

static inline long long fill_ring_ints(FillFlags f, int W, int L) {
    return (f.two_piece ? 3LL : 2LL) * W * L;
}

// The register body's side row: the bounded fills' suffix row (the
// global fills scan the whole prefix).
__host__ __device__ inline int fill_side_ints(bool bounded, int L) {
    return bounded ? L : 0;
}

// The read-only pointers are kernel parameters of their own, const and
// __restrict__, so the compiler may keep a rank's table entries in
// registers across the stores of a lane loop.
#define FILL_PARAMS                                                           \
    const int* __restrict__ symbols,    /* (Np,) */                           \
    const int* __restrict__ pred_slots, /* (Np*P,) */                         \
    const int* __restrict__ pred_valid, /* (Np*P,) 0/1 */                     \
    const int* __restrict__ wslots,     /* (Np,) */                           \
    const int* __restrict__ end_ok,     /* (Np,) 0/1 (bounded) */             \
    const int* __restrict__ qshift,     /* (B, L) */                          \
    int L, int n_nodes, int end_rank, int W, int P, int o, int e, int ed_in,  \
    int x, int cap, int free_start,                                           \
    int* __restrict__ out_rows,  /* (B, L): end rows, or best rows */         \
    int* __restrict__ out_ranks, /* (B, L): first rank at best (ENDS) */      \
    int *gws, long long global_ints, int mode

// ---- the register body ----------------------------------------------------

template <bool BOUNDED, bool ENDS, bool TWO_PIECE, int K>
__global__ void __launch_bounds__(
    fill_reg_max_threads(BOUNDED, ENDS, TWO_PIECE, K), 1)
full_fill_reg_kernel(FILL_PARAMS) {
    extern __shared__ __align__(16) int smem[];
    const int ed = TWO_PIECE ? ed_in : e;  // the deletion extension
    int w = 1;  // the scan's window: the first power of two >= cap
    while (w < (BOUNDED ? cap : L)) w <<= 1;
    const bool windowed = w < L;  // else the window is the whole prefix
    const long long ring_ints = (long long)W * L;
    int *carry, *suf, *mring, *d2ring;  // D2: two-piece only
    reg_workspace(mode, smem, gws, global_ints, fill_side_ints(BOUNDED, L),
                  ring_ints, &carry, &suf, &mring, &d2ring);
    int* dring = mring + ring_ints;
    const int* q = qshift + (long long)blockIdx.x * L;
    int* out = out_rows + (long long)blockIdx.x * L;
    const int base = threadIdx.x * K;  // this thread's lanes [base, base + K)
    const bool active = base < L;      // L is a multiple of 128
    int best[K], bestr[K];  // bounded: this thread's lanes of the best row
#pragma unroll
    for (int k = 0; k < K; ++k) {
        best[k] = POASTA_INF;
        bestr[k] = 0;
    }

    const int4 inf4 = make_int4(POASTA_INF, POASTA_INF, POASTA_INF,
                                POASTA_INF);
    for (long long i = threadIdx.x; i < ring_ints / 2; i += blockDim.x)
        reinterpret_cast<int4*>(mring)[i] = inf4;  // the D ring follows M's
    if (TWO_PIECE)
        for (long long i = threadIdx.x; i < ring_ints / 4; i += blockDim.x)
            reinterpret_cast<int4*>(d2ring)[i] = inf4;
    __syncthreads();

    for (int r = 0; r < n_nodes; ++r) {
        const int sym = symbols[r];
        const int* ps = pred_slots + (long long)r * P;
        const int* pv = pred_valid + (long long)r * P;
        const bool is_end = r == end_rank;
        const bool seeds = BOUNDED && free_start ? !is_end : r == 0;
        // this rank's ring row; a rank never gathers from the slot it
        // writes (the liveness colouring frees a slot only after the rank
        // of its last reader, aligner/wavefront.py:_color_ring_slots), so
        // D and D2 go out before the barrier and leave the registers
        const long long woff = (long long)wslots[r] * L + base;
        const bool permitted = BOUNDED && end_ok[r] == 1;

        // gather K + 1 lanes of each predecessor row: p = 0 unconditionally
        // (rank 0 reads an all-INF row)
        int pm[K], pd[K], pd2[K], s[K];
        int pm_left = POASTA_INF;  // min_pm at lane base - 1
        int agg = POASTA_INF;      // min of s over this thread's lanes
        if (active) {
            {
                const long long off = (long long)ps[0] * L + base;
                gather_lanes<K, TWO_PIECE>(mring, dring, d2ring, off, true, pm,
                                           pd, pd2);
                if (base > 0) pm_left = mring[off - 1];
            }
            for (int p = 1; p < P; ++p) {
                if (pv[p] != 1) continue;
                const long long off = (long long)ps[p] * L + base;
                gather_lanes<K, TWO_PIECE>(mring, dring, d2ring, off, false,
                                           pm, pd, pd2);
                if (base > 0) pm_left = min(pm_left, mring[off - 1]);
            }
            if (is_end) {
                // M = min_pm, the stored D (and D2) INF
#pragma unroll
                for (int c = 0; c < K / 4; ++c) {
                    *reinterpret_cast<int4*>(dring + woff + 4 * c) = inf4;
                    if (TWO_PIECE)
                        *reinterpret_cast<int4*>(d2ring + woff + 4 * c) = inf4;
                }
            } else {
                // descending, so lane k's min_pm is still there for k + 1;
                // the query comes in 4-lane chunks as the loop reaches them
#pragma unroll
                for (int c = K / 4 - 1; c >= 0; --c) {
                    const int4 qt =
                        *reinterpret_cast<const int4*>(q + base + 4 * c);
                    const int qv[4] = {qt.x, qt.y, qt.z, qt.w};
                    int dc[4], d2c[4];
#pragma unroll
                    for (int u = 3; u >= 0; --u) {
                        const int k = 4 * c + u;
                        const int j = base + k;
                        const int src = k ? pm[k - 1] : pm_left;
                        const int mc = qv[u] == sym ? 0 : x;
                        const int dv = add_min(pm[k], o + e, pd[k] + ed);
                        int av;
                        if (TWO_PIECE) {
                            const int d2v = min(pd[k], pd2[k]) + e;
                            av = min3(src + mc, dv, d2v);
                            d2c[u] = min(d2v, POASTA_INF);
                        } else {
                            av = min(src + mc, dv);
                        }
                        if (seeds && j == 0) av = min(av, 0);
                        dc[u] = min(dv, POASTA_INF);
                        s[k] = av - e * j;  // rows are untilted: scan A - e*j
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
            reg_insertion<K, true>(s, agg, base, active, w, windowed, o, e,
                                   carry, suf, pm);
        } else if (active && !BOUNDED) {
            st_lanes<K>(out + base, pm);  // the end row: min_pm
        }

        if (active) {
            st_lanes<K>(mring + woff, pm);
            if (permitted) {
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    if (ENDS) {
                        // strictly: the first rank to reach a value keeps it
                        if (pm[k] < best[k]) {
                            best[k] = pm[k];
                            bestr[k] = r;
                        }
                    } else {
                        best[k] = min(best[k], pm[k]);
                    }
                }
            }
        }
        __syncthreads();  // barrier 2: the rings are written
    }
    if (BOUNDED && active) st_lanes<K>(out + base, best);
    if (ENDS && active)
        st_lanes<K>(out_ranks + (long long)blockIdx.x * L + base, bestr);
}

// ---- the rows body: rows wider than the register body takes --------------

template <bool BOUNDED, bool ENDS, bool TWO_PIECE>
__global__ void full_fill_rows_kernel(FILL_PARAMS) {
    extern __shared__ __align__(16) int smem[];
    const int ed = TWO_PIECE ? ed_in : e;  // the deletion extension
    const int n_rings = TWO_PIECE ? 3 : 2;
    int* rows;
    int* mring;
    poasta_workspace(mode, smem, gws, global_ints,
                     (long long)(POASTA_ROWS + (BOUNDED ? 1 : 0)
                                 + (ENDS ? 1 : 0) + (TWO_PIECE ? 1 : 0)) * L,
                     &rows, &mring);
    const long long ring_ints = (long long)W * L;
    int* dring = mring + ring_ints;
    int* d2ring = dring + ring_ints;  // two-piece only
    int* pm_row = rows;
    int* d_row = rows + L;
    int* a_row = rows + 2 * L;
    int* s0 = rows + 3 * L;
    int* s1 = rows + 4 * L;
    int* d2_row = rows + 5 * L;  // two-piece only
    int* best = rows + (TWO_PIECE ? 6 : 5) * L;   // bounded only
    int* bestr = rows + (TWO_PIECE ? 7 : 6) * L;  // ends only
    const int* q = qshift + (long long)blockIdx.x * L;
    int* out = out_rows + (long long)blockIdx.x * L;

    for (long long i = threadIdx.x; i < n_rings * ring_ints; i += blockDim.x)
        mring[i] = POASTA_INF;  // the D (and D2) rings follow the M ring
    if (BOUNDED)
        for (int j = threadIdx.x; j < L; j += blockDim.x)
            best[j] = POASTA_INF;
    if (ENDS)
        for (int j = threadIdx.x; j < L; j += blockDim.x) bestr[j] = 0;
    __syncthreads();

    for (int r = 0; r < n_nodes; ++r) {
        const int sym = symbols[r];
        const int* ps = pred_slots + (long long)r * P;
        const int* pv = pred_valid + (long long)r * P;

        // gather: p = 0 is unconditional (rank 0 reads an all-INF row)
        const long long base0 = (long long)ps[0] * L;
        for (int j = threadIdx.x; j < L; j += blockDim.x) {
            int pm = mring[base0 + j];
            int pd = dring[base0 + j];
            int pd2 = TWO_PIECE ? d2ring[base0 + j] : 0;
            for (int p = 1; p < P; ++p) {
                if (pv[p] == 1) {
                    const long long off = (long long)ps[p] * L + j;
                    pm = min(pm, mring[off]);
                    pd = min(pd, dring[off]);
                    if (TWO_PIECE) pd2 = min(pd2, d2ring[off]);
                }
            }
            pm_row[j] = pm;
            d_row[j] = min(pm + (o + e), pd + ed);
            if (TWO_PIECE) d2_row[j] = min(pd, pd2) + e;
        }
        __syncthreads();

        const bool is_end = r == end_rank;
        const bool seeds = BOUNDED && free_start ? !is_end : r == 0;
        for (int j = threadIdx.x; j < L; j += blockDim.x) {
            const int src = j >= 1 ? pm_row[j - 1] : POASTA_INF;
            const int mc = q[j] == sym ? 0 : x;
            int a = min(src + mc, d_row[j]);
            if (TWO_PIECE) a = min(a, d2_row[j]);
            if (seeds && j == 0) a = min(a, 0);
            a_row[j] = a;
            s0[j] = a - e * j;
        }
        __syncthreads();
        const int* pref = block_prefix_min(s0, s1, L, BOUNDED ? cap : L);

        const bool permitted = BOUNDED && end_ok[r] == 1;
        const long long wbase = (long long)wslots[r] * L;
        for (int j = threadIdx.x; j < L; j += blockDim.x) {
            int m, d, d2 = POASTA_INF;
            if (is_end) {
                m = pm_row[j];
                d = POASTA_INF;
                if (!BOUNDED) out[j] = m;
            } else {
                const int pm1 = j >= 1 ? pref[j - 1] : POASTA_INF;
                m = min(a_row[j], min(pm1 + o + e * j, POASTA_INF));
                d = min(d_row[j], POASTA_INF);
                if (TWO_PIECE) d2 = min(d2_row[j], POASTA_INF);
            }
            mring[wbase + j] = m;
            dring[wbase + j] = d;
            if (TWO_PIECE) d2ring[wbase + j] = d2;
            if (ENDS) {
                if (permitted && m < best[j]) {
                    best[j] = m;
                    bestr[j] = r;
                }
            } else if (permitted) {
                best[j] = min(best[j], m);
            }
        }
        __syncthreads();
    }
    if (BOUNDED)
        for (int j = threadIdx.x; j < L; j += blockDim.x) out[j] = best[j];
    if (ENDS) {
        int* outr = out_ranks + (long long)blockIdx.x * L;
        for (int j = threadIdx.x; j < L; j += blockDim.x) outr[j] = bestr[j];
    }
}

// ---- plan and launch ---------------------------------------------------

struct FillPlan {
    PoastaPlan p;
    int body;   // BODY_REGISTERS or BODY_ROWS
    int lanes;  // lanes a thread owns (the rows body: strides over)
};

static cudaError_t fill_plan(int variant, int W, int L, FillFlags* flags,
                             FillPlan* plan) {
    if (!fill_flags(variant, flags)) return cudaErrorInvalidValue;
    // the register body's int4 rows need L a multiple of 4 and 16-byte
    // aligned row starts; pack_queries rounds L to 128
    if (L <= 0 || L % 128 || W <= 0) return cudaErrorInvalidValue;
    const FillFlags f = *flags;
    const int K = fill_lanes(f, L);
    if (K == 0) {
        plan->body = BODY_ROWS;
        cudaError_t err = poasta_plan(L, fill_row_ints(f, L),
                                      fill_ring_ints(f, W, L), &plan->p);
        plan->lanes = (L + plan->p.threads - 1) / plan->p.threads;
        return err;
    }
    plan->body = BODY_REGISTERS;
    plan->lanes = K;
    plan->p.threads = round_up(L / K, 32);
    return reg_placement(fill_side_ints(f.bounded, L),
                         fill_ring_ints(f, W, L), f.two_piece ? 3 : 2,
                         &plan->p);
}

extern "C" int poasta_fill_plan(int variant, int W, int L, int* threads,
                                int* mode, int* smem_bytes,
                                long long* global_ints) {
    FillFlags flags;
    FillPlan plan;
    cudaError_t err = fill_plan(variant, W, L, &flags, &plan);
    if (err != cudaSuccess) return (int)err;
    *threads = plan.p.threads;
    *mode = plan.p.mode;
    *smem_bytes = plan.p.smem_bytes;
    *global_ints = plan.p.global_ints;
    return 0;
}

// The body fill_plan chooses, its lanes a thread and the barriers a rank
// takes at scan cap `cap` (the rows body: 3 + its prefix-min's rounds).
extern "C" int poasta_fill_body(int variant, int W, int L, int cap, int* body,
                                int* lanes, int* barriers) {
    FillFlags flags;
    FillPlan plan;
    cudaError_t err = fill_plan(variant, W, L, &flags, &plan);
    if (err != cudaSuccess) return (int)err;
    *body = plan.body;
    *lanes = plan.lanes;
    int rounds = 0;
    for (int k = 1; k < (flags.bounded ? cap : L); k <<= 1) ++rounds;
    *barriers = plan.body == BODY_REGISTERS ? FILL_REG_BARRIERS : 3 + rounds;
    return 0;
}

// `variant` = 0: the global fill (end_ok may be null; cap and free_start
// are not read); 1: the ends-free fill; 2: the ends-free fill that also
// writes `out_ranks`; 3, 4, 5: 0, 1, 2 with two-piece costs (`ed` is read
// only there).  qshift, out_rows and out_ranks start 16-byte aligned.
extern "C" int poasta_full_fill(
    int variant, const int* symbols, const int* pred_slots,
    const int* pred_valid, const int* wslots, const int* end_ok,
    const int* qshift, int B, int L, int n_nodes, int end_rank, int W, int P,
    int o, int e, int ed, int x, int cap, int free_start, int* out_rows,
    int* out_ranks, int* gws, long long gws_ints, void* stream) {
    FillFlags flags;
    FillPlan plan;
    cudaError_t err = fill_plan(variant, W, L, &flags, &plan);
    if (err != cudaSuccess) return (int)err;
    if (gws_ints < plan.p.global_ints * (long long)B)
        return (int)cudaErrorInvalidValue;
    if (((uintptr_t)qshift | (uintptr_t)out_rows | (uintptr_t)out_ranks)
        & 15)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int K = plan.body == BODY_REGISTERS ? plan.lanes : 0;
#define FILL_ARGS                                                             \
    symbols, pred_slots, pred_valid, wslots, end_ok, qshift, L, n_nodes,      \
        end_rank, W, P, o, e, ed, x, cap, free_start, out_rows, out_ranks,    \
        gws, plan.p.global_ints, plan.p.mode
#define FILL_LAUNCH(BOUNDED, ENDS, TP)                                        \
    (int)(K == 4 ? poasta_launch(full_fill_reg_kernel<BOUNDED, ENDS, TP, 4>, \
                                 B, plan.p, st, FILL_ARGS)                    \
          : K == 8                                                            \
              ? poasta_launch(full_fill_reg_kernel<BOUNDED, ENDS, TP, 8>, B,  \
                              plan.p, st, FILL_ARGS)                          \
          : K == 16                                                           \
              ? poasta_launch(full_fill_reg_kernel<BOUNDED, ENDS, TP, 16>, B, \
                              plan.p, st, FILL_ARGS)                          \
              : poasta_launch(full_fill_rows_kernel<BOUNDED, ENDS, TP>, B,    \
                              plan.p, st, FILL_ARGS))
    switch (variant) {
        case 5: return FILL_LAUNCH(true, true, true);
        case 4: return FILL_LAUNCH(true, false, true);
        case 3: return FILL_LAUNCH(false, false, true);
        case 2: return FILL_LAUNCH(true, true, false);
        case 1: return FILL_LAUNCH(true, false, false);
        default: return FILL_LAUNCH(false, false, false);
    }
#undef FILL_LAUNCH
#undef FILL_ARGS
}
