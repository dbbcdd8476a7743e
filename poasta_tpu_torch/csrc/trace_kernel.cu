// Device traceback: the pointer-emitting corridor refill (the decode that
// walks its planes is decode_kernel.cu).
//
// trace_fill_kernel replaces poasta_tpu/ops/pallas_trace.py:_trace_kernel
// (launched through _trace_exec / pallas_trace_align) and folds in its
// HBM-streamed twin _trace_kernel_big: per-rank tables are read from global
// memory at any graph size.  Same inputs, same pointer planes and anchor
// values, bit for bit.
//
// Fill, per read and per rank r, over a window of Wb lanes starting at the
// read's own 128-aligned offset w = wstarts[b, r] (monotone, steps of 0 or
// 128 per rank).  Rows store X'(j) = X(j) - e*j at j = w + lane:
//   pm, pd  = min over predecessors of their stored M', D' rows, each read
//             shifted left by (w - the start it was written at), INF past
//             its edge; pmidx/pdidx = the argmin, ties to the highest
//             column (`<=` in ascending p), invalid columns reading INF
//   D       = min(pm + o + e, pd + e); dsrc/dpidx follow the open branch
//             where it attains D
//   diag    = pm(lane - 1) + (q[w + lane] == sym ? -e : x - e), INF at
//             lane 0; q reads 0 past the padded row
//   A       = min(diag, D), and min(A, 0) at j = 0 of an origin rank: rank 0
//             or, with `free_start` (a free graph begin), every rank but
//             the end rank
//   I       = min(prefix_min(A)(lane - 1) + o, INF), over the whole window
//   M       = min(A, I)
// and the pointer word (layout pallas_trace.py:67-73):
//   msrc = M == diag ? 0 : M == D ? 1 : 2; 3 at the origin (an origin
//   rank, j 0, M 0)
//   isrc = I == M(lane - 1 mod Wb) + o ? 0 : 1  (the lane roll wraps)
//   diag column = pmidx(lane - 1 mod Wb); at the end rank msrc = 0 and the
//   column is pmidx(lane), M_final = pm and the stored D is INF.
// The anchor value is min(INF, M_final + e*j) at the read's own (anchor
// rank, anchor j): the end rank at the read's length for a global span, the
// end state the scoring fill found for an ends-free one.
//
// Each read's block walks its ranks r_begin[b] ... r_end[b] (every rank
// where no range is given).  The trace driver gives an anchored read the
// ranks a path of cost <= its score can pass (ops/trace.py trace_ranges):
// from the first rank whose corridor bounds are not empty to the anchor
// rank.  The rings start at INF, so the first rank walked sees no
// predecessor, as if every rank before it held INF.  Pointer rows outside
// the range are left unwritten; the decode reads none of them.
//
// What bounds it on the H100: as in the banded fill, a read's ranks are a
// sequential chain, one block walks them, and a rank is ~Wb lanes x (P
// ring reads with their argmins + ~25 operations): a few thousand
// instructions for the whole window.  What bounds a rank is the passes
// over the window it takes, the barriers between them and the latency
// each exposes, not DRAM bandwidth or arithmetic.  Each rank also writes
// Wb pointer words (4 B) to device memory, 1.6 GB a call at the uniform
// config's 64 reads x 6k ranks x 1024 lanes: about 0.5 ms at 3.35 TB/s.
// The first body took three strided passes over scratch rows in shared
// memory a rank and a Hillis-Steele prefix-min over the whole window:
// 3 + log2(Wb) barriers, 13 at Wb 1024.
//
// What the design does about it (the register body; the gather, scan, DPX
// helpers and placement are reg_body.cuh's, shared with the banded, full
// and seeded fills):
//   * one block per read (no cross-block traffic); thread t owns K
//     contiguous lanes [tK, tK + K) (TRACE_LANES), and the rank's min_pm,
//     D, A, I, M, their argmins and the pointer words stay in its
//     registers: no scratch row;
//   * each ring slot remembers the window start it was written at
//     (sstart), so a window step costs nothing (the TPU rolled every ring
//     row by 128 lanes instead): a gather reads at lane i + w_r - sstart,
//     a multiple of 128 lanes off i, so a thread's K lanes are all inside
//     the stored window or all past it (INF), and move as int4;
//   * the K + 1 lane gather folds min and argmin (`<=` in ascending p, so
//     ties go to the highest column and an invalid column, reading INF,
//     wins an all-INF tie) over the thread's lanes and lane tK - 1; thread
//     0 takes lane Wb - 1 there, since the diagonal column wraps
//     (pmidx(lane - 1 mod Wb)), while its diagonal value stays INF;
//   * M's source needs only A's (M = A where A <= I, else M = I, which
//     is then below diag and D), so the word's source and columns are set
//     before the scan and only I and A cross it;
//   * the insertion is the window scan over the whole window (cap = Wb,
//     prefix_min.cuh), INS_ONLY: I beside M;
//   * isrc needs M one lane left, wrapping: within a warp by
//     __shfl_up_sync, across warps (and lane Wb - 1 for lane 0) through
//     one shared word a warp written before barrier 2 and read after it,
//     when the pointer row goes out: no later rank reads it;
//   * TRACE_REG_BARRIERS = 2 barriers a rank: the scan's, and the one
//     after the ring write.  D (and at the end rank M = min_pm) go to the
//     ring before the first: a rank never gathers from the slot it
//     writes, but rank 0, whose one unconditional column is the slot it
//     writes and reads an all-INF row, loads nothing;
//   * pointer rows go straight to device memory as int4, coalesced across
//     the warp, into (Np, B, Wb) planes that the decode reads;
//   * the rings stay in shared memory where they fit beside the warp
//     carries, the warp words and the slot starts, else in the block's
//     global slab (reg_placement).
// At the uniform config's 64 reads x 6,086 ranks x 1,024 lanes that is
// 11.6 ms against the first body's 26.2, 1.9 us a rank; the anchored
// trace's 64 reads x 50,002 ranks x 256 lanes (2 warps a block) take 59.1
// ms against 81.4, 1.2 us a rank (chip_kernel_times.py, both in one call
// on an H100).  Over each read's rank range that anchored call takes 7.9
// ms (11.5% of its read-ranks walked), and 64 anchored reads over 200,002
// ranks 7.8 ms against 247.1 for every rank (2.9% walked): ~1.4 us a rank
// of the ~5,700 a read walks, so the corridor, not the graph, sets the
// time (one call on an H100 80GB HBM3 at 700 W).
#include <stdint.h>

#include "common.cuh"
#include "reg_body.cuh"

#define TRACE_REG_BARRIERS REG_BARRIERS

// Lanes a thread owns: 4 at every width the wrapper takes (128 ... 4,096
// lanes, 32 ... 1,024 threads; 64 registers, no spill).  More lanes a
// thread would mean fewer warps and a longer chain of dependent steps a
// rank, with less of it hidden.
#define TRACE_LANES 4

// The side words: each warp's last M (32), then the W slot starts.
__host__ __device__ inline int trace_side_ints(int W) {
    return 32 + round_up(W, 4);
}

#define TRACE_PARAMS                                                          \
    const int* __restrict__ symbols,    /* (Np,) */                           \
    const int* __restrict__ pred_slots, /* (Np*P,) ring slot per pred */      \
    const int* __restrict__ pred_valid, /* (Np*P,) 0/1 */                     \
    const int* __restrict__ wslots,     /* (Np,) ring slot each rank writes */\
    const int* __restrict__ qpad,       /* (B, LQ) */                         \
    const int* __restrict__ wstarts,    /* (B, Np) window start per rank */   \
    const int* __restrict__ anchor_r,   /* (B,) */                            \
    const int* __restrict__ anchor_j,   /* (B,) */                            \
    const int* __restrict__ r_begin,    /* (B,) first rank walked, or null */ \
    const int* __restrict__ r_end,      /* (B,) last rank walked, or null */  \
    int B, int LQ, int Np, int n_nodes, int end_rank, int W, int P, int Wb,   \
    int o, int e, int x, int free_start,                                      \
    int* __restrict__ ptr,  /* (Np, B, Wb) pointer planes */                  \
    int* __restrict__ aval, /* (B,) */                                        \
    int *gws, long long global_ints, int mode

// One predecessor row of the gather, min and argmin over the thread's K
// lanes and its left lane: the row of slot `slot`, read `sh` lanes right
// (INF where that passes the stored window), or INF throughout (`load`
// false: an invalid column, or rank 0's).  Ties go to the later p.
template <int K>
__device__ __forceinline__ void trace_gather(
    const int* mring, const int* dring, int slot, int sh, int Wb, int base,
    int left, bool load, int p, int (&pm)[K], int (&pmi)[K], int (&pd)[K],
    int (&pdi)[K], int& pml, int& pmil) {
    int am[K], ad[K];
    int aml = POASTA_INF;
    const long long row = (long long)slot * Wb;
    if (load && base + sh < Wb) {
        ld_lanes<K>(mring + row + base + sh, am);
        ld_lanes<K>(dring + row + base + sh, ad);
    } else {
#pragma unroll
        for (int k = 0; k < K; ++k) am[k] = ad[k] = POASTA_INF;
    }
    if (load && left + sh < Wb) aml = mring[row + left + sh];
    if (p == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            pm[k] = am[k];
            pd[k] = ad[k];
            pmi[k] = pdi[k] = 0;
        }
        pml = aml;
        pmil = 0;
        return;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (am[k] <= pm[k]) pmi[k] = p;
        if (ad[k] <= pd[k]) pdi[k] = p;
        pm[k] = min(pm[k], am[k]);
        pd[k] = min(pd[k], ad[k]);
    }
    if (aml <= pml) pmil = p;
    pml = min(pml, aml);
}

template <int K>
__global__ void __launch_bounds__(4096 / K, 1)
trace_fill_kernel(TRACE_PARAMS) {
    extern __shared__ __align__(16) int smem[];
    int w = 1;  // the scan's window: the whole row
    while (w < Wb) w <<= 1;
    const long long ring_ints = (long long)W * Wb;
    int *carry, *side, *mring, *unused;
    reg_workspace(mode, smem, gws, global_ints, trace_side_ints(W),
                  ring_ints, &carry, &side, &mring, &unused);
    int* dring = mring + ring_ints;
    int* wlast = side;        // (32,) each warp's M at its last lane
    int* sstart = side + 32;  // (W,) the start each slot was written at
    const int b = blockIdx.x;
    const int* q = qpad + (long long)b * LQ;
    const int* ws = wstarts + (long long)b * Np;
    const int ar = anchor_r[b];
    const int aj = anchor_j[b];
    // the read's rank range: every rank without one (the block's threads
    // all take the same bounds, so the barriers inside the loop stay whole)
    const int r0 = r_begin ? max(r_begin[b], 0) : 0;
    const int r1 = r_end ? min(r_end[b], n_nodes - 1) : n_nodes - 1;
    const int base = threadIdx.x * K;  // this thread's lanes [base, base + K)
    const bool active = base < Wb;     // Wb is a multiple of 128
    const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
    // the lane left of this thread's: the diagonal column wraps, so thread
    // 0's is lane Wb - 1
    const int left = base > 0 ? base - 1 : Wb - 1;
    // whether this thread holds its warp's last lane (for thread 0: the
    // warp that holds lane Wb - 1)
    const bool warp_end = active && (wl == 31 || base + K == Wb);
    const int wrap_warp = (Wb / K - 1) >> 5;

    const int4 inf4 = make_int4(POASTA_INF, POASTA_INF, POASTA_INF,
                                POASTA_INF);
    for (long long i = threadIdx.x; i < ring_ints / 2; i += blockDim.x)
        reinterpret_cast<int4*>(mring)[i] = inf4;  // the D ring follows M's
    for (int i = threadIdx.x; i < W; i += blockDim.x) sstart[i] = 0;
    if (threadIdx.x == 0) aval[b] = POASTA_INF;  // one lane matches later
    __syncthreads();

    for (int r = r0; r <= r1; ++r) {
        const int sym = symbols[r];
        const int w_r = ws[r];
        const int* ps = pred_slots + (long long)r * P;
        const int* pv = pred_valid + (long long)r * P;
        const bool is_end = r == end_rank;
        const bool origin = free_start ? !is_end : r == 0;
        const long long woff = (long long)wslots[r] * Wb + base;

        int pm[K], pmi[K], pd[K], pdi[K], s[K], word[K];
        int pml = POASTA_INF, pmil = 0;  // min_pm and its argmin at `left`
        int agg = POASTA_INF;    // min of A over this thread's lanes
        if (active) {
            // p = 0 unconditionally: rank 0 reads an all-INF row, without
            // a load, since its one column is the slot it writes
            for (int p = 0; p < P; ++p) {
                const int slot = ps[p];
                trace_gather<K>(mring, dring, slot, w_r - sstart[slot], Wb,
                                base, left, p == 0 ? r > 0 : pv[p] == 1, p,
                                pm, pmi, pd, pdi, pml, pmil);
            }
            // descending, so lane k - 1's min_pm and argmin are still there
            // for k; the query comes in 4-lane chunks (LQ is a multiple of
            // 4, so a chunk lies wholly inside the row or past it)
#pragma unroll
            for (int c = K / 4 - 1; c >= 0; --c) {
                const int q0 = w_r + base + 4 * c;
                int qv[4] = {0, 0, 0, 0};
                if (q0 < LQ) {
                    const int4 t = *reinterpret_cast<const int4*>(q + q0);
                    qv[0] = t.x;
                    qv[1] = t.y;
                    qv[2] = t.z;
                    qv[3] = t.w;
                }
                int dc[4];
#pragma unroll
                for (int u = 3; u >= 0; --u) {
                    const int k = 4 * c + u;
                    const int src =
                        k ? pm[k - 1] : (base > 0 ? pml : POASTA_INF);
                    const int diag = src + (qv[u] == sym ? -e : x - e);
                    const int d_open = pm[k] + (o + e);
                    const int D = min(d_open, pd[k] + e);
                    const bool open = D == d_open;
                    int a = min(diag, D);
                    if (origin && q0 + u == 0) a = min(a, 0);
                    // M's source if M = A; the end rank hops with 0
                    const int msrc = is_end ? 0 : a == diag ? 0 : a == D ? 1
                                                                      : 2;
                    const int didx =
                        is_end ? pmi[k] : (k ? pmi[k - 1] : pmil);
                    word[k] = msrc | (didx << 2) | ((open ? 0 : 1) << 8)
                              | ((open ? pmi[k] : pdi[k]) << 9);
                    s[k] = a;
                    agg = min(agg, a);
                    dc[u] = is_end ? POASTA_INF : D;
                }
                *reinterpret_cast<int4*>(dring + woff + 4 * c) =
                    make_int4(dc[0], dc[1], dc[2], dc[3]);
            }
            if (is_end) {  // M_final = min_pm
                st_lanes<K>(mring + woff, pm);
                if (r == ar) {
#pragma unroll
                    for (int k = 0; k < K; ++k) {
                        const int j = w_r + base + k;
                        if (j == aj) aval[b] = min(aval[b], pm[k] + e * j);
                    }
                }
            }
        }

        // I over the whole window (reused: pm holds I from here)
        reg_insertion<K, false, true>(s, agg, base, active, w, false, o, e,
                                      carry, side, pm);

        int mlast = POASTA_INF;  // M at this thread's last lane
        int i0 = POASTA_INF;     // I at its first
        if (active) {
            int mprev = POASTA_INF;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const int j = w_r + base + k;
                const int ins = pm[k];
                const int M = min(s[k], ins);
                if (!is_end) {
                    int msrc = s[k] <= ins ? (word[k] & 3) : 2;
                    if (origin && j == 0 && M == 0) msrc = 3;
                    word[k] = (word[k] & ~3) | msrc;
                }
                if (k > 0) word[k] |= (ins == mprev + o ? 0 : 1) << 7;
                mprev = M;
                s[k] = M;
            }
            i0 = pm[0];
            mlast = s[K - 1];
            if (!is_end) {
                st_lanes<K>(mring + woff, s);
                if (r == ar) {
#pragma unroll
                    for (int k = 0; k < K; ++k) {
                        const int j = w_r + base + k;
                        if (j == aj) aval[b] = min(aval[b], s[k] + e * j);
                    }
                }
            }
        }
        // M one lane left of each thread's first lane: the lane before in
        // the warp, or across warps (and round to lane Wb - 1) through the
        // warp words after barrier 2
        int mleft = __shfl_up_sync(POASTA_FULL_MASK, mlast, 1);
        if (warp_end) wlast[warp] = mlast;
        if (threadIdx.x == 0) sstart[wslots[r]] = w_r;
        __syncthreads();  // barrier 2: the rings and the warp words
        if (active) {
            if (wl == 0) mleft = wlast[warp > 0 ? warp - 1 : wrap_warp];
            word[0] |= (i0 == mleft + o ? 0 : 1) << 7;
            st_lanes<K>(ptr + ((long long)r * B + b) * Wb + base, word);
        }
    }
}

static cudaError_t trace_plan(int W, int Wb, PoastaPlan* plan) {
    if (Wb < 128 || Wb > 4096 || Wb % 128 || W <= 0)
        return cudaErrorInvalidValue;
    plan->threads = round_up(Wb / TRACE_LANES, 32);
    return reg_placement(trace_side_ints(W), 2LL * W * Wb, 2, plan);
}

extern "C" int poasta_trace_plan(int W, int Wb, int* threads, int* mode,
                                 int* smem_bytes, long long* global_ints,
                                 int* lanes, int* barriers) {
    PoastaPlan plan;
    cudaError_t err = trace_plan(W, Wb, &plan);
    if (err != cudaSuccess) return (int)err;
    *lanes = TRACE_LANES;
    *threads = plan.threads;
    *mode = plan.mode;
    *smem_bytes = plan.smem_bytes;
    *global_ints = plan.global_ints;
    *barriers = TRACE_REG_BARRIERS;
    return 0;
}

// qpad starts 16-byte aligned and LQ is a multiple of 4 (int4 query
// chunks); ptr starts 16-byte aligned.  r_begin / r_end null: every read
// walks every rank.
extern "C" int poasta_trace_fill(
    const int* symbols, const int* pred_slots, const int* pred_valid,
    const int* wslots, const int* qpad, const int* wstarts,
    const int* anchor_r, const int* anchor_j, const int* r_begin,
    const int* r_end, int B, int LQ, int Np, int n_nodes, int end_rank,
    int W, int P, int Wb, int o, int e, int x, int free_start, int* ptr,
    int* aval, int* gws, long long gws_ints, void* stream) {
    PoastaPlan plan;
    cudaError_t err = trace_plan(W, Wb, &plan);
    if (err != cudaSuccess) return (int)err;
    if (gws_ints < plan.global_ints * (long long)B)
        return (int)cudaErrorInvalidValue;
    if (LQ % 4 || (((uintptr_t)qpad | (uintptr_t)ptr) & 15))
        return (int)cudaErrorInvalidValue;
    return (int)poasta_launch(
        trace_fill_kernel<TRACE_LANES>, B, plan, (cudaStream_t)stream,
        symbols, pred_slots, pred_valid, wslots, qpad, wstarts, anchor_r,
        anchor_j, r_begin, r_end, B, LQ, Np, n_nodes, end_rank, W, P, Wb, o,
        e, x, free_start, ptr, aval, gws, plan.global_ints, plan.mode);
}
