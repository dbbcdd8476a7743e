// Seeded corridor fill: the ends-free fill of a read inside a window
// schedule built around its k-mer hit cluster, returning the read's best
// end state (value, end offset, end rank).
//
// Replaces poasta_tpu/ops/pallas_seed.py:_seed_kernel (launched through
// _seed_exec / pallas_seed_scores).  Same cells, same recurrence, same end
// state under the same tie rule, bit for bit, given the same rank range.
//
// Per read and per rank r of its range [r_begin, r_end), over a window of
// Wb lanes starting at w = wstarts[b, r] (monotone, steps of 0 or 128 per
// rank).  Rows store X'(j) = X(j) - e*j at j = w + lane:
//   pm, pd  = min over predecessors of their stored M', D' rows, each read
//             shifted left by (w - the start it was written at), INF past
//             its edge or where the slot was not written in this range
//   D       = min(pm + o + e, pd + e)
//   diag    = pm(lane - 1) + (q[w + lane] == sym ? -e : x - e), INF at
//             lane 0; q reads 0 past its row
//   A       = min(diag, D), and min(A, 0) at j = 0 of an origin rank: rank 0
//             or, with `free_start`, every rank but the end rank
//   I       = min(prefix_min_cap(A)(lane - 1) + o, INF)
//   M       = min(A, I); at the end rank M = pm and the stored D is INF
//   cand    = min(M + e*j, INF) where (end_ok[r] or r is the end rank) and
//             jlo <= j <= n, else INF
// and the read's end state is the least (cand, j, r) over every cell of the
// range under the order: value ascending, offset descending, rank
// ascending.  That is what the TPU kernel's per-lane buckets (a bucket
// keeps a candidate that is lower, or equal at a larger offset) give once
// they are reduced (min value, then max offset, then min rank); a range
// with no rank returns (INF, -1, 2^30) as the buckets start.
//
// What the TPU kernel did that this one does not: 16 locus-sorted reads
// shared a block and one rank range rounded down to 4096 ranks; step bits
// rode in a rolling 128-word tile; rank records streamed in 1024-rank
// chunks into scalar memory; a window step rolled the query and every ring
// row.  Here a block owns one read, takes that read's own rank range and
// per-rank window starts, reads the rank tables from global memory, and a
// window step is an offset into the ring rows (each slot remembers the
// start it was written at).
//
// What bounds it on the H100: a read's ranks are a sequential chain, as
// in the banded fill, and a rank is ~Wb lanes x (P ring reads + ~20
// operations), so the passes over the window a rank takes, the barriers
// between them and the latency each exposes bound it, not DRAM bandwidth
// or arithmetic; the work is the read's own rank span times Wb lanes, not
// the whole graph.  The first body took three strided passes over scratch
// rows in shared memory a rank and a Hillis-Steele prefix-min: 3 +
// log2(cap) barriers, 13 at the main path's cap of 1,024.
//
// What the design does about it (the register body; the gather, scan, DPX
// helpers and placement are reg_body.cuh's, shared with the banded, full
// and trace fills): thread t owns K contiguous lanes [tK, tK + K)
// (SEED_LANES), and the rank's min_pm, D, A and M stay in its registers;
// the K + 1 lane gather reads each predecessor row at lane i + w_r -
// sstart (a multiple of 128 lanes off i: a thread's lanes are all inside
// the stored window or all past it, and move as int4); the truncated
// prefix-min is the window scan (prefix_min.cuh) over segments of w lanes,
// w the first power of two >= cap, its suffix row in shared memory; each
// thread keeps its running best end state in registers over its lanes and
// ranks (seed_better is a total order on distinct cells, so the order the
// lanes are taken in cannot change the result), reduced across the block
// once after the last rank; SEED_REG_BARRIERS = 2 barriers a rank (1 at
// the end rank, which takes no scan).  D goes to the ring before the
// scan's barrier: a rank never gathers from the slot it writes, and rank
// 0, whose one column is its own slot and reads an all-INF row, loads
// nothing.  The rings stay in shared memory where they
// fit beside the warp carries, the suffix row and the slot starts, else in
// the block's global slab (reg_placement).  On the pangenome mapping
// path's seeded call (64 reads, Wb 2,048, cap 1,024, 428,067 ranks in the
// reads' ranges) that is 12.8 ms against the first body's 35.2, 1.9 us a
// rank (chip_kernel_times.py, both in one call on an H100).
#include <stdint.h>

#include "common.cuh"
#include "reg_body.cuh"

#define SEED_REG_BARRIERS REG_BARRIERS
#define SEED_NO_RANK (1 << 30)

// Lanes a thread owns: 4 at every width the wrapper takes (128 ... 4,096
// lanes, 32 ... 1,024 threads; 50 registers, no spill), as in the trace
// fill.
#define SEED_LANES 4

// The side rows: the scan's suffix row (Wb), then the W slot starts.
__host__ __device__ inline int seed_side_ints(int W, int Wb) {
    return Wb + round_up(W, 4);
}

// whether end state (v1, j1, r1) comes before (v0, j0, r0)
__device__ __forceinline__ bool seed_better(int v1, int j1, int r1, int v0,
                                            int j0, int r0) {
    if (v1 != v0) return v1 < v0;
    if (j1 != j0) return j1 > j0;
    return r1 < r0;
}

#define SEED_PARAMS                                                           \
    const int* __restrict__ symbols,    /* (Np,) */                           \
    const int* __restrict__ pred_slots, /* (Np*P,) ring slot per pred */      \
    const int* __restrict__ pred_valid, /* (Np*P,) 0/1 */                     \
    const int* __restrict__ wslots,     /* (Np,) ring slot each rank writes */\
    const int* __restrict__ end_ok,     /* (Np,) 0/1 */                       \
    const int* __restrict__ qshift,     /* (B, L) */                          \
    const int* __restrict__ wstarts,    /* (B, Np) window start per rank */   \
    const int* __restrict__ lengths,    /* (B,) */                            \
    const int* __restrict__ jlo,        /* (B,) */                            \
    const int* __restrict__ r_begin,    /* (B,) */                            \
    const int* __restrict__ r_end,      /* (B,) */                            \
    int L, int Np, int end_rank, int W, int P, int Wb, int o, int e, int x,   \
    int cap, int free_start,                                                  \
    int* __restrict__ out, /* (B, 3): value, offset, rank */                  \
    int *gws, long long global_ints, int mode

template <int K>
__global__ void __launch_bounds__(4096 / K, 1)
seed_fill_kernel(SEED_PARAMS) {
    extern __shared__ __align__(16) int smem[];
    int w = 1;  // the scan's window: the first power of two >= cap
    while (w < cap) w <<= 1;
    const bool windowed = w < Wb;  // else the window is the whole prefix
    const long long ring_ints = (long long)W * Wb;
    int *carry, *suf, *mring, *unused;
    reg_workspace(mode, smem, gws, global_ints, seed_side_ints(W, Wb),
                  ring_ints, &carry, &suf, &mring, &unused);
    int* dring = mring + ring_ints;
    int* sstart = suf + Wb;  // (W,) the start each slot was written at
    const int b = blockIdx.x;
    const int* q = qshift + (long long)b * L;
    const int* ws = wstarts + (long long)b * Np;
    const int n_b = lengths[b];
    const int jlo_b = jlo[b];
    const int r0 = r_begin[b];
    const int r1 = r_end[b];
    const int base = threadIdx.x * K;  // this thread's lanes [base, base + K)
    const bool active = base < Wb;     // Wb is a multiple of 128

    const int4 inf4 = make_int4(POASTA_INF, POASTA_INF, POASTA_INF,
                                POASTA_INF);
    for (long long i = threadIdx.x; i < ring_ints / 2; i += blockDim.x)
        reinterpret_cast<int4*>(mring)[i] = inf4;  // the D ring follows M's
    for (int i = threadIdx.x; i < W; i += blockDim.x) sstart[i] = 0;
    __syncthreads();

    int bv = POASTA_INF, bj = -1, br = SEED_NO_RANK;  // this thread's best
    for (int r = r0; r < r1; ++r) {
        const int sym = symbols[r];
        const int w_r = ws[r];
        const int* ps = pred_slots + (long long)r * P;
        const int* pv = pred_valid + (long long)r * P;
        const bool is_end = r == end_rank;
        const bool origin = free_start ? !is_end : r == 0;
        const long long woff = (long long)wslots[r] * Wb + base;

        // gather K + 1 lanes of each predecessor row: p = 0
        // unconditionally, but rank 0 reads an all-INF row without a load
        // (its one column is the slot it writes); a row read past its
        // stored window leaves the mins as they are
        int pm[K], pd[K], s[K];
        int pm_left = POASTA_INF;  // min_pm at lane base - 1
        int agg = POASTA_INF;      // min of A over this thread's lanes
        if (active) {
            for (int p = 0; p < P; ++p) {
                if (p > 0 && pv[p] != 1) continue;
                const int slot = ps[p];
                const int sh = w_r - sstart[slot];
                const long long row = (long long)slot * Wb;
                const bool inside = (p > 0 || r > 0) && base + sh < Wb;
                if (inside) {
                    gather_lanes<K, false>(mring, dring, nullptr,
                                           row + base + sh, p == 0, pm, pd,
                                           pd);
                } else if (p == 0) {
#pragma unroll
                    for (int k = 0; k < K; ++k) pm[k] = pd[k] = POASTA_INF;
                }
                if (base > 0 && (p > 0 || r > 0) && base - 1 + sh < Wb)
                    pm_left = min(pm_left, mring[row + base - 1 + sh]);
            }
            if (is_end) {
                // M = min_pm, the stored D INF
#pragma unroll
                for (int c = 0; c < K / 4; ++c)
                    *reinterpret_cast<int4*>(dring + woff + 4 * c) = inf4;
            } else {
                // descending, so lane k - 1's min_pm is still there for k;
                // the query comes in 4-lane chunks (L is a multiple of 4)
#pragma unroll
                for (int c = K / 4 - 1; c >= 0; --c) {
                    const int q0 = w_r + base + 4 * c;
                    int qv[4] = {0, 0, 0, 0};
                    if (q0 < L) {
                        const int4 t =
                            *reinterpret_cast<const int4*>(q + q0);
                        qv[0] = t.x;
                        qv[1] = t.y;
                        qv[2] = t.z;
                        qv[3] = t.w;
                    }
                    int dc[4];
#pragma unroll
                    for (int u = 3; u >= 0; --u) {
                        const int k = 4 * c + u;
                        const int src = k ? pm[k - 1] : pm_left;
                        const int dv = add_min(pm[k], o + e, pd[k] + e);
                        int a = min(src + (qv[u] == sym ? -e : x - e), dv);
                        if (origin && q0 + u == 0) a = min(a, 0);
                        dc[u] = dv;
                        s[k] = a;
                        agg = min(agg, a);
                    }
                    *reinterpret_cast<int4*>(dring + woff + 4 * c) =
                        make_int4(dc[0], dc[1], dc[2], dc[3]);
                }
            }
        }

        if (!is_end)  // uniform across the block; pm holds M from here
            reg_insertion<K, false>(s, agg, base, active, w, windowed, o, e,
                                    carry, suf, pm);

        if (active) {
            st_lanes<K>(mring + woff, pm);
            const bool may_end = is_end || end_ok[r] == 1;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const int j = w_r + base + k;
                const bool elig = may_end && j >= jlo_b && j <= n_b;
                const int cand =
                    elig ? min(pm[k] + e * j, POASTA_INF) : POASTA_INF;
                if (seed_better(cand, j, r, bv, bj, br)) {
                    bv = cand;
                    bj = j;
                    br = r;
                }
            }
        }
        if (threadIdx.x == 0) sstart[wslots[r]] = w_r;
        __syncthreads();  // barrier 2: the rings are written
    }

    // block reduction of the threads' bests: within each warp by shuffles,
    // then across the warps' results (parked in the suffix row, free after
    // the last rank's barrier) by the first warp
    int* red_v = suf;
    int* red_j = suf + 32;
    int* red_r = suf + 64;
    for (int off = 16; off > 0; off >>= 1) {
        const int v = __shfl_down_sync(0xffffffffu, bv, off);
        const int j = __shfl_down_sync(0xffffffffu, bj, off);
        const int r = __shfl_down_sync(0xffffffffu, br, off);
        if (seed_better(v, j, r, bv, bj, br)) {
            bv = v;
            bj = j;
            br = r;
        }
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        red_v[warp] = bv;
        red_j[warp] = bj;
        red_r[warp] = br;
    }
    __syncthreads();
    if (warp == 0) {
        const int n_warps = (blockDim.x + 31) >> 5;
        bv = lane < n_warps ? red_v[lane] : POASTA_INF;
        bj = lane < n_warps ? red_j[lane] : -1;
        br = lane < n_warps ? red_r[lane] : SEED_NO_RANK;
        for (int off = 16; off > 0; off >>= 1) {
            const int v = __shfl_down_sync(0xffffffffu, bv, off);
            const int j = __shfl_down_sync(0xffffffffu, bj, off);
            const int r = __shfl_down_sync(0xffffffffu, br, off);
            if (seed_better(v, j, r, bv, bj, br)) {
                bv = v;
                bj = j;
                br = r;
            }
        }
        if (lane == 0) {
            out[3 * b] = bv;
            out[3 * b + 1] = bj;
            out[3 * b + 2] = br;
        }
    }
}

static cudaError_t seed_plan(int W, int Wb, PoastaPlan* plan) {
    if (Wb < 128 || Wb > 4096 || Wb % 128 || W <= 0)
        return cudaErrorInvalidValue;
    plan->threads = round_up(Wb / SEED_LANES, 32);
    return reg_placement(seed_side_ints(W, Wb), 2LL * W * Wb, 2, plan);
}

extern "C" int poasta_seed_plan(int W, int Wb, int* threads, int* mode,
                                int* smem_bytes, long long* global_ints,
                                int* lanes, int* barriers) {
    PoastaPlan plan;
    cudaError_t err = seed_plan(W, Wb, &plan);
    if (err != cudaSuccess) return (int)err;
    *lanes = SEED_LANES;
    *threads = plan.threads;
    *mode = plan.mode;
    *smem_bytes = plan.smem_bytes;
    *global_ints = plan.global_ints;
    *barriers = SEED_REG_BARRIERS;
    return 0;
}

// qshift starts 16-byte aligned and L is a multiple of 4 (int4 query
// chunks).
extern "C" int poasta_seed_fill(
    const int* symbols, const int* pred_slots, const int* pred_valid,
    const int* wslots, const int* end_ok, const int* qshift,
    const int* wstarts, const int* lengths, const int* jlo,
    const int* r_begin, const int* r_end, int B, int L, int Np, int end_rank,
    int W, int P, int Wb, int o, int e, int x, int cap, int free_start,
    int* out, int* gws, long long gws_ints, void* stream) {
    PoastaPlan plan;
    cudaError_t err = seed_plan(W, Wb, &plan);
    if (err != cudaSuccess) return (int)err;
    if (gws_ints < plan.global_ints * (long long)B)
        return (int)cudaErrorInvalidValue;
    if (L % 4 || ((uintptr_t)qshift & 15)) return (int)cudaErrorInvalidValue;
    return (int)poasta_launch(
        seed_fill_kernel<SEED_LANES>, B, plan, (cudaStream_t)stream, symbols,
        pred_slots, pred_valid, wslots, end_ok, qshift, wstarts, lengths, jlo,
        r_begin, r_end, L, Np, end_rank, W, P, Wb, o, e, x, cap, free_start,
        out, gws, plan.global_ints, plan.mode);
}
