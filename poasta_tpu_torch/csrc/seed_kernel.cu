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
// What bounds it on the H100: a read's ranks are a sequential chain with
// 3 + log2(cap) barriers per rank, as in the banded fill; the work is the
// read's own rank span times Wb lanes, not the whole graph.
#include "common.cuh"
#include "prefix_min.cuh"

// scratch rows: pm, D, A, two scan buffers; then W slot starts
__host__ __device__ static inline long long seed_row_ints(int W, int Wb) {
    return (long long)POASTA_ROWS * Wb + W;
}

#define SEED_NO_RANK (1 << 30)

// whether end state (v1, j1, r1) comes before (v0, j0, r0)
__device__ __forceinline__ bool seed_better(int v1, int j1, int r1, int v0,
                                            int j0, int r0) {
    if (v1 != v0) return v1 < v0;
    if (j1 != j0) return j1 > j0;
    return r1 < r0;
}

__global__ void seed_fill_kernel(
    const int* __restrict__ symbols,     // (Np,)
    const int* __restrict__ pred_slots,  // (Np*P,) ring slot per predecessor
    const int* __restrict__ pred_valid,  // (Np*P,) 0/1
    const int* __restrict__ wslots,      // (Np,) ring slot each rank writes
    const int* __restrict__ end_ok,      // (Np,) 0/1
    const int* __restrict__ qshift,      // (B, L)
    const int* __restrict__ wstarts,     // (B, Np) window start per rank
    const int* __restrict__ lengths,     // (B,)
    const int* __restrict__ jlo,         // (B,)
    const int* __restrict__ r_begin,     // (B,)
    const int* __restrict__ r_end,       // (B,)
    int L, int Np, int end_rank, int W, int P, int Wb, int o, int e, int x,
    int cap, int free_start,
    int* __restrict__ out,               // (B, 3): value, offset, rank
    int* gws, long long global_ints, int mode) {
    extern __shared__ int smem[];
    int* rows;
    int* mring;
    poasta_workspace(mode, smem, gws, global_ints, seed_row_ints(W, Wb),
                     &rows, &mring);
    const long long ring_ints = (long long)W * Wb;
    int* dring = mring + ring_ints;
    int* pm_row = rows;
    int* d_row = rows + Wb;
    int* a_row = rows + 2 * Wb;
    int* s0 = rows + 3 * Wb;
    int* s1 = rows + 4 * Wb;
    int* sstart = rows + POASTA_ROWS * Wb;  // (W,) start each slot was written at
    const int b = blockIdx.x;
    const int* q = qshift + (long long)b * L;
    const int* ws = wstarts + (long long)b * Np;
    const int n_b = lengths[b];
    const int jlo_b = jlo[b];
    const int r0 = r_begin[b];
    const int r1 = r_end[b];

    for (long long i = threadIdx.x; i < 2 * ring_ints; i += blockDim.x)
        mring[i] = POASTA_INF;  // the D ring follows the M ring
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

        // gather: p = 0 is unconditional (rank 0 reads an all-INF row)
        for (int i = threadIdx.x; i < Wb; i += blockDim.x) {
            int s = ps[0];
            int k = i + w_r - sstart[s];
            int pm = k < Wb ? mring[(long long)s * Wb + k] : POASTA_INF;
            int pd = k < Wb ? dring[(long long)s * Wb + k] : POASTA_INF;
            for (int p = 1; p < P; ++p) {
                if (pv[p] == 1) {
                    s = ps[p];
                    k = i + w_r - sstart[s];
                    if (k < Wb) {
                        pm = min(pm, mring[(long long)s * Wb + k]);
                        pd = min(pd, dring[(long long)s * Wb + k]);
                    }
                }
            }
            pm_row[i] = pm;
            d_row[i] = min(pm + (o + e), pd + e);
        }
        __syncthreads();

        for (int i = threadIdx.x; i < Wb; i += blockDim.x) {
            const int jq = w_r + i;
            const int qc = jq < L ? q[jq] : 0;
            const int src = i >= 1 ? pm_row[i - 1] : POASTA_INF;
            int a = min(src + (qc == sym ? -e : x - e), d_row[i]);
            if (origin && jq == 0) a = min(a, 0);
            a_row[i] = a;
            s0[i] = a;
        }
        __syncthreads();
        const int* pref = block_prefix_min(s0, s1, Wb, cap);

        const bool may_end = is_end || end_ok[r] == 1;
        const long long wbase = (long long)wslots[r] * Wb;
        for (int i = threadIdx.x; i < Wb; i += blockDim.x) {
            const int jq = w_r + i;
            int m, d;
            if (is_end) {
                m = pm_row[i];
                d = POASTA_INF;
            } else {
                const int I = min((i >= 1 ? pref[i - 1] : POASTA_INF) + o,
                                  POASTA_INF);
                m = min(a_row[i], I);
                d = d_row[i];
            }
            mring[wbase + i] = m;
            dring[wbase + i] = d;
            const bool elig = may_end && jq >= jlo_b && jq <= n_b;
            const int cand = elig ? min(m + e * jq, POASTA_INF) : POASTA_INF;
            if (seed_better(cand, jq, r, bv, bj, br)) {
                bv = cand;
                bj = jq;
                br = r;
            }
        }
        if (threadIdx.x == 0) sstart[wslots[r]] = w_r;
        __syncthreads();
    }

    // block reduction of the threads' bests: within each warp by shuffles,
    // then across the warps' results (parked in a scan buffer, free after
    // the last rank's barrier) by the first warp
    int* red_v = s0;
    int* red_j = s0 + 32;
    int* red_r = s0 + 64;
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

extern "C" int poasta_seed_plan(int W, int Wb, int* threads, int* mode,
                                int* smem_bytes, long long* global_ints) {
    PoastaPlan plan;
    cudaError_t err = poasta_plan(Wb, seed_row_ints(W, Wb), 2LL * W * Wb,
                                  &plan);
    if (err != cudaSuccess) return (int)err;
    *threads = plan.threads;
    *mode = plan.mode;
    *smem_bytes = plan.smem_bytes;
    *global_ints = plan.global_ints;
    return 0;
}

extern "C" int poasta_seed_fill(
    const int* symbols, const int* pred_slots, const int* pred_valid,
    const int* wslots, const int* end_ok, const int* qshift,
    const int* wstarts, const int* lengths, const int* jlo,
    const int* r_begin, const int* r_end, int B, int L, int Np, int end_rank,
    int W, int P, int Wb, int o, int e, int x, int cap, int free_start,
    int* out, int* gws, long long gws_ints, void* stream) {
    PoastaPlan plan;
    cudaError_t err = poasta_plan(Wb, seed_row_ints(W, Wb), 2LL * W * Wb,
                                  &plan);
    if (err != cudaSuccess) return (int)err;
    if (gws_ints < plan.global_ints * (long long)B)
        return (int)cudaErrorInvalidValue;
    return (int)poasta_launch(seed_fill_kernel, B, plan, (cudaStream_t)stream,
                              symbols, pred_slots, pred_valid, wslots, end_ok,
                              qshift, wstarts, lengths, jlo, r_begin, r_end, L,
                              Np, end_rank, W, P, Wb, o, e, x, cap, free_start,
                              out, gws, plan.global_ints, plan.mode);
}
