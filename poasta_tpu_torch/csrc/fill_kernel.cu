// Full-width one-piece gap-affine fill of a read batch against a POA graph
// (every offset of every rank): one kernel template for the global span
// (B2) and for ends-free spans (B4: a free graph begin where the span has
// one, a capped insertion scan, and a running min of the Match row over the
// ranks that may end the alignment).
//
// Replaces, in poasta_tpu/ops/pallas_fill.py:
//   BOUNDED == false  _fill_kernel with free_start = free_end = False
//                     (_pallas_exec / pallas_fill_scores)
//   BOUNDED == true   _fill_kernel_bounded
//                     (_pallas_exec_bounded / pallas_fill_scores_bounded)
// Same inputs, same end row or best row, bit for bit.
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
//   best = min(best, M) at every rank r with end_ok[r] == 1 (bounded)
// At the end rank M = min_pm and the stored D is INF.  The global fill
// writes min_pm out there as the read's end row, which the caller reads at
// each read's length; the bounded fill writes `best` out after the last
// rank, and the caller takes the min over each read's [jlo, n].
//
// What bounds it on the H100: as for the banded kernel, the rank loop is
// sequential per read and synchronises 3 + log2(cap) times per rank; here
// every rank spans the whole row (L = 5120 lanes at the bench's 5 kb
// reads), so it does L / Wb times the banded kernel's work per rank.  The
// cap removes scan rounds, which is all the capped ladder buys.
//
// What the design does about it: one block per read; the five scratch
// rows (and best, the sixth) stay in shared memory (100 KB at L = 5120)
// while the rings, 2*W*L int32 (205 KB per read at W = 5), move to a
// per-block global-memory slab when rows and rings together pass the
// 227 KB opt-in limit, by common.cuh's rule.  These fills are the ladders'
// last resort; the banded kernel carries the main path.
#include "common.cuh"
#include "prefix_min.cuh"

static inline long long fill_row_ints(int bounded, int L) {
    return (long long)(POASTA_ROWS + (bounded ? 1 : 0)) * L;
}

template <bool BOUNDED>
__global__ void full_fill_kernel(
    const int* __restrict__ symbols,     // (Np,)
    const int* __restrict__ pred_slots,  // (Np*P,)
    const int* __restrict__ pred_valid,  // (Np*P,) 0/1
    const int* __restrict__ wslots,      // (Np,)
    const int* __restrict__ end_ok,      // (Np,) 0/1 (bounded)
    const int* __restrict__ qshift,      // (B, L)
    int L, int n_nodes, int end_rank, int W, int P, int o, int e, int x,
    int cap, int free_start,
    int* __restrict__ out_rows,          // (B, L): end rows, or best rows
    int* gws, long long global_ints, int mode) {
    extern __shared__ int smem[];
    int* rows;
    int* mring;
    poasta_workspace(mode, smem, gws, global_ints,
                     (long long)(POASTA_ROWS + (BOUNDED ? 1 : 0)) * L, &rows,
                     &mring);
    const long long ring_ints = (long long)W * L;
    int* dring = mring + ring_ints;
    int* pm_row = rows;
    int* d_row = rows + L;
    int* a_row = rows + 2 * L;
    int* s0 = rows + 3 * L;
    int* s1 = rows + 4 * L;
    int* best = rows + 5 * L;
    const int* q = qshift + (long long)blockIdx.x * L;
    int* out = out_rows + (long long)blockIdx.x * L;

    for (long long i = threadIdx.x; i < 2 * ring_ints; i += blockDim.x)
        mring[i] = POASTA_INF;  // the D ring follows the M ring
    if (BOUNDED)
        for (int j = threadIdx.x; j < L; j += blockDim.x)
            best[j] = POASTA_INF;
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
            for (int p = 1; p < P; ++p) {
                if (pv[p] == 1) {
                    const long long off = (long long)ps[p] * L + j;
                    pm = min(pm, mring[off]);
                    pd = min(pd, dring[off]);
                }
            }
            pm_row[j] = pm;
            d_row[j] = min(pm + (o + e), pd + e);
        }
        __syncthreads();

        const bool is_end = r == end_rank;
        const bool seeds = BOUNDED && free_start ? !is_end : r == 0;
        for (int j = threadIdx.x; j < L; j += blockDim.x) {
            const int src = j >= 1 ? pm_row[j - 1] : POASTA_INF;
            const int mc = q[j] == sym ? 0 : x;
            int a = min(src + mc, d_row[j]);
            if (seeds && j == 0) a = min(a, 0);
            a_row[j] = a;
            s0[j] = a - e * j;
        }
        __syncthreads();
        const int* pref = block_prefix_min(s0, s1, L, BOUNDED ? cap : L);

        const bool permitted = BOUNDED && end_ok[r] == 1;
        const long long wbase = (long long)wslots[r] * L;
        for (int j = threadIdx.x; j < L; j += blockDim.x) {
            int m, d;
            if (is_end) {
                m = pm_row[j];
                d = POASTA_INF;
                if (!BOUNDED) out[j] = m;
            } else {
                const int pm1 = j >= 1 ? pref[j - 1] : POASTA_INF;
                m = min(a_row[j], min(pm1 + o + e * j, POASTA_INF));
                d = min(d_row[j], POASTA_INF);
            }
            mring[wbase + j] = m;
            dring[wbase + j] = d;
            if (permitted) best[j] = min(best[j], m);
        }
        __syncthreads();
    }
    if (BOUNDED)
        for (int j = threadIdx.x; j < L; j += blockDim.x) out[j] = best[j];
}

extern "C" int poasta_fill_plan(int bounded, int W, int L, int* threads,
                                int* mode, int* smem_bytes,
                                long long* global_ints) {
    PoastaPlan plan;
    cudaError_t err = poasta_plan(L, fill_row_ints(bounded, L), 2LL * W * L,
                                  &plan);
    if (err != cudaSuccess) return (int)err;
    *threads = plan.threads;
    *mode = plan.mode;
    *smem_bytes = plan.smem_bytes;
    *global_ints = plan.global_ints;
    return 0;
}

// `bounded` = 0: the global fill (end_ok may be null; cap and free_start
// are not read); 1: the ends-free fill.
extern "C" int poasta_full_fill(
    int bounded, const int* symbols, const int* pred_slots,
    const int* pred_valid, const int* wslots, const int* end_ok,
    const int* qshift, int B, int L, int n_nodes, int end_rank, int W, int P,
    int o, int e, int x, int cap, int free_start, int* out_rows, int* gws,
    long long gws_ints, void* stream) {
    PoastaPlan plan;
    cudaError_t err = poasta_plan(L, fill_row_ints(bounded, L), 2LL * W * L,
                                  &plan);
    if (err != cudaSuccess) return (int)err;
    if (gws_ints < plan.global_ints * (long long)B)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (bounded)
        return (int)poasta_launch(full_fill_kernel<true>, B, plan, st, symbols,
                                  pred_slots, pred_valid, wslots, end_ok,
                                  qshift, L, n_nodes, end_rank, W, P, o, e, x,
                                  cap, free_start, out_rows, gws,
                                  plan.global_ints, plan.mode);
    return (int)poasta_launch(full_fill_kernel<false>, B, plan, st, symbols,
                              pred_slots, pred_valid, wslots, end_ok, qshift,
                              L, n_nodes, end_rank, W, P, o, e, x, cap,
                              free_start, out_rows, gws, plan.global_ints,
                              plan.mode);
}
