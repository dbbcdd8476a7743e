// Full-width global one-piece gap-affine fill of a read batch against a
// POA graph (every offset of every rank).
//
// Replaces: poasta_tpu/ops/pallas_fill.py:_fill_kernel with free_start =
// free_end = False (launched through _pallas_exec / pallas_fill_scores).
// Same inputs, same end row, bit for bit.
//
// Recurrence, per read and per topological rank r, over the offsets
// j = 0 .. L-1 (untilted):
//   min_pm, min_pd = min over predecessors of their M, D rows
//   D    = min(min_pm + o + e, min_pd + e)
//   diag = min_pm(j - 1) + (match ? 0 : x), INF at j = 0
//   A    = min(diag, D), and min(A, 0) at (rank 0, j = 0)
//   I    = min(prefix_min(A - e*j)(j - 1) + o + e*j, INF)
//   M    = min(A, I)
// At the end rank M = min_pm, the stored D is INF, and min_pm is written
// out as the read's end row; the caller reads it at each read's length.
//
// What bounds it on the H100: as for the banded kernel, the rank loop is
// sequential per read and synchronises 3 + log2(L) times per rank; here
// every rank spans the whole row (L = 5120 lanes at the bench's 5 kb
// reads), so it does L / Wb times the banded kernel's work per rank.
//
// What the design does about it: one block per read; the five scratch
// rows stay in shared memory (100 KB at L = 5120) while the rings, 2*W*L
// int32 (205 KB per read at W = 5), move to a per-block global-memory slab
// when rows and rings together pass the 227 KB opt-in limit.  This kernel
// is the ladder's last resort; the banded kernel carries the main path.
#include "common.cuh"
#include "prefix_min.cuh"

__global__ void full_fill_kernel(
    const int* __restrict__ symbols,     // (Np,)
    const int* __restrict__ pred_slots,  // (Np*P,)
    const int* __restrict__ pred_valid,  // (Np*P,) 0/1
    const int* __restrict__ wslots,      // (Np,)
    const int* __restrict__ qshift,      // (B, L)
    int L, int n_nodes, int end_rank, int W, int P, int o, int e, int x,
    int* __restrict__ end_row,           // (B, L)
    int* gws, long long global_ints, int mode) {
    extern __shared__ int smem[];
    int* rows;
    int* mring;
    poasta_workspace(mode, smem, gws, global_ints, (long long)POASTA_ROWS * L,
                     &rows, &mring);
    const long long ring_ints = (long long)W * L;
    int* dring = mring + ring_ints;
    int* pm_row = rows;
    int* d_row = rows + L;
    int* a_row = rows + 2 * L;
    int* s0 = rows + 3 * L;
    int* s1 = rows + 4 * L;
    const int* q = qshift + (long long)blockIdx.x * L;
    int* out = end_row + (long long)blockIdx.x * L;

    for (long long i = threadIdx.x; i < 2 * ring_ints; i += blockDim.x)
        mring[i] = POASTA_INF;  // the D ring follows the M ring
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

        for (int j = threadIdx.x; j < L; j += blockDim.x) {
            const int src = j >= 1 ? pm_row[j - 1] : POASTA_INF;
            const int mc = q[j] == sym ? 0 : x;
            int a = min(src + mc, d_row[j]);
            if (r == 0 && j == 0) a = min(a, 0);
            a_row[j] = a;
            s0[j] = a - e * j;
        }
        __syncthreads();
        const int* pref = block_prefix_min(s0, s1, L, L);

        const bool is_end = r == end_rank;
        const long long wbase = (long long)wslots[r] * L;
        for (int j = threadIdx.x; j < L; j += blockDim.x) {
            int m, d;
            if (is_end) {
                m = pm_row[j];
                d = POASTA_INF;
                out[j] = m;
            } else {
                const int pm1 = j >= 1 ? pref[j - 1] : POASTA_INF;
                m = min(a_row[j], min(pm1 + o + e * j, POASTA_INF));
                d = min(d_row[j], POASTA_INF);
            }
            mring[wbase + j] = m;
            dring[wbase + j] = d;
        }
        __syncthreads();
    }
}

extern "C" int poasta_fill_plan(int W, int L, int* threads, int* mode,
                                int* smem_bytes, long long* global_ints) {
    PoastaPlan plan;
    cudaError_t err = poasta_plan(L, (long long)POASTA_ROWS * L, 2LL * W * L,
                                    &plan);
    if (err != cudaSuccess) return (int)err;
    *threads = plan.threads;
    *mode = plan.mode;
    *smem_bytes = plan.smem_bytes;
    *global_ints = plan.global_ints;
    return 0;
}

extern "C" int poasta_full_fill(const int* symbols, const int* pred_slots,
                                const int* pred_valid, const int* wslots,
                                const int* qshift, int B, int L, int n_nodes,
                                int end_rank, int W, int P, int o, int e, int x,
                                int* end_row, int* gws, long long gws_ints,
                                void* stream) {
    PoastaPlan plan;
    cudaError_t err = poasta_plan(L, (long long)POASTA_ROWS * L, 2LL * W * L,
                                    &plan);
    if (err != cudaSuccess) return (int)err;
    if (gws_ints < plan.global_ints * (long long)B)
        return (int)cudaErrorInvalidValue;
    return (int)poasta_launch(full_fill_kernel, B, plan, (cudaStream_t)stream,
                              symbols, pred_slots, pred_valid, wslots, qshift,
                              L, n_nodes, end_rank, W, P, o, e, x, end_row,
                              gws, plan.global_ints, plan.mode);
}
