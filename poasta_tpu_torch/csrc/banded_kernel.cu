// Banded global one-piece gap-affine fill of a read batch against a POA
// graph, in tilted coordinates.
//
// Replaces: poasta_tpu/ops/pallas_fill.py:_banded_kernel (launched through
// _banded_exec / pallas_banded_scores).  Same inputs, same end row, bit for
// bit.
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
// global-memory slab when they do not fit (wide tiers, large W).
#include "common.cuh"
#include "prefix_min.cuh"

__global__ void banded_fill_kernel(
    const int* __restrict__ symbols,       // (Np,)
    const int* __restrict__ pred_slots,    // (Np*P,) ring slot per predecessor
    const int* __restrict__ pred_valid,    // (Np*P,) 0/1
    const int* __restrict__ pred_wstarts,  // (Np*P,) predecessor window starts
    const int* __restrict__ wstarts,       // (Np,) window start per rank
    const int* __restrict__ wslots,        // (Np,) ring slot each rank writes
    const int* __restrict__ qshift,        // (B, Lq)
    int Lq, int n_nodes, int end_rank, int W, int P, int Wb, int margin,
    int o, int e, int x, int cap,
    int* __restrict__ end_row,             // (B, Wb)
    int* gws, long long global_ints, int mode) {
    extern __shared__ int smem[];
    int* rows;
    int* mring;
    poasta_workspace(mode, smem, gws, global_ints, (long long)POASTA_ROWS * Wb,
                     &rows, &mring);
    const int TOT = Wb + 2 * margin;
    const long long ring_ints = (long long)W * TOT;
    int* dring = mring + ring_ints;
    int* pm_row = rows;
    int* d_row = rows + Wb;
    int* a_row = rows + 2 * Wb;
    int* s0 = rows + 3 * Wb;
    int* s1 = rows + 4 * Wb;
    const int* q = qshift + (long long)blockIdx.x * Lq;
    int* out = end_row + (long long)blockIdx.x * Wb;

    for (long long i = threadIdx.x; i < 2 * ring_ints; i += blockDim.x)
        mring[i] = POASTA_INF;  // the D ring follows the M ring
    __syncthreads();

    for (int r = 0; r < n_nodes; ++r) {
        const int sym = symbols[r];
        const int w_r = wstarts[r];
        const int* ps = pred_slots + (long long)r * P;
        const int* pv = pred_valid + (long long)r * P;
        const int* pw = pred_wstarts + (long long)r * P;

        // gather: p = 0 is unconditional (rank 0 reads an all-INF row)
        const int d0 = min(max(w_r - pw[0], -margin), margin);
        const long long base0 = (long long)ps[0] * TOT + margin + d0;
        for (int i = threadIdx.x; i < Wb; i += blockDim.x) {
            int pm = mring[base0 + i];
            int pd = dring[base0 + i];
            for (int p = 1; p < P; ++p) {
                if (pv[p] == 1) {
                    const int dp = min(max(w_r - pw[p], -margin), margin);
                    const long long off = (long long)ps[p] * TOT + margin + dp + i;
                    pm = min(pm, mring[off]);
                    pd = min(pd, dring[off]);
                }
            }
            pm_row[i] = pm;
            d_row[i] = min(pm + (o + e), pd + e);
        }
        __syncthreads();

        for (int i = threadIdx.x; i < Wb; i += blockDim.x) {
            const int src = i >= 1 ? pm_row[i - 1] : POASTA_INF;
            const int mc = q[w_r + i] == sym ? -e : x - e;
            int a = min(src + mc, d_row[i]);
            if (r == 0 && w_r + i == 0) a = min(a, 0);
            a_row[i] = a;
            s0[i] = a;
        }
        __syncthreads();
        const int* pref = block_prefix_min(s0, s1, Wb, cap);

        const bool is_end = r == end_rank;
        const long long wbase = (long long)wslots[r] * TOT + margin;
        for (int i = threadIdx.x; i < Wb; i += blockDim.x) {
            int m, d;
            if (is_end) {
                m = pm_row[i];
                d = POASTA_INF;
                out[i] = m;
            } else {
                const int pm1 = i >= 1 ? pref[i - 1] : POASTA_INF;
                m = min(a_row[i], min(pm1 + o, POASTA_INF));
                d = min(d_row[i], POASTA_INF);
            }
            mring[wbase + i] = m;
            dring[wbase + i] = d;
        }
        __syncthreads();
    }
}

static long long banded_ring_ints(int W, int Wb, int margin) {
    return 2LL * W * (Wb + 2 * margin);
}

extern "C" int poasta_banded_plan(int W, int Wb, int margin, int* threads,
                                  int* mode, int* smem_bytes,
                                  long long* global_ints) {
    PoastaPlan plan;
    cudaError_t err = poasta_plan(Wb, (long long)POASTA_ROWS * Wb,
                                    banded_ring_ints(W, Wb, margin), &plan);
    if (err != cudaSuccess) return (int)err;
    *threads = plan.threads;
    *mode = plan.mode;
    *smem_bytes = plan.smem_bytes;
    *global_ints = plan.global_ints;
    return 0;
}

extern "C" int poasta_banded_fill(
    const int* symbols, const int* pred_slots, const int* pred_valid,
    const int* pred_wstarts, const int* wstarts, const int* wslots,
    const int* qshift, int B, int Lq, int n_nodes, int end_rank, int W, int P,
    int Wb, int margin, int o, int e, int x, int cap, int* end_row, int* gws,
    long long gws_ints, void* stream) {
    PoastaPlan plan;
    cudaError_t err = poasta_plan(Wb, (long long)POASTA_ROWS * Wb,
                                    banded_ring_ints(W, Wb, margin), &plan);
    if (err != cudaSuccess) return (int)err;
    if (gws_ints < plan.global_ints * (long long)B)
        return (int)cudaErrorInvalidValue;
    return (int)poasta_launch(banded_fill_kernel, B, plan,
                              (cudaStream_t)stream, symbols, pred_slots,
                              pred_valid, pred_wstarts, wstarts, wslots, qshift,
                              Lq, n_nodes, end_rank, W, P, Wb, margin, o, e, x,
                              cap, end_row, gws, plan.global_ints, plan.mode);
}

extern "C" const char* poasta_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
