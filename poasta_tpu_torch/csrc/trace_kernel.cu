// Device traceback: the pointer-emitting corridor refill and the decode.
//
// trace_fill_kernel replaces poasta_tpu/ops/pallas_trace.py:_trace_kernel
// (launched through _trace_exec / pallas_trace_align) and folds in its
// HBM-streamed twin _trace_kernel_big: per-rank tables are read from global
// memory at any graph size.  trace_decode_kernel replaces the XLA
// fori_loop of _decode_exec.  Same inputs, same pointer planes, anchor
// values and step words, bit for bit.
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
//   A       = min(diag, D), and min(A, 0) at (rank 0, j = 0)
//   I       = min(prefix_min(A)(lane - 1) + o, INF), over the whole window
//   M       = min(A, I)
// and the pointer word (layout pallas_trace.py:67-73):
//   msrc = M == diag ? 0 : M == D ? 1 : 2; 3 at the origin (r 0, j 0, M 0)
//   isrc = I == M(lane - 1 mod Wb) + o ? 0 : 1  (the lane roll wraps)
//   diag column = pmidx(lane - 1 mod Wb); at the end rank msrc = 0 and the
//   column is pmidx(lane), M_final = pm and the stored D is INF.
// The anchor value is min(INF, M_final + e*j) at (anchor rank, anchor j).
//
// What bounds it on the H100: as in the banded fill, a read's ranks are a
// sequential chain, so one block walks them with 3 + log2(Wb) barriers per
// rank.  Each rank also writes Wb pointer words (4 B) to device memory:
// 1.6 GB a call at the uniform config's 64 reads x 6k ranks x 1024 lanes,
// a small share of what the card streams in the barrier-bound time.
//
// What the design does about it: one block per read (no cross-block
// traffic); each ring slot remembers the window start it was written at,
// so a read's window step costs nothing (the TPU rolled every ring row by
// 128 lanes instead); the rings stay in shared memory where they fit and
// move to a per-block global slab past 227 KB (Wb 4096 on most graphs);
// pointer rows go straight to device memory, coalesced by lane, into
// (Np, B, Wb) planes that the decode reads.
//
// Decode: one thread per read walks its pointer chain from the anchor,
// one dependent word load per step (at most t_max steps), and writes
// rank<<4 | op step words; the words after the walk stops stay 0.  It is
// latency-bound (~n + K dependent loads per read); a thread per read keeps
// the whole chain in one launch instead of a launch per step.
#include "common.cuh"
#include "prefix_min.cuh"

// scratch rows: pm, pmidx, D, (dsrc, dpidx) bits, A, two scan buffers;
// then W slot starts
#define TRACE_ROWS 7

__host__ __device__ static inline long long trace_row_ints(int W,
                                                          int Wb) {
    return (long long)TRACE_ROWS * Wb + W;
}

static long long trace_ring_ints(int W, int Wb) { return 2LL * W * Wb; }

__global__ void trace_fill_kernel(
    const int* __restrict__ symbols,     // (Np,)
    const int* __restrict__ pred_slots,  // (Np*P,) ring slot per predecessor
    const int* __restrict__ pred_valid,  // (Np*P,) 0/1
    const int* __restrict__ wslots,      // (Np,) ring slot each rank writes
    const int* __restrict__ qpad,        // (B, LQ)
    const int* __restrict__ wstarts,     // (B, Np) window start per rank
    const int* __restrict__ anchor_r,    // (B,)
    const int* __restrict__ anchor_j,    // (B,)
    int B, int LQ, int Np, int n_nodes, int end_rank, int W, int P, int Wb,
    int o, int e, int x,
    int* __restrict__ ptr,               // (Np, B, Wb) pointer planes
    int* __restrict__ aval,              // (B,)
    int* gws, long long global_ints, int mode) {
    extern __shared__ int smem[];
    int* rows;
    int* mring;
    poasta_workspace(mode, smem, gws, global_ints, trace_row_ints(W, Wb),
                     &rows, &mring);
    const long long ring_ints = (long long)W * Wb;
    int* dring = mring + ring_ints;
    int* pm_row = rows;
    int* pmi_row = rows + Wb;
    int* d_row = rows + 2 * Wb;
    int* dw_row = rows + 3 * Wb;
    int* a_row = rows + 4 * Wb;
    int* s0 = rows + 5 * Wb;
    int* s1 = rows + 6 * Wb;
    int* sstart = rows + TRACE_ROWS * Wb;  // (W,) start each slot was written at
    const int b = blockIdx.x;
    const int* q = qpad + (long long)b * LQ;
    const int* ws = wstarts + (long long)b * Np;
    const int ar = anchor_r[b];
    const int aj = anchor_j[b];

    for (long long i = threadIdx.x; i < 2 * ring_ints; i += blockDim.x)
        mring[i] = POASTA_INF;  // the D ring follows the M ring
    for (int i = threadIdx.x; i < W; i += blockDim.x) sstart[i] = 0;
    if (threadIdx.x == 0) aval[b] = POASTA_INF;  // one lane matches later
    __syncthreads();

    for (int r = 0; r < n_nodes; ++r) {
        const int sym = symbols[r];
        const int w_r = ws[r];
        const int* ps = pred_slots + (long long)r * P;
        const int* pv = pred_valid + (long long)r * P;

        // gather: p = 0 is unconditional (rank 0 reads an all-INF row)
        for (int i = threadIdx.x; i < Wb; i += blockDim.x) {
            int s = ps[0];
            int k = i + w_r - sstart[s];
            int pm = k < Wb ? mring[(long long)s * Wb + k] : POASTA_INF;
            int pd = k < Wb ? dring[(long long)s * Wb + k] : POASTA_INF;
            int pmi = 0, pdi = 0;
            for (int p = 1; p < P; ++p) {
                int am = POASTA_INF, ad = POASTA_INF;
                if (pv[p] == 1) {
                    s = ps[p];
                    k = i + w_r - sstart[s];
                    if (k < Wb) {
                        am = mring[(long long)s * Wb + k];
                        ad = dring[(long long)s * Wb + k];
                    }
                }
                if (am <= pm) pmi = p;
                if (ad <= pd) pdi = p;
                pm = min(pm, am);
                pd = min(pd, ad);
            }
            const int d_open = pm + (o + e);
            const int D = min(d_open, pd + e);
            const bool open = D == d_open;
            pm_row[i] = pm;
            pmi_row[i] = pmi;
            d_row[i] = D;
            dw_row[i] = ((open ? 0 : 1) << 8) | ((open ? pmi : pdi) << 9);
        }
        __syncthreads();

        for (int i = threadIdx.x; i < Wb; i += blockDim.x) {
            const int jq = w_r + i;
            const int qc = jq < LQ ? q[jq] : 0;
            const int src = i >= 1 ? pm_row[i - 1] : POASTA_INF;
            int a = min(src + (qc == sym ? -e : x - e), d_row[i]);
            if (r == 0 && jq == 0) a = min(a, 0);
            a_row[i] = a;
            s0[i] = a;
        }
        __syncthreads();
        const int* pref = block_prefix_min(s0, s1, Wb, Wb);

        const bool is_end = r == end_rank;
        const long long wbase = (long long)wslots[r] * Wb;
        int* prow = ptr + ((long long)r * B + b) * Wb;
        for (int i = threadIdx.x; i < Wb; i += blockDim.x) {
            const int jq = w_r + i;
            const int qc = jq < LQ ? q[jq] : 0;
            const int src = i >= 1 ? pm_row[i - 1] : POASTA_INF;
            const int diag = src + (qc == sym ? -e : x - e);
            const int I = min((i >= 1 ? pref[i - 1] : POASTA_INF) + o,
                              POASTA_INF);
            const int M = min(a_row[i], I);
            const int D = d_row[i];
            const int im1 = i == 0 ? Wb - 1 : i - 1;
            const int I_prev = min((im1 >= 1 ? pref[im1 - 1] : POASTA_INF) + o,
                                   POASTA_INF);
            const int M_prev = min(a_row[im1], I_prev);
            int msrc = M == diag ? 0 : (M == D ? 1 : 2);
            if (r == 0 && jq == 0 && M == 0) msrc = 3;
            const int isrc = I == M_prev + o ? 0 : 1;
            int didx, m_final, d_store;
            if (is_end) {
                msrc = 0;
                didx = pmi_row[i];
                m_final = pm_row[i];
                d_store = POASTA_INF;
            } else {
                didx = pmi_row[im1];
                m_final = M;
                d_store = D;
            }
            prow[i] = msrc | (didx << 2) | (isrc << 7) | dw_row[i];
            if (r == ar && jq == aj) aval[b] = min(aval[b], m_final + e * jq);
            mring[wbase + i] = m_final;
            dring[wbase + i] = d_store;
        }
        if (threadIdx.x == 0) sstart[wslots[r]] = w_r;
        __syncthreads();
    }
}

__global__ void trace_decode_kernel(
    const int* __restrict__ ptr,         // (Np, B, Wb)
    const int* __restrict__ pred_ranks,  // (Np*P,)
    const int* __restrict__ wstarts,     // (B, Np)
    const int* __restrict__ anchor_r, const int* __restrict__ anchor_j,
    const int* __restrict__ active,      // (B,) 0/1
    int B, int Np, int Wb, int P, int end_rank, int t_max,
    int* __restrict__ ops,               // (B, t_max), zeroed by the caller
    int* __restrict__ done_out) {        // (B,) 0/1
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    int r = anchor_r[b];
    int j = anchor_j[b];
    int st = 0;  // 0 in M, 1 in D, 2 in I
    bool done = active[b] == 0;
    int* out = ops + (long long)b * t_max;
    const int* ws = wstarts + (long long)b * Np;
    for (int t = 0; t < t_max && !done; ++t) {
        const int lane = min(max(j - ws[r], 0), Wb - 1);
        const int word = ptr[((long long)r * B + b) * Wb + lane];
        const int msrc = word & 3;
        const int mp = (word >> 2) & 31;
        const int isrc = (word >> 7) & 1;
        const int dsrc = (word >> 8) & 1;
        const int dp = (word >> 9) & 31;
        const bool is_hop = r == end_rank && t == 0;
        const int act = st == 0 ? msrc : (st == 1 ? 1 : 2);
        const int op = is_hop ? 4 : (act == 0 ? 1 : act == 1 ? 2
                                     : act == 2 ? 3 : 0);
        const bool diag_move = is_hop || act == 0;
        const int new_r = diag_move ? pred_ranks[(long long)r * P + mp]
                          : (act == 1 ? pred_ranks[(long long)r * P + dp] : r);
        const bool consumes = !is_hop && (act == 0 || act == 2);
        out[t] = (r << 4) | op;
        done = act == 3 || new_r == 0;
        st = diag_move ? 0 : (act == 1 ? dsrc : 2 * isrc);
        j = consumes ? j - 1 : j;
        r = new_r;
    }
    done_out[b] = done ? 1 : 0;
}

extern "C" int poasta_trace_plan(int W, int Wb, int* threads, int* mode,
                                 int* smem_bytes, long long* global_ints) {
    PoastaPlan plan;
    cudaError_t err = poasta_plan(Wb, trace_row_ints(W, Wb),
                                  trace_ring_ints(W, Wb), &plan);
    if (err != cudaSuccess) return (int)err;
    *threads = plan.threads;
    *mode = plan.mode;
    *smem_bytes = plan.smem_bytes;
    *global_ints = plan.global_ints;
    return 0;
}

extern "C" int poasta_trace_fill(
    const int* symbols, const int* pred_slots, const int* pred_valid,
    const int* wslots, const int* qpad, const int* wstarts,
    const int* anchor_r, const int* anchor_j, int B, int LQ, int Np,
    int n_nodes, int end_rank, int W, int P, int Wb, int o, int e, int x,
    int* ptr, int* aval, int* gws, long long gws_ints, void* stream) {
    PoastaPlan plan;
    cudaError_t err = poasta_plan(Wb, trace_row_ints(W, Wb),
                                  trace_ring_ints(W, Wb), &plan);
    if (err != cudaSuccess) return (int)err;
    if (gws_ints < plan.global_ints * (long long)B)
        return (int)cudaErrorInvalidValue;
    return (int)poasta_launch(trace_fill_kernel, B, plan, (cudaStream_t)stream,
                              symbols, pred_slots, pred_valid, wslots, qpad,
                              wstarts, anchor_r, anchor_j, B, LQ, Np, n_nodes,
                              end_rank, W, P, Wb, o, e, x, ptr, aval, gws,
                              plan.global_ints, plan.mode);
}

extern "C" int poasta_trace_decode(
    const int* ptr, const int* pred_ranks, const int* wstarts,
    const int* anchor_r, const int* anchor_j, const int* active, int B, int Np,
    int Wb, int P, int end_rank, int t_max, int* ops, int* done,
    void* stream) {
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    trace_decode_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        ptr, pred_ranks, wstarts, anchor_r, anchor_j, active, B, Np, Wb, P,
        end_rank, t_max, ops, done);
    return (int)cudaGetLastError();
}
