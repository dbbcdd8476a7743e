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
// third ring and one more scratch row hold D2 = min(min_pd, min_pd2) + e
// (INF at the end rank, as D is), and A = min(diag, D, D2).  The insertion term above is then the TPU kernel's
// coupled (I1, I2) scan folded into one prefix-min of A - e2*j, exact
// because only M = min(A, I1, I2) is stored and e1 >= e2 (see
// banded_kernel.cu).
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
// 227 KB opt-in limit, by common.cuh's rule (with the rank row, seven rows:
// 143 KB at L = 5120, so the rings of a 5 kb batch are always global).  B2
// and B4 are the ladders' last resort; B7 scores the first batch of a
// semi-global read stream, before the seeded corridor fill takes over; B12
// is the two-piece ladder's last resort (three rings, 3*W*L int32, always
// global at 5 kb reads).  B13 and B14 carry every two-piece ends-free
// batch, which has no banded or seeded kernel: eight rows for B14 (164 KB
// at L = 5120) and three rings, always global at 5 kb reads.  The rank
// tables are read from global memory at any graph size, so B14 also
// serves the graphs the TPU streamed (B15).
#include "common.cuh"
#include "prefix_min.cuh"

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

// the kernel's scratch rows: POASTA_ROWS, then D2 (two-piece), best
// (bounded) and the rank row (ends)
static inline long long fill_row_ints(FillFlags f, int L) {
    return (long long)(POASTA_ROWS + f.two_piece + f.bounded + f.ends) * L;
}

static inline long long fill_ring_ints(FillFlags f, int W, int L) {
    return (f.two_piece ? 3LL : 2LL) * W * L;
}

template <bool BOUNDED, bool ENDS, bool TWO_PIECE>
__global__ void full_fill_kernel(
    const int* __restrict__ symbols,     // (Np,)
    const int* __restrict__ pred_slots,  // (Np*P,)
    const int* __restrict__ pred_valid,  // (Np*P,) 0/1
    const int* __restrict__ wslots,      // (Np,)
    const int* __restrict__ end_ok,      // (Np,) 0/1 (bounded)
    const int* __restrict__ qshift,      // (B, L)
    int L, int n_nodes, int end_rank, int W, int P, int o, int e, int ed_in,
    int x, int cap, int free_start,
    int* __restrict__ out_rows,          // (B, L): end rows, or best rows
    int* __restrict__ out_ranks,         // (B, L): first rank at best (ENDS)
    int* gws, long long global_ints, int mode) {
    extern __shared__ int smem[];
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

extern "C" int poasta_fill_plan(int variant, int W, int L, int* threads,
                                int* mode, int* smem_bytes,
                                long long* global_ints) {
    FillFlags flags;
    if (!fill_flags(variant, &flags)) return (int)cudaErrorInvalidValue;
    PoastaPlan plan;
    cudaError_t err = poasta_plan(L, fill_row_ints(flags, L),
                                  fill_ring_ints(flags, W, L), &plan);
    if (err != cudaSuccess) return (int)err;
    *threads = plan.threads;
    *mode = plan.mode;
    *smem_bytes = plan.smem_bytes;
    *global_ints = plan.global_ints;
    return 0;
}

// `variant` = 0: the global fill (end_ok may be null; cap and free_start
// are not read); 1: the ends-free fill; 2: the ends-free fill that also
// writes `out_ranks`; 3, 4, 5: 0, 1, 2 with two-piece costs (`ed` is read
// only there).
extern "C" int poasta_full_fill(
    int variant, const int* symbols, const int* pred_slots,
    const int* pred_valid, const int* wslots, const int* end_ok,
    const int* qshift, int B, int L, int n_nodes, int end_rank, int W, int P,
    int o, int e, int ed, int x, int cap, int free_start, int* out_rows,
    int* out_ranks, int* gws, long long gws_ints, void* stream) {
    FillFlags flags;
    if (!fill_flags(variant, &flags)) return (int)cudaErrorInvalidValue;
    PoastaPlan plan;
    cudaError_t err = poasta_plan(L, fill_row_ints(flags, L),
                                  fill_ring_ints(flags, W, L), &plan);
    if (err != cudaSuccess) return (int)err;
    if (gws_ints < plan.global_ints * (long long)B)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define POASTA_FULL_FILL(BOUNDED, ENDS, TWO_PIECE)                             \
    (int)poasta_launch(full_fill_kernel<BOUNDED, ENDS, TWO_PIECE>, B, plan,    \
                       st, symbols, pred_slots, pred_valid, wslots, end_ok,    \
                       qshift, L, n_nodes, end_rank, W, P, o, e, ed, x, cap,   \
                       free_start, out_rows, out_ranks, gws, plan.global_ints, \
                       plan.mode)
    switch (variant) {
        case 5: return POASTA_FULL_FILL(true, true, true);
        case 4: return POASTA_FULL_FILL(true, false, true);
        case 3: return POASTA_FULL_FILL(false, false, true);
        case 2: return POASTA_FULL_FILL(true, true, false);
        case 1: return POASTA_FULL_FILL(true, false, false);
        default: return POASTA_FULL_FILL(false, false, false);
    }
#undef POASTA_FULL_FILL
}
