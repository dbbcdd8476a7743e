// The register bodies' shared pieces: banded_kernel.cu's banded_reg_kernel
// (B1, B3, B5, B6, B16, B17), fill_kernel.cu's full_fill_reg_kernel
// (B2, B4, B7, B12, B13, B14), seed_kernel.cu's seed_fill_kernel (B8) and
// trace_kernel.cu's trace_fill_kernel (B18).  In each, thread t owns the K
// contiguous lanes [tK, tK + K) of a rank (K in {4, 8, 16}), and a rank
// takes REG_BARRIERS barriers:
//   * the K + 1 lane gather (gather_lanes, and the caller's load of lane
//     tK - 1): each thread loads its own K lanes of every predecessor row
//     as int4 and lane tK - 1, so the diagonal min_pm(lane - 1) is its own
//     register (INF at lane 0; index -1 is never read);
//   * the insertion (reg_insertion): the truncated prefix-min as van Herk /
//     Gil-Werman over segments of w lanes (prefix_min.cuh), serial over
//     the thread's lanes, shuffles across the warp, warp carries across
//     warps and the suffix w lanes left through one shared row: barrier 1;
//     the ring write, barrier 2, is the caller's;
//   * Hopper's DPX instructions where they give the same bits: add_min =
//     min(a + b, c), min3; every value stays within +-2^29, so no add
//     wraps;
//   * placement on the rings alone (reg_placement): the rings stay in shared
//     memory where they fit beside the warp carries and the side rows (the
//     scan's suffix row, and a body's own), two-piece rings that do not fit
//     whole keep M and D1 there and D2 in the block's global slab
//     (PLACE_RINGS_SPLIT), else all go to the slab (reg_workspace).
#pragma once

#include "common.cuh"
#include "prefix_min.cuh"

// The bodies of a template, by the code its plan returns.
enum { BODY_REGISTERS = 0, BODY_ROWS = 1 };

// Barriers a rank of a register body takes (a drift re-frame's apart).
#define REG_BARRIERS 2
// The warp carries of the window scan, at the front of shared memory.
#define REG_CARRY_INTS 32

__host__ __device__ inline int round_up(int n, int m) {
    return (n + m - 1) / m * m;
}

__device__ __forceinline__ int add_min(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 \
    && __CUDACC_VER_MAJOR__ >= 12
    return __viaddmin_s32(a, b, c);  // min(a + b, c), one DPX instruction
#else
    return min(a + b, c);
#endif
}

__device__ __forceinline__ int min3(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 \
    && __CUDACC_VER_MAJOR__ >= 12
    return __vimin3_s32(a, b, c);
#else
    return min(a, min(b, c));
#endif
}

template <int K>
__device__ __forceinline__ void ld_lanes(const int* p, int (&v)[K]) {
    const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
    for (int c = 0; c < K / 4; ++c) {
        const int4 t = q[c];
        v[4 * c] = t.x;
        v[4 * c + 1] = t.y;
        v[4 * c + 2] = t.z;
        v[4 * c + 3] = t.w;
    }
}

template <int K>
__device__ __forceinline__ void min_lanes(const int* p, int (&v)[K]) {
    const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
    for (int c = 0; c < K / 4; ++c) {
        const int4 t = q[c];
        v[4 * c] = min(v[4 * c], t.x);
        v[4 * c + 1] = min(v[4 * c + 1], t.y);
        v[4 * c + 2] = min(v[4 * c + 2], t.z);
        v[4 * c + 3] = min(v[4 * c + 3], t.w);
    }
}

template <int K>
__device__ __forceinline__ void st_lanes(int* p, const int (&v)[K]) {
    int4* q = reinterpret_cast<int4*>(p);
#pragma unroll
    for (int c = 0; c < K / 4; ++c)
        q[c] = make_int4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
}

// One predecessor row of the K + 1 lane gather, its K lanes: the thread's
// lanes at `off` of the M and D (and D2) rings, loaded (`first`) or folded
// into the running mins.  `off` is 16-byte aligned.  The caller reads the
// K + 1st lane, min_pm one lane left (lane tK - 1, never index -1), at its
// own address: the drifting rows wrap there.
template <int K, bool TWO_PIECE>
__device__ __forceinline__ void gather_lanes(const int* mring,
                                             const int* dring,
                                             const int* d2ring, long long off,
                                             bool first, int (&pm)[K],
                                             int (&pd)[K], int (&pd2)[K]) {
    if (first) {
        ld_lanes<K>(mring + off, pm);
        ld_lanes<K>(dring + off, pd);
        if (TWO_PIECE) ld_lanes<K>(d2ring + off, pd2);
    } else {
        min_lanes<K>(mring + off, pm);
        min_lanes<K>(dring + off, pd);
        if (TWO_PIECE) min_lanes<K>(d2ring + off, pd2);
    }
}

// The insertion and M of a rank.  `s` holds the scan's input at the
// thread's lanes (A, or A - e*lane where UNTILT: rows stored untilted are
// scanned tilted and tilted back), `agg` its min; w is the first power of
// two >= the cap and `windowed` is w < the row's lanes (else the window is
// the whole prefix and the suffix row goes unused).  Leaves
// M = min(A, min(window + o (+ e*lane), INF)) in `m`, or with INS_ONLY the
// insertion I = min(window + o, INF) alone (the trace fill needs I beside
// M).  Every thread of the block calls it (barrier 1 is inside: the
// carries and the suffix row).
template <int K, bool UNTILT, bool INS_ONLY = false>
__device__ __forceinline__ void reg_insertion(const int (&s)[K], int agg,
                                              int base, bool active, int w,
                                              bool windowed, int o, int e,
                                              int* carry, int* suf,
                                              int (&m)[K]) {
    const WindowWarp ww = window_scan_warp(agg, K, w, carry);
    if (active && windowed) {
        // Suf as far as this warp knows it, right to left, stored a 4-lane
        // chunk at a time
        int run = ww.ex_suf;
#pragma unroll
        for (int c = K / 4 - 1; c >= 0; --c) {
            int sv[4];
#pragma unroll
            for (int u = 3; u >= 0; --u) {
                const int k = 4 * c + u;
                run = min(run, s[k]);
                sv[u] = run;
                if (((base + k) & (w - 1)) == 0) run = POASTA_INF;
            }
            *reinterpret_cast<int4*>(suf + base + 4 * c) =
                make_int4(sv[0], sv[1], sv[2], sv[3]);
        }
    }
    __syncthreads();  // barrier 1: carries and the suffix row
    const int2 cb = window_scan_block(ww.ex_pre, K, w, carry);
    if (!active) return;
    // Suf(i - w) in 4-lane chunks: one int4 of the row when the chunk lies
    // w >= K lanes right of its source, else lane by lane (w < K: the
    // source may be this thread's own lanes)
    const bool far = windowed && w >= K && base >= w;
    const bool near = windowed && w < K;
    int run = cb.x;  // Ex, left to right
#pragma unroll
    for (int c = 0; c < K / 4; ++c) {
        int sv[4] = {POASTA_INF, POASTA_INF, POASTA_INF, POASTA_INF};
        if (far) {
            const int4 t =
                *reinterpret_cast<const int4*>(suf + base - w + 4 * c);
            sv[0] = min(t.x, cb.y);
            sv[1] = min(t.y, cb.y);
            sv[2] = min(t.z, cb.y);
            sv[3] = min(t.w, cb.y);
        } else if (near) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int i = base + 4 * c + u;
                if (i >= w) sv[u] = suf[i - w];
            }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int k = 4 * c + u;
            const int i = base + k;
            if ((i & (w - 1)) == 0) run = POASTA_INF;
            const int win = min(run, sv[u]);
            run = min(run, s[k]);
            const int back = UNTILT ? e * i : 0;  // back from the scan's tilt
            const int ins = add_min(win, o + back, POASTA_INF);
            m[k] = INS_ONLY ? ins : min(s[k] + back, ins);
        }
    }
}

// A register body's working set: the warp carries always in shared
// memory; the side rows (`side_ints`) and the rings in shared memory or the
// block's global slab, by placement.  `d2` is the D2 ring (two-piece),
// after the D ring but with PLACE_RINGS_SPLIT.
__device__ __forceinline__ void reg_workspace(int mode, int* smem, int* gws,
                                              long long global_ints,
                                              int side_ints,
                                              long long ring_ints, int** carry,
                                              int** side, int** rings,
                                              int** d2) {
    int* g = gws + (long long)blockIdx.x * global_ints;
    *carry = smem;
    *d2 = nullptr;
    if (mode == PLACE_SMEM || mode == PLACE_RINGS_SPLIT) {
        *side = smem + REG_CARRY_INTS;
        *rings = *side + side_ints;
        if (mode == PLACE_RINGS_SPLIT) *d2 = g;
    } else if (mode == PLACE_RINGS_GLOBAL) {
        *side = smem + REG_CARRY_INTS;
        *rings = g;
    } else {
        *side = g;
        *rings = g + side_ints;
    }
    if (*d2 == nullptr) *d2 = *rings + 2 * ring_ints;
}

// Placement of a register body's working set (`threads` already set):
// `side_ints` of side rows beside the carries, `ring_ints` over `n_rings`
// rings.  Fills plan's mode, shared-memory bytes and global ints a block.
static inline cudaError_t reg_placement(long long side_ints,
                                        long long ring_ints, int n_rings,
                                        PoastaPlan* plan) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    const long long carry_b = 4LL * REG_CARRY_INTS;
    const long long side_b = 4LL * side_ints;
    const long long ring1 = ring_ints / n_rings;
    if (carry_b + side_b + 4 * ring_ints <= optin) {
        plan->mode = PLACE_SMEM;
        plan->smem_bytes = (int)(carry_b + side_b + 4 * ring_ints);
        plan->global_ints = 0;
    } else if (n_rings == 3 && carry_b + side_b + 8 * ring1 <= optin) {
        plan->mode = PLACE_RINGS_SPLIT;
        plan->smem_bytes = (int)(carry_b + side_b + 8 * ring1);
        plan->global_ints = ring1;
    } else if (carry_b + side_b <= optin) {
        plan->mode = PLACE_RINGS_GLOBAL;
        plan->smem_bytes = (int)(carry_b + side_b);
        plan->global_ints = ring_ints;
    } else {
        plan->mode = PLACE_GLOBAL;
        plan->smem_bytes = (int)carry_b;
        plan->global_ints = side_ints + ring_ints;
    }
    return cudaSuccess;
}
