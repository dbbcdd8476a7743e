// Block-wide inclusive prefix-min along a row, truncated to a look-back
// window.  Replaces poasta_tpu/ops/pallas_fill.py:_prefix_min_rows.  Two
// forms: block_prefix_min over a row in memory (the full fills' rows body,
// fill_kernel.cu:full_fill_rows_kernel), and below it the window scan over
// lanes held in threads' registers (the register bodies of the banded,
// full, seeded and trace fills, and the banded rows body's thread chunks).
//
// Hillis-Steele rounds k = 1, 2, 4, ... while k < cap: after them lane j
// holds the min over lanes [j - w + 1, j], where w = the first power of
// two >= cap, and lanes left of 0 count as INF.  With cap >= the row
// width that is the full prefix-min; with cap = the insertion-run bound
// (aligner/banded.py:ins_run_cap) it is exactly the truncated window the
// TPU kernels scan, which the verify-and-retry ladder's tier choices
// depend on.  Each round reads one buffer and writes the other, with one
// barrier between rounds.
#pragma once

#include "common.cuh"

// `buf0` holds the input row (it is overwritten when two or more rounds
// run); `buf1` is scratch.  The caller has synchronised after writing
// `buf0`.  Returns the buffer that holds the result.  Every thread of the
// block must call it.
__device__ __forceinline__ const int* block_prefix_min(int* buf0, int* buf1,
                                                       int n, int cap) {
    int* cur = buf0;
    int* nxt = buf1;
    for (int k = 1; k < cap; k <<= 1) {
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int shifted = i >= k ? cur[i - k] : POASTA_INF;
            nxt[i] = min(cur[i], shifted);
        }
        __syncthreads();
        int* t = cur;
        cur = nxt;
        nxt = t;
    }
    return cur;
}

// ---------------------------------------------------------------------------
// The same truncated window as van Herk / Gil-Werman, for a block whose
// thread t owns the `kt` contiguous lanes [t*kt, t*kt + kt) (kt a power of
// two; blockDim.x a multiple of 32).  The register bodies use it.
//
// With w = the first power of two >= cap, cut the row into segments of w
// lanes at multiples of w.  The insertion at lane i needs the min over
// [i - w, i - 1]; with S = i's segment start that is
//     min(Ex(i), Suf(i - w))
//     Ex(i)  = min over [S, i - 1]            (INF when i == S)
//     Suf(j) = min over [j, j's segment end]  (INF when j < 0)
// because [i - w, S - 1] is the tail of the previous segment (i - w >= S - w)
// and [S, i - 1] the head of i's own.  Min is associative and commutative,
// so the value is exactly what block_prefix_min's rounds k < cap give at
// i - 1 (the same window, lanes left of 0 INF), whatever order it is taken
// in: bit for bit, with no arithmetic but min.  When w >= the row width, i
// - w < 0 everywhere and Ex is the plain prefix.
//
// The segments, kt and the warps are all powers of two and aligned, so a
// segment of w > kt lanes spans g = w / kt whole threads, and one of w > 32
// kt whole warps.  Three levels, two of them before the block's barrier:
//   1. each thread over its own lanes, serially (the caller);
//   2. window_scan_warp: a segmented shuffle scan of the threads' minima,
//      up and down, within the warp (log2(min(g, 32)) rounds), giving each
//      thread the min of its segment's lanes left and right of it in its
//      warp, and each warp's min in `carry` when a segment spans warps;
//   3. after the barrier, window_scan_block: every warp scans the carries
//      (log2 of the warps per segment rounds of shuffles) for its own
//      exclusive prefix carry and for the suffix carry of the warp that
//      holds lanes i - w.
// The caller writes Suf as far as its warp knows it (levels 1-2) to one
// shared row before the barrier and reads lane i - w after it, adding the
// suffix carry of level 3.  One barrier serves the carries and the row.
// ---------------------------------------------------------------------------

#define POASTA_FULL_MASK 0xffffffffu

struct WindowWarp {
    int ex_pre;  // min of this thread's segment left of it, within its warp
    int ex_suf;  // ... and right of it, within its warp
};

// Level 2.  `agg` is the min of the thread's lanes (INF for lanes past the
// row).  Every thread of the block calls it with the same kt and w.
__device__ __forceinline__ WindowWarp window_scan_warp(int agg, int kt, int w,
                                                       int* carry) {
    WindowWarp r = {POASTA_INF, POASTA_INF};
    if (w <= kt) return r;  // segments lie inside threads
    const int g = w / kt;
    const int gm = g < 32 ? g : 32;
    const int lane = threadIdx.x & 31;
    const int li = lane & (gm - 1);
    int inc_p = agg, inc_s = agg;
    for (int d = 1; d < gm; d <<= 1) {
        const int up = __shfl_up_sync(POASTA_FULL_MASK, inc_p, d);
        const int dn = __shfl_down_sync(POASTA_FULL_MASK, inc_s, d);
        if (li >= d) inc_p = min(inc_p, up);
        if (li + d < gm) inc_s = min(inc_s, dn);
    }
    const int up = __shfl_up_sync(POASTA_FULL_MASK, inc_p, 1);
    const int dn = __shfl_down_sync(POASTA_FULL_MASK, inc_s, 1);
    r.ex_pre = li > 0 ? up : POASTA_INF;
    r.ex_suf = li < gm - 1 ? dn : POASTA_INF;
    if (g > 32 && lane == 31) carry[threadIdx.x >> 5] = inc_p;  // warp min
    return r;
}

// Level 3, after the barrier that follows window_scan_warp.  Returns
// (x) the thread's exclusive prefix carry within its segment and (y) the
// min of the warps right of warp u in u's segment, to join with the
// shared row's Suf there: u = warp(i - w), the warp a segment back, or
// with `own` this thread's warp (INF where the row is complete, or u < 0).
__device__ __forceinline__ int2 window_scan_block(int ex_pre, int kt, int w,
                                                  const int* carry,
                                                  bool own = false) {
    if (w <= kt || w / kt <= 32) return make_int2(ex_pre, POASTA_INF);
    const int h = (w / kt) >> 5;  // warps per segment
    const int hm = h < 32 ? h : 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int li = lane & (hm - 1);
    const int v = lane < (int)(blockDim.x >> 5) ? carry[lane] : POASTA_INF;
    int inc_p = v, inc_s = v;
    for (int d = 1; d < hm; d <<= 1) {
        const int up = __shfl_up_sync(POASTA_FULL_MASK, inc_p, d);
        const int dn = __shfl_down_sync(POASTA_FULL_MASK, inc_s, d);
        if (li >= d) inc_p = min(inc_p, up);
        if (li + d < hm) inc_s = min(inc_s, dn);
    }
    const int prev = __shfl_sync(POASTA_FULL_MASK, inc_p, (warp + 31) & 31);
    if ((warp & (hm - 1)) != 0) ex_pre = min(ex_pre, prev);
    // lanes i - w lie in warp u = warp - h (a segment of h warps back)
    const int u = own ? warp : warp - h;
    const int next = __shfl_sync(POASTA_FULL_MASK, inc_s, (u + 1) & 31);
    const int suf = u >= 0 && ((u + 1) & (hm - 1)) != 0 ? next : POASTA_INF;
    return make_int2(ex_pre, suf);
}
