// Block-wide inclusive prefix-min along a row, truncated to a look-back
// window.  Replaces poasta_tpu/ops/pallas_fill.py:_prefix_min_rows.
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
