// Decode: each read's pointer chain, walked from its anchor into step words.
//
// Replaces the XLA fori_loop of poasta_tpu/ops/pallas_trace.py:_decode_exec
// (on the traced path of lasagna align and BatchMapper.align_batch).  Same
// inputs, same step words and done flags, bit for bit.
//
// Per read b, from (r, j) = (anchor_r[b], anchor_j[b]) in state M (st 0),
// step t reads the pointer word at (r, b, clamp(j - wstarts[b, r], 0, Wb -
// 1)) of the (Np, B, Wb) planes trace_fill_kernel wrote (layout
// pallas_trace.py:67-73: msrc bits 0-1, the diagonal column mp 2-6, isrc 7,
// dsrc 8, the deletion column dp 9-13) and
//   act     = msrc in M, 1 (deletion) in D, 2 (insertion) in I
//   op      = 4 (hop) at the end rank on step 0, else 1 diag, 2 del, 3 ins,
//             0 at an origin word (act 3)
//   next r  = pred_ranks[r * P + mp] on a hop or a diagonal move,
//             pred_ranks[r * P + dp] on a deletion, r on an insertion
//   next j  = j - 1 on a diagonal move (not the hop) and an insertion
//   next st = 0 after a hop or diagonal, dsrc after a deletion, 2 * isrc
//             after an insertion
// and writes the step word (r << 4) | op at ops[b, t].  The walk stops after
// the step whose act is 3 or whose next rank is 0, or at t_max; done[b] is
// 1 where it stopped so or the read is inactive (then it writes nothing),
// else 0.  The words after the stop stay 0: the caller zeroes ops.  The
// fill writes pred columns below P only (its argmins), so mp, dp < P.
//
// What bounds it on the H100: a read's steps are a chain, each step's
// position known only when the word before it has arrived.  The word is a
// device-memory miss (the planes are 1.6 GB at the uniform config's 64
// reads x 6k ranks x 1,024 lanes, a rank's plane 256 KB apart), so the
// walk costs a device-memory round trip a step whatever its bytes (12 a
// step, 0.001 ms for the whole call at 3.35 TB/s): the chain floor is the
// longest read's steps times that round trip (352 ns for one thread's
// random hops through 1 GiB on an H100, chip_kernel_times.py).  The first
// kernel gave each read one thread (a 64-read call: 2 warps on 1 SM of
// 132) and made three dependent loads a step: the window start of r, the
// word, and the next rank from pred_ranks; 3.0x the floor.
//
// What the design does about it:
//   * one warp a read, DECODE_WARPS warps a block (a 64-read call runs on
//     8 SMs; the warps of a block share the L1 lines of pred_ranks, since
//     every read walks the same graph); lane k < P owns predecessor column
//     k;
//   * one dependent load a step: the pred row of r and the window starts of
//     its P predecessors depend on r alone, so lanes k < P fetch
//     pred_ranks[r * P + k] and then wstarts[b, pred_k] while the word is
//     in flight, and the next r and its window start come from lane mp or
//     dp by __shfl_sync the moment the word is decoded; an insertion keeps
//     r and its window start;
//   * lane t % 32 keeps step t's word, and the warp stores 32 steps as one
//     128-byte line, and the tail at the stop, instead of a 4-byte store a
//     step.
// Every speculative load stays in bounds: ranks come from pred_ranks
// (padding columns hold rank 0) and lanes are clamped to the window.  A
// step is then the word's round trip and the decode's chain of dependent
// instructions and shuffles, with a warp's steps in sequence and nothing
// to hide that chain.
#include "common.cuh"

#ifndef POASTA_FULL_MASK
#define POASTA_FULL_MASK 0xffffffffu
#endif

// Warps a block (reads a block): measured at 1, 2, 4, 8 and 16 on the main
// paths' shapes, 8 the fastest (PERF.md, the decode's row).
#define DECODE_WARPS 8

__device__ __forceinline__ int decode_lane(int j, int w, int Wb) {
    return min(max(j - w, 0), Wb - 1);
}

// The pred row of r and its window starts, in the lanes below P.
__device__ __forceinline__ void decode_preds(
    const int* __restrict__ pred_ranks, const int* __restrict__ ws, int r,
    int P, int lane, int& pk, int& wk) {
    pk = wk = 0;
    if (lane < P) {
        pk = __ldg(pred_ranks + (long long)r * P + lane);
        wk = __ldg(ws + pk);
    }
}

// No __launch_bounds__: ptxas schedules the walk best without one.  A bound
// of the block's 256 threads measured 15-25% slower on the H100, one of
// 1024 2-14% slower (PERF.md, the decode's row).
__global__ void
decode_warp_kernel(const int* __restrict__ ptr,         // (Np, B, Wb)
                   const int* __restrict__ pred_ranks,  // (Np*P,)
                   const int* __restrict__ wstarts,     // (B, Np)
                   const int* __restrict__ anchor_r,
                   const int* __restrict__ anchor_j,
                   const int* __restrict__ active,      // (B,) 0/1
                   int B, int Np, int Wb, int P, int end_rank, int t_max,
                   int* __restrict__ ops,               // (B, t_max), zeroed
                   int* __restrict__ done_out) {        // (B,) 0/1
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (b >= B) return;  // a whole warp
    const int* ws = wstarts + (long long)b * Np;
    const int* pb = ptr + (long long)b * Wb;  // read b's row at rank 0
    const long long rstride = (long long)B * Wb;
    int* out = ops + (long long)b * t_max;
    int r = anchor_r[b], j = anchor_j[b], st = 0, held = 0;
    bool done = active[b] == 0;
    int t = 0;
    if (!done && t_max > 0) {
        int w = __ldg(ws + r);
        for (; t < t_max && !done; ++t) {
            // the step's one dependent load, and r's pred row beside it
            const int word = __ldg(pb + r * rstride + decode_lane(j, w, Wb));
            int pk, wk;
            decode_preds(pred_ranks, ws, r, P, lane, pk, wk);
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
            const bool moves = diag_move || act == 1;
            const int col = diag_move ? mp : dp;
            const int nr = __shfl_sync(POASTA_FULL_MASK, pk, col);
            const int nw = __shfl_sync(POASTA_FULL_MASK, wk, col);
            if (lane == (t & 31)) held = (r << 4) | op;
            if ((t & 31) == 31) out[t - 31 + lane] = held;  // a line of 32
            done = act == 3 || (moves ? nr : r) == 0;
            st = diag_move ? 0 : (act == 1 ? dsrc : 2 * isrc);
            j = (!is_hop && (act == 0 || act == 2)) ? j - 1 : j;
            r = moves ? nr : r;
            w = moves ? nw : w;
        }
        // t steps taken: the words of the last, unfinished line
        const int rem = t & 31;
        if (lane < rem) out[t - rem + lane] = held;
    }
    if (lane == 0) done_out[b] = done ? 1 : 0;
}

static cudaError_t decode_plan(int B, int P, int* blocks) {
    if (B < 0 || P < 1 || P > 32) return cudaErrorInvalidValue;
    *blocks = (B + DECODE_WARPS - 1) / DECODE_WARPS;
    return cudaSuccess;
}

// The launch shape for B reads of pred field P: warps a block, reads a warp
// (1) and blocks.
extern "C" int poasta_decode_plan(int B, int P, int* warps_per_block,
                                  int* reads_per_warp, int* blocks) {
    *warps_per_block = DECODE_WARPS;
    *reads_per_warp = 1;
    return (int)decode_plan(B, P, blocks);
}

extern "C" int poasta_trace_decode(
    const int* ptr, const int* pred_ranks, const int* wstarts,
    const int* anchor_r, const int* anchor_j, const int* active, int B, int Np,
    int Wb, int P, int end_rank, int t_max, int* ops, int* done,
    void* stream) {
    int blocks;
    cudaError_t err = decode_plan(B, P, &blocks);
    if (err != cudaSuccess) return (int)err;
    if (blocks == 0) return 0;
    decode_warp_kernel<<<blocks, 32 * DECODE_WARPS, 0,
                         (cudaStream_t)stream>>>(
        ptr, pred_ranks, wstarts, anchor_r, anchor_j, active, B, Np, Wb, P,
        end_rank, t_max, ops, done);
    return (int)cudaGetLastError();
}
