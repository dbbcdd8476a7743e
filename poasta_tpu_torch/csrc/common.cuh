// Shared pieces of the fill kernels: the INF sentinel and the placement
// of a read's working set (scratch rows + ring buffers).
//
// One thread block fills one read.  Its working set is its scratch rows
// (five of `row_lanes` int32 lanes for the fills, and the best row of an
// ends-free fill) plus the M and D rings.
// Where the whole set fits in the block's opt-in shared memory (227 KB on
// an H100) it lives there; otherwise the rings move to a global-memory
// slab owned by the block, and past that the rows follow.  The kernels
// address both through generic pointers, so one kernel body serves every placement.
#pragma once

#include <cuda_runtime.h>

#define POASTA_INF (1 << 28)

enum PoastaPlacement {
    PLACE_SMEM = 0,          // rows and rings in shared memory
    PLACE_RINGS_GLOBAL = 1,  // rows in shared memory, rings in global memory
    PLACE_GLOBAL = 2,        // rows and rings in global memory
};

struct PoastaPlan {
    int threads;
    int mode;
    int smem_bytes;
    long long global_ints;  // per block
};

// Number of scratch rows each kernel keeps: min_pm, D, A, and the two
// ping-pong buffers of the prefix-min scan.
#define POASTA_ROWS 5

// `row_ints` is the size of the scratch-row region (POASTA_ROWS rows of
// `row_lanes` lanes for the fills; the trace kernel keeps more).
static inline cudaError_t poasta_plan(int row_lanes, long long row_ints,
                                      long long ring_ints, PoastaPlan* plan) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    const long long rows_bytes = 4LL * row_ints;
    const long long ring_bytes = 4LL * ring_ints;
    int threads = ((row_lanes + 31) / 32) * 32;
    plan->threads = threads < 1024 ? threads : 1024;
    if (rows_bytes + ring_bytes <= optin) {
        plan->mode = PLACE_SMEM;
        plan->smem_bytes = (int)(rows_bytes + ring_bytes);
        plan->global_ints = 0;
    } else if (rows_bytes <= optin) {
        plan->mode = PLACE_RINGS_GLOBAL;
        plan->smem_bytes = (int)rows_bytes;
        plan->global_ints = ring_ints;
    } else {
        plan->mode = PLACE_GLOBAL;
        plan->smem_bytes = 0;
        plan->global_ints = row_ints + ring_ints;
    }
    return cudaSuccess;
}

// Splits a block's working set into (rows, rings) for the chosen placement.
__device__ __forceinline__ void poasta_workspace(
    int mode, int* smem, int* gws, long long global_ints, long long row_ints,
    int** rows, int** rings) {
    int* g = gws + (long long)blockIdx.x * global_ints;
    if (mode == PLACE_SMEM) {
        *rows = smem;
        *rings = smem + row_ints;
    } else if (mode == PLACE_RINGS_GLOBAL) {
        *rows = smem;
        *rings = g;
    } else {
        *rows = g;
        *rings = g + row_ints;
    }
}

// Raises the dynamic shared-memory cap where the plan needs more than the
// default 48 KB, launches, and reports a refused launch.
template <typename Kernel, typename... Args>
static inline cudaError_t poasta_launch(Kernel kernel, int blocks,
                                        const PoastaPlan& plan,
                                        cudaStream_t stream, Args... args) {
    if (plan.smem_bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            plan.smem_bytes);
        if (err != cudaSuccess) return err;
    }
    kernel<<<blocks, plan.threads, plan.smem_bytes, stream>>>(args...);
    return cudaGetLastError();
}
