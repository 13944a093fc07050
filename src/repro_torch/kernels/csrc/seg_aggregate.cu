// Segmented aggregation (grouped sum over group codes), for Hopper.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/seg_aggregate.py:
//   sa_seg_aggregate  <- _seg_kernel  (seg_aggregate)
//
// out[g, v] = sum of values[r, v] over the rows r with codes[r] == g; codes
// outside [0, G) match nothing. The TPU version ran a one-hot matrix
// product on the MXU per 512-row tile and accumulated the [G, V] output in
// place across its sequential grid.
//
// The order of additions is fixed, so the same inputs give the same bits on
// every run and the plain version (``seg_aggregate_plain``) repeats them:
// rows are cut into chunks of ``chunk`` rows; in each chunk, each group's
// values are added in ascending row order into a double that starts at
// +0.0; the chunk partials are added in chunk order into a double that
// starts at +0.0; the total is rounded once to float. No float atomics.
//
// What bounds it on the H100: each row is read once (a code and V floats)
// and each output written once, so the least time is those bytes over the
// memory rate (0.16 us for 65,536 rows of one value). What the kernel
// cannot avoid above that is latency: two launches, and the combine's
// chain of `blocks` dependent double adds per output, which the fixed
// order forbids to cut into a tree.
//
// Pass 1 (seg_sort_kernel), one block of 512 threads per chunk. The block
// writes zeros over its [G, V] partials (coalesced), stages the chunk's
// codes and values in shared memory and sorts the chunk's (code, row)
// pairs by code, then row: a bitonic sort of 512 64-bit keys (code << 32 |
// row), one key a thread, partners within a warp swapped by shuffles and
// the 10 wider steps through shared memory. A code outside [0, G) gets the
// key code 2^31, above every valid one, so those rows sort past the end
// and match no group. The values are then moved into sorted order (through
// registers), and the runs of equal valid codes are listed by their
// starts (a ballot and a block-wide count). One thread per (run, column)
// adds the run's values in order into a double from +0.0 and writes it
// over its zero. A run holds exactly the chunk's rows of that group, in
// ascending row order (the row breaks the ties), so the sum is the one a
// scan of the chunk would make, bit for bit; a group with no run keeps the
// zero, +0.0, which is what such a scan's untouched sum holds, and that is
// exact, since a sum that starts at +0.0 is never -0.0 (x + -0.0 = x, and
// +0.0 + -0.0 = +0.0). The work per chunk is a 512-key sort plus rows V
// adds and G V zeros, where a scan per output would take G V rows
// compares; the values of a run are contiguous, so its chain of adds
// waits on no load (on skewed codes one run holds most of a chunk's rows).
//
// Pass 2 (seg_combine_kernel), one block of 8 warps per 32 outputs. All 8
// warps first load a slab of up to 128 chunk partials of the block's 32
// outputs into shared memory (16 loads in flight a thread, each warp's row
// of 32 coalesced), then warp 0 folds the slab in chunk order, lane l into
// output l's double; slab after slab, then one rounding to float. So the
// loads of all partials are issued at once and only the adds form a chain:
// loads issued one after another, each waiting for the last add, would
// wait a memory latency per chunk (253 chunks on the engine's largest
// call), and one thread per output would leave all but 8 threads of the
// card idle at G = 8.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define SEG_THREADS 512     // pass 1: one sort key a thread
#define SEG_MAX_CHUNK 512   // rows of a chunk at most (== SEG_THREADS)
#define SEG_CHUNK_FLOATS 8192  // values of a chunk at most (chunk * v)
#define SEG_NONE 0x80000000u  // sort code of a row that matches no group
#define COMBINE_WARPS 8
#define COMBINE_SLAB 128    // chunk partials a pass-2 block stages at once
#define COMBINE_PER (COMBINE_SLAB / COMBINE_WARPS)

__global__ void __launch_bounds__(SEG_THREADS)
seg_sort_kernel(const int* __restrict__ codes, const float* __restrict__ vals, long long n, int v,
                long long g, int chunk, double* __restrict__ partial) {
    __shared__ unsigned s_code[SEG_MAX_CHUNK];
    __shared__ unsigned short s_row[SEG_MAX_CHUNK];
    __shared__ unsigned long long s_key[SEG_MAX_CHUNK];  // wide exchanges; then run starts
    __shared__ int s_warp[SEG_THREADS / 32 + 1];
    extern __shared__ float s_vals[];  // [chunk, v]: rows in row order, then in sorted order
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const long long r0 = (long long)blockIdx.x * chunk;
    const int rows = n - r0 < chunk ? (int)(n - r0) : chunk;
    const long long gv = g * v;
    double* out = partial + (long long)blockIdx.x * gv;
    for (long long o = t; o < gv; o += SEG_THREADS) out[o] = 0.0;  // the empty runs
    for (int e = t; e < rows * v; e += SEG_THREADS) s_vals[e] = vals[r0 * v + e];

    // thread t holds the key of row t; rows past the chunk sort last
    unsigned long long key = ~0ull;
    if (t < rows) {
        const int c = codes[r0 + t];
        const unsigned code = c >= 0 && (long long)c < g ? (unsigned)c : SEG_NONE;
        key = (unsigned long long)code << 32 | (unsigned)t;
    }
    for (int k = 2; k <= SEG_MAX_CHUNK; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            unsigned long long other;
            if (j >= 32) {
                s_key[t] = key;
                __syncthreads();
                other = s_key[t ^ j];
                __syncthreads();
            } else {
                other = __shfl_xor_sync(0xffffffffu, key, j);
            }
            // the lower of a pair keeps the smaller key in an ascending run
            const bool keep_min = ((t & j) == 0) == ((t & k) == 0);
            key = keep_min ? (key < other ? key : other) : (key > other ? key : other);
        }
    }
    const unsigned code = (unsigned)(key >> 32);
    s_code[t] = code;
    s_row[t] = (unsigned short)key;
    __syncthreads();

    // the values into sorted order, through registers
    float x[SEG_CHUNK_FLOATS / SEG_THREADS];
#pragma unroll
    for (int u = 0; u < SEG_CHUNK_FLOATS / SEG_THREADS; ++u) {
        const int e = t + u * SEG_THREADS;
        if (e < rows * v) x[u] = s_vals[s_row[e / v] * v + e % v];
    }
    // the runs of valid codes: position t starts one where its code differs
    // from the one before; their starts, in order, by a block-wide count
    const bool starts = t < rows && code != SEG_NONE && (t == 0 || s_code[t - 1] != code);
    const unsigned ballot = __ballot_sync(0xffffffffu, starts);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    const int n_valid = __syncthreads_count(t < rows && code != SEG_NONE);
#pragma unroll
    for (int u = 0; u < SEG_CHUNK_FLOATS / SEG_THREADS; ++u) {
        const int e = t + u * SEG_THREADS;
        if (e < rows * v) s_vals[e] = x[u];
    }
    int before = 0;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
    int* s_start = reinterpret_cast<int*>(s_key);
    if (starts) s_start[before + __popc(ballot & ((1u << lane) - 1))] = t;
    int runs = 0;
    for (int w = 0; w < SEG_THREADS / 32; ++w) runs += s_warp[w];
    if (t == 0) s_start[runs] = n_valid;
    __syncthreads();  // zeros written, values sorted, run starts known

    // one (run, column) a thread: the run's values in row order into a
    // double from +0.0, over the zero written above
    for (int it = t; it < runs * v; it += SEG_THREADS) {
        const int r = it / v, col = it % v;
        const int lo = s_start[r], hi = s_start[r + 1];
        double acc = 0.0;
        for (int i = lo; i < hi; ++i) acc += (double)s_vals[i * v + col];
        out[(long long)s_code[lo] * v + col] = acc;
    }
}

__global__ void __launch_bounds__(COMBINE_WARPS * 32)
seg_combine_kernel(const double* __restrict__ partial, long long blocks, long long gv,
                   float* __restrict__ out) {
    __shared__ double tile[COMBINE_SLAB][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long o = (long long)blockIdx.x * 32 + lane;
    const bool live = o < gv;
    double acc = 0.0;
    for (long long b0 = 0; b0 < blocks; b0 += COMBINE_SLAB) {
        const int m = blocks - b0 < COMBINE_SLAB ? (int)(blocks - b0) : COMBINE_SLAB;
        // every load of the slab issued before any is used
        double x[COMBINE_PER];
#pragma unroll
        for (int u = 0; u < COMBINE_PER; ++u) {
            const int i = warp + u * COMBINE_WARPS;
            x[u] = live && i < m ? partial[(b0 + i) * gv + o] : 0.0;
        }
#pragma unroll
        for (int u = 0; u < COMBINE_PER; ++u) {
            const int i = warp + u * COMBINE_WARPS;
            if (i < m) tile[i][lane] = x[u];
        }
        __syncthreads();
        if (warp == 0)
            for (int i = 0; i < m; ++i) acc += tile[i][lane];
        __syncthreads();
    }
    if (warp == 0 && live) out[o] = (float)acc;
}

// codes [n] int32, vals [n, v] float32, out [g, v] float32, partial
// [ceil(n / chunk), g, v] double scratch; chunk <= SEG_MAX_CHUNK and
// chunk * v floats fit the block's shared memory.
extern "C" int sa_seg_aggregate(const void* codes, const void* vals, void* partial, void* out,
                                long long n, long long v, long long g, long long chunk,
                                void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const long long gv = g * v;
    if (gv == 0) return (int)cudaGetLastError();
    if (chunk < 1 || chunk > SEG_MAX_CHUNK || chunk * v > SEG_CHUNK_FLOATS)
        return (int)cudaErrorInvalidValue;
    const long long blocks = (n + chunk - 1) / chunk;
    if (blocks > 0) {
        const size_t shmem = (size_t)chunk * v * sizeof(float);
        seg_sort_kernel<<<(unsigned)blocks, SEG_THREADS, shmem, st>>>(
            (const int*)codes, (const float*)vals, n, (int)v, g, (int)chunk, (double*)partial);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    seg_combine_kernel<<<(unsigned)((gv + 31) / 32), COMBINE_WARPS * 32, 0, st>>>(
        (const double*)partial, blocks, gv, (float*)out);
    return (int)cudaGetLastError();
}
