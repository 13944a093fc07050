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
// What bounds it on the H100: each row is read once (a code and V floats)
// and each output written once, so the least time is the bytes over the
// memory rate. This kernel does more work than that: every output element
// scans its chunk's codes (G x V x rows compares in all), which at the
// engine's G <= 4096 buckets and 64 K-row morsels is some 2.7e8 shared
// memory compares.
//
// Design: the same inputs must give the same bits on every run, so there
// are no float atomics. Pass 1: block b stages its chunk of rows (codes and
// values) in shared memory; each thread owns output elements (g, v) and
// adds the chunk's matching values in ascending row order into a double.
// The block's partials go to a [blocks, G, V] double scratch. Pass 2: one
// thread per output element adds the block partials in block order and
// rounds once to float. The order of every addition is fixed, so the plain
// version (``seg_aggregate_plain``) repeats it exactly.

#include <cuda_runtime.h>
#include <stdint.h>

#define SEG_THREADS 1024
#define SEG_MAX_CHUNK 512
#define FINAL_BLOCK 256

__global__ void seg_partial_kernel(const int* __restrict__ codes,
                                   const float* __restrict__ vals, long long n, int v,
                                   long long g, int chunk, double* __restrict__ partial) {
    __shared__ int s_codes[SEG_MAX_CHUNK];
    extern __shared__ float s_vals[];  // [chunk, v]
    const long long r0 = (long long)blockIdx.x * chunk;
    const int rows = n - r0 < chunk ? (int)(n - r0) : chunk;
    for (int r = threadIdx.x; r < rows; r += blockDim.x) s_codes[r] = codes[r0 + r];
    for (int e = threadIdx.x; e < rows * v; e += blockDim.x) s_vals[e] = vals[r0 * v + e];
    __syncthreads();
    const long long gv = g * v;
    double* out = partial + (long long)blockIdx.x * gv;
    for (long long o = threadIdx.x; o < gv; o += blockDim.x) {
        const int grp = (int)(o / v);
        const int col = (int)(o % v);
        double acc = 0.0;
        for (int r = 0; r < rows; ++r)
            if (s_codes[r] == grp) acc += (double)s_vals[r * v + col];
        out[o] = acc;
    }
}

__global__ void seg_final_kernel(const double* __restrict__ partial, long long blocks,
                                 long long gv, float* __restrict__ out) {
    const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (o >= gv) return;
    double acc = 0.0;
    for (long long b = 0; b < blocks; ++b) acc += partial[b * gv + o];
    out[o] = (float)acc;
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
    const long long blocks = (n + chunk - 1) / chunk;
    if (blocks > 0) {
        const size_t shmem = (size_t)chunk * v * sizeof(float);
        seg_partial_kernel<<<(unsigned)blocks, SEG_THREADS, shmem, st>>>(
            (const int*)codes, (const float*)vals, n, (int)v, g, (int)chunk,
            (double*)partial);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    seg_final_kernel<<<(unsigned)((gv + FINAL_BLOCK - 1) / FINAL_BLOCK), FINAL_BLOCK, 0, st>>>(
        (const double*)partial, blocks, gv, (float*)out);
    return (int)cudaGetLastError();
}
