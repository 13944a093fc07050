// First-order linear recurrence h_t = a_t * h_{t-1} + b_t, h_0 = 0, over
// [B, S, D] float32 (elementwise over the D channels), for Hopper.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/linrec.py:
//   lr_linrec  <- _linrec_kernel  (linrec)
//
// The TPU version walked the sequence in 256-step chunks as the innermost,
// sequential grid dimension: a log-depth doubling scan of each chunk on the
// VPU, composed with a carry held in VMEM across grid steps.
//
// What bounds it on the H100: the bytes. It reads a and b once and writes h
// once (12 bytes a step and channel) and does two float operations a step;
// at the RG-LRU width [2, 4096, 4096] that is 403 MB, 0.12 ms at 3.35 TB/s.
//
// Design: one launch, a chained scan that reads a and b once. The sequence
// is cut in chunks of LR_CHUNK steps. A block owns a group of LR_WARPS
// chunks of one strip of LR_STRIP channels of one batch row; each warp owns
// one chunk (lane = channel, so every load and store of a warp is one
// 128-byte line). A block:
//   1. takes its (group, strip) from an atomic ticket, groups in order;
//   2. loads its chunks' a and b into registers (all 128 loads of a thread
//      in flight) and builds each chunk's composition (A, B) = (a_{t1} ...
//      a_{t0}, the chunk's h started from 0) into shared memory;
//   3. in its first warp, waits for the block of the strip's previous
//      group to publish the h that leaves it, walks from there over its own
//      chunks' compositions in order, keeping the h that enters each, and
//      publishes the h that leaves the group (a release store of a flag
//      after the values; the next group's block reads them after an acquire
//      load of the flag);
//   4. scans each chunk again from its carry, from the registers, and
//      stores h.
// A block waits only for a block of a lower ticket, which has started, so
// the chain always moves. The tickets and flags live in a small scratch
// that the same C call zeroes with cudaMemsetAsync before the launch.
// Blocks of 4 warps at about 150 registers a thread leave three blocks on
// an SM, so one block's loads overlap another's walk and stores.
//
// Tried on an H100 80GB HBM3 at 700 W and not kept: one thread block
// cluster per strip (up to 8 blocks exchanging their chunks' compositions
// through distributed shared memory, each walking to its own carry). It
// read a and b once too, but took 0.21-0.27 ms at [2, 4096, 4096] over the
// block and cluster sizes tried (this design: 0.15 ms): a cluster holds 8
// SMs of one GPC at once, its blocks wait for each other at two barriers
// per segment, and at one block an SM (202 registers) nothing overlaps.
//
// Rounding: every product and sum is written with __fmul_rn / __fadd_rn, so
// nvcc contracts nothing into an FMA and each step rounds twice. The order
// is that of ``linrec_plain``: each chunk's composition step by step, the
// carry into a chunk walked over the compositions of every chunk before it
// (never taken from the previous chunk's rescan, and never from a composite
// of several chunks, which would round otherwise), each chunk again from its
// carry. Kernel and plain version give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#define LR_CHUNK 64   // steps of a chunk (one warp's)
#define LR_WARPS 4    // chunks of a block's group
#define LR_STRIP 32   // channels of a strip (a warp's lanes)

__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
    asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// grid (groups * strips of a row, B); ticket t is the item (group t /
// n_strips, strip t % n_strips), a strip being (batch row, LR_STRIP
// channels). flag[t] != 0 once carries[t] holds the h leaving item t.
__global__ void __launch_bounds__(LR_WARPS * 32, 1)
lr_chain_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ h,
                long long s_len, long long d, int* __restrict__ ticket, int* __restrict__ flag,
                float* __restrict__ carries) {
    __shared__ int item;
    __shared__ float comp_a[LR_WARPS][LR_STRIP], comp_b[LR_WARPS][LR_STRIP];
    __shared__ float carry_in[LR_WARPS][LR_STRIP];
    if (threadIdx.x == 0) item = atomicAdd(ticket, 1);
    __syncthreads();
    const long long n_chunks = s_len / LR_CHUNK;
    const long long n_groups = (n_chunks + LR_WARPS - 1) / LR_WARPS;
    const long long strips_per_row = d / LR_STRIP;
    const long long n_strips = strips_per_row * gridDim.y;
    const long long t = item;
    const long long g = t / n_strips, strip = t % n_strips;
    const long long row = strip / strips_per_row;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long c = g * LR_WARPS + warp;  // this warp's chunk
    const bool active = c < n_chunks;
    const long long base =
        (row * s_len + c * LR_CHUNK) * d + (strip % strips_per_row) * LR_STRIP + lane;
    float ra[LR_CHUNK], rb[LR_CHUNK];
    if (active) {  // 2. the chunk's steps and its composition
#pragma unroll
        for (int k = 0; k < LR_CHUNK; ++k) {
            ra[k] = __ldcs(a + base + k * d);
            rb[k] = __ldcs(b + base + k * d);
        }
        float A = 1.0f, B = 0.0f;
#pragma unroll
        for (int k = 0; k < LR_CHUNK; ++k) {
            B = __fadd_rn(__fmul_rn(ra[k], B), rb[k]);
            A = __fmul_rn(A, ra[k]);
        }
        comp_a[warp][lane] = A;
        comp_b[warp][lane] = B;
    }
    __syncthreads();
    if (warp == 0) {  // 3. the carries: wait, walk, publish
        float hw = 0.0f;
        if (g > 0) {
            const long long prev = t - n_strips;
            while (ld_acquire(flag + prev) == 0) __nanosleep(64);
            hw = __ldcg(carries + prev * LR_STRIP + lane);
        }
        const long long left = n_chunks - g * LR_WARPS;
        const int n_here = left < LR_WARPS ? (int)left : LR_WARPS;
        for (int j = 0; j < n_here; ++j) {
            carry_in[j][lane] = hw;
            hw = __fadd_rn(__fmul_rn(comp_a[j][lane], hw), comp_b[j][lane]);
        }
        if (g + 1 < n_groups) {
            carries[t * LR_STRIP + lane] = hw;
            __threadfence();
            __syncwarp();
            if (lane == 0) st_release(flag + t, 1);
        }
    }
    __syncthreads();
    if (active) {  // 4. the chunk again from its carry
        float hk = carry_in[warp][lane];
#pragma unroll
        for (int k = 0; k < LR_CHUNK; ++k) {
            hk = __fadd_rn(__fmul_rn(ra[k], hk), rb[k]);
            __stcs(h + base + k * d, hk);
        }
    }
}

static long long lr_items(long long nb, long long s_len, long long d) {
    return (s_len / LR_CHUNK + LR_WARPS - 1) / LR_WARPS * nb * (d / LR_STRIP);
}

// int32 words of scratch lr_linrec needs: the ticket, a flag per item and
// LR_STRIP carries per item
extern "C" long long lr_scratch_words(long long nb, long long s_len, long long d) {
    return 1 + lr_items(nb, s_len, d) * (1 + LR_STRIP);
}

// a, b, h [nb, s_len, d] float32, s_len % 256 == 0 and d % 32 == 0; scratch
// holds lr_scratch_words(nb, s_len, d) int32 words
extern "C" int lr_linrec(const void* a, const void* b, void* h, void* scratch, long long nb,
                         long long s_len, long long d, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (nb == 0 || s_len == 0 || d == 0) return (int)cudaGetLastError();
    const long long per_row = lr_items(1, s_len, d);
    if (s_len % (4 * LR_CHUNK) || d % LR_STRIP || nb > 65535 || per_row * nb > 0x7FFFFFFF)
        return (int)cudaErrorInvalidValue;
    int* ticket = (int*)scratch;
    int* flag = ticket + 1;
    float* carries = (float*)(flag + per_row * nb);
    cudaError_t err = cudaMemsetAsync(scratch, 0, (1 + per_row * nb) * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    lr_chain_kernel<<<dim3((unsigned)per_row, (unsigned)nb), LR_WARPS * 32, 0, st>>>(
        (const float*)a, (const float*)b, (float*)h, s_len, d, ticket, flag, carries);
    return (int)cudaGetLastError();
}

// The launch lr_linrec makes for this shape, into out (host int64 [3]): the
// blocks of the grid, the threads of a block, and how many blocks an SM
// holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int lr_launch_info(void* out, long long nb, long long s_len, long long d) {
    int per_sm = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lr_chain_kernel, LR_WARPS * 32, 0);
    long long* o = (long long*)out;
    o[0] = lr_items(nb, s_len, d);
    o[1] = LR_WARPS * 32;
    o[2] = per_sm;
    return (int)err;
}
