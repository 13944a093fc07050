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
// Design: blocks run in no order here, so nothing can carry across them.
// One thread per (b, d) walking all of S would give only B * D threads (8 K
// at the RG-LRU width), too few to hide the memory latency, so S is cut in
// chunks of LR_CHUNK steps and the recurrence runs in three passes:
//   1. lr_chunk_kernel: per (b, chunk, d) the chunk's composition
//      (A, B) = (a_{t1} ... a_{t0}, the chunk's h started from 0);
//   2. lr_carry_kernel: per (b, d) the h entering each chunk, by walking
//      the chunks' compositions in order;
//   3. lr_scan_kernel: per (b, chunk, d) the chunk again from its carry,
//      writing h.
// Neighbouring threads own neighbouring channels, so every load and store
// of a warp is one 128-byte line. Passes 1 and 3 each read a and b, so the
// kernel moves 5/3 of its bound's bytes.
//
// Rounding: every product and sum is written with __fmul_rn / __fadd_rn, so
// nvcc contracts nothing into an FMA and each step rounds twice, as
// ``linrec_plain`` does step by step in the same order. Kernel and plain
// version give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#define LR_THREADS 128

// grid (B * n_chunks, D / LR_THREADS): block x is one (b, chunk), block y a
// run of LR_THREADS channels
__global__ void lr_chunk_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                long long s_len, long long d, int chunk, long long n_chunks,
                                float* __restrict__ ca, float* __restrict__ cb) {
    const long long bc = blockIdx.x;
    const long long ch = (long long)blockIdx.y * LR_THREADS + threadIdx.x;
    const long long bi = bc / n_chunks, c = bc % n_chunks;
    const long long base = (bi * s_len + c * chunk) * d + ch;
    float A = 1.0f, B = 0.0f;
#pragma unroll 8
    for (int t = 0; t < chunk; ++t) {
        const float at = a[base + t * d];
        const float bt = b[base + t * d];
        B = __fadd_rn(__fmul_rn(at, B), bt);
        A = __fmul_rn(A, at);
    }
    ca[bc * d + ch] = A;
    cb[bc * d + ch] = B;
}

// one thread per (b, d): carry[b, c, d] is the h entering chunk c
__global__ void lr_carry_kernel(const float* __restrict__ ca, const float* __restrict__ cb,
                                long long nb, long long n_chunks, long long d,
                                float* __restrict__ carry) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nb * d) return;
    const long long bi = i / d, ch = i % d;
    float h = 0.0f;
    for (long long c = 0; c < n_chunks; ++c) {
        const long long idx = (bi * n_chunks + c) * d + ch;
        carry[idx] = h;
        h = __fadd_rn(__fmul_rn(ca[idx], h), cb[idx]);
    }
}

__global__ void lr_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                               const float* __restrict__ carry, long long s_len, long long d,
                               int chunk, long long n_chunks, float* __restrict__ h_out) {
    const long long bc = blockIdx.x;
    const long long ch = (long long)blockIdx.y * LR_THREADS + threadIdx.x;
    const long long bi = bc / n_chunks, c = bc % n_chunks;
    const long long base = (bi * s_len + c * chunk) * d + ch;
    float h = carry[bc * d + ch];
#pragma unroll 8
    for (int t = 0; t < chunk; ++t) {
        h = __fadd_rn(__fmul_rn(a[base + t * d], h), b[base + t * d]);
        h_out[base + t * d] = h;
    }
}

// a, b, h [nb, s_len, d] float32; ca, cb, carry [nb, s_len / chunk, d]
// float32 scratch. s_len % chunk == 0 and d % LR_THREADS == 0.
extern "C" int lr_linrec(const void* a, const void* b, void* ca, void* cb, void* carry, void* h,
                         long long nb, long long s_len, long long d, long long chunk,
                         void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (nb == 0 || s_len == 0 || d == 0) return (int)cudaGetLastError();
    if (s_len % chunk != 0 || d % LR_THREADS != 0 || d / LR_THREADS > 65535)
        return (int)cudaErrorInvalidValue;
    const long long n_chunks = s_len / chunk;
    const dim3 grid((unsigned)(nb * n_chunks), (unsigned)(d / LR_THREADS));
    lr_chunk_kernel<<<grid, LR_THREADS, 0, st>>>(
        (const float*)a, (const float*)b, s_len, d, (int)chunk, n_chunks, (float*)ca, (float*)cb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lr_carry_kernel<<<(unsigned)((nb * d + 255) / 256), 256, 0, st>>>(
        (const float*)ca, (const float*)cb, nb, n_chunks, d, (float*)carry);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lr_scan_kernel<<<grid, LR_THREADS, 0, st>>>(
        (const float*)a, (const float*)b, (const float*)carry, s_len, d, (int)chunk, n_chunks,
        (float*)h);
    return (int)cudaGetLastError();
}
