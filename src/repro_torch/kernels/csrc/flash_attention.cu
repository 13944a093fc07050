// Causal, optionally sliding-window, attention with an online softmax over
// [BH, S, dh] float32 or bf16, for Hopper.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   fa_flash_attention  <- _flash_kernel  (flash_attention)
//
// Semantics, as the reference's: scores are q.k in float32 times
// 1/sqrt(dh); key kpos is visible to query qpos when qpos >= kpos and, with
// a window, qpos - kpos < window; masked scores are -1e30 (not -inf); m, l
// and acc are float32; p is rounded to v's type before the P.V product; the
// output is acc / max(l, 1e-30) in q's type. The TPU version walked every
// KV tile of 128 keys for every query tile as its sequential grid
// dimension, masked ones included.
//
// What bounds it on the H100: the operations. A visible (q, k) pair costs
// 4 * dh flops (two products of dh), so at recurrentgemma-9b's local
// attention ([16, 4096, 256] bf16, window 2048) the 1.0e11 flops take
// 0.104 ms on bf16 tensor cores and its 134 MB of q, k, v and o 0.040 ms.
// This kernel does its arithmetic in float32 on CUDA cores (67 TFLOP/s at
// most), so it cannot come near that bound; tensor cores (mma.sync or
// wgmma) and asynchronous tile loads are later work.
//
// Design: one block of 256 threads per (bh, 64-query tile). The query tile
// is staged once in shared memory as float32; then for each 64-key tile
// that holds a visible key for some row of the block (tiles wholly above
// the diagonal or wholly before the window are skipped: a skipped tile
// would add exp(-1e30 - m) = 0, or sums that alpha = 0 wipes later, so
// skipping changes no result), K is staged, each thread computes a 4 x 4
// block of scores (rows ty*4+i, keys tx+16j) from shared memory, V
// overwrites K in the same buffer, the online softmax runs in registers
// with the row's max and sum reduced over its 16 threads by shuffles, P
// goes to shared memory rounded to v's type, and each thread adds P.V into
// its 4 rows x dh/16 columns of acc, which stay in registers. Rows are
// padded to DHP + 1 floats (DHP is dh rounded up to 64, 128 or 256; pad
// columns are zero), so the column reads of a warp fall in distinct banks.
// Shared memory is 49-148 KB by DHP, above the 48 KB a launch gets by
// default, so every launch first raises the kernel's dynamic limit.
//
// Built without fast math: expf is the accurate one and '/' is IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
#define FA_NEG (-1e30f)
static_assert(FA_BQ == FA_BK, "stage() fills query and key tiles alike");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// rows [0, FA_BQ) of a [rows, dh] slab into a [FA_BQ, DHP + 1] float tile
template <typename T, int DHP>
__device__ __forceinline__ void stage(const T* __restrict__ src, int dh, float* dst) {
    for (int e = threadIdx.x; e < FA_BQ * DHP; e += FA_THREADS) {
        const int r = e / DHP, c = e % DHP;
        dst[r * (DHP + 1) + c] = c < dh ? to_f(src[(long long)r * dh + c]) : 0.0f;
    }
}

template <typename T, int DHP>
__global__ void __launch_bounds__(FA_THREADS)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int s_len, int dh, int window, float scale) {
    constexpr int LD = DHP + 1;
    constexpr int PLD = FA_BK + 1;
    constexpr int NC = DHP / 16;  // acc columns of a thread: tx + 16 n
    extern __shared__ float smem[];
    float* qs = smem;              // [FA_BQ, LD]
    float* kv = qs + FA_BQ * LD;   // [FA_BK, LD]: the tile's K, then its V
    float* ps = kv + FA_BK * LD;   // [FA_BQ, PLD]

    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int n_q = s_len / FA_BQ;
    const long long bh = blockIdx.x / n_q;
    const int q0 = (blockIdx.x % n_q) * FA_BQ;
    const long long slab = bh * s_len;

    float m[4], l[4], acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = FA_NEG;
        l[i] = 0.0f;
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = 0.0f;
    }

    const int last = q0 + FA_BQ - 1;
    int kt_lo = 0;
    if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / FA_BK;
    const int kt_hi = last / FA_BK;

    stage<T, DHP>(q + (slab + q0) * dh, dh, qs);
    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const int k0 = kt * FA_BK;
        __syncthreads();  // the last tile's P.V has read kv and ps
        stage<T, DHP>(k + (slab + k0) * dh, dh, kv);
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
        for (int c = 0; c < DHP; ++c) {
            float qv[4], kk[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * LD + c];
#pragma unroll
            for (int j = 0; j < 4; ++j) kk[j] = kv[(tx + 16 * j) * LD + c];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kk[j], sc[i][j]);
        }
        __syncthreads();  // every thread has read K
        stage<T, DHP>(v + (slab + k0) * dh, dh, kv);

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q0 + ty * 4 + i;
            float mx = FA_NEG;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kpos = k0 + tx + 16 * j;
                const bool ok = qpos >= kpos && (window <= 0 || qpos - kpos < window);
                sc[i][j] = ok ? sc[i][j] * scale : FA_NEG;
                mx = fmaxf(mx, sc[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            float sum = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(sc[i][j] - m_new);
                sum += p;
                ps[(ty * 4 + i) * PLD + tx + 16 * j] = to_f(from_f<T>(p));
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
            const float alpha = expf(m[i] - m_new);
            l[i] = l[i] * alpha + sum;
            m[i] = m_new;
#pragma unroll
            for (int n = 0; n < NC; ++n) acc[i][n] *= alpha;
        }
        __syncthreads();  // P and V are in shared memory

#pragma unroll 4
        for (int j = 0; j < FA_BK; ++j) {
            float pv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * PLD + j];
#pragma unroll
            for (int n = 0; n < NC; ++n) {
                const float vv = kv[j * LD + tx + 16 * n];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(pv[i], vv, acc[i][n]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float denom = fmaxf(l[i], 1e-30f);
        T* row = o + (slab + q0 + ty * 4 + i) * dh;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
            const int c = tx + 16 * n;
            if (c < dh) row[c] = from_f<T>(acc[i][n] / denom);
        }
    }
}

template <typename T, int DHP>
static int fa_launch(const void* q, const void* k, const void* v, void* o, long long bh,
                     long long s_len, long long dh, long long window, float scale,
                     cudaStream_t st) {
    const size_t shmem = (size_t)(FA_BQ * (DHP + 1) + FA_BK * (DHP + 1) + FA_BQ * (FA_BK + 1)) *
                         sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fa_kernel<T, DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = bh * (s_len / FA_BQ);
    fa_kernel<T, DHP><<<(unsigned)blocks, FA_THREADS, shmem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, (int)s_len, (int)dh, (int)window, scale);
    return (int)cudaGetLastError();
}

template <typename T>
static int fa_dispatch(const void* q, const void* k, const void* v, void* o, long long bh,
                       long long s_len, long long dh, long long window, cudaStream_t st) {
    // the reference's scale: 1/sqrt(dh) in double, rounded once to float
    const float scale = (float)(1.0 / sqrt((double)dh));
    if (dh <= 64) return fa_launch<T, 64>(q, k, v, o, bh, s_len, dh, window, scale, st);
    if (dh <= 128) return fa_launch<T, 128>(q, k, v, o, bh, s_len, dh, window, scale, st);
    return fa_launch<T, 256>(q, k, v, o, bh, s_len, dh, window, scale, st);
}

// q, k, v, o [bh, s_len, dh], all float32 (is_bf16 == 0) or all bf16;
// s_len % 64 == 0, 1 <= dh <= 256; window <= 0 means causal only.
extern "C" int fa_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  long long bh, long long s_len, long long dh, long long window,
                                  long long is_bf16, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (bh == 0 || s_len == 0) return (int)cudaGetLastError();
    if (dh < 1 || dh > 256 || s_len % FA_BQ != 0 || s_len > INT32_MAX ||
        bh * (s_len / FA_BQ) > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    if (is_bf16) return fa_dispatch<__nv_bfloat16>(q, k, v, o, bh, s_len, dh, window, st);
    return fa_dispatch<float>(q, k, v, o, bh, s_len, dh, window, st);
}
