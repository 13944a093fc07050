// Causal, optionally sliding-window, attention with an online softmax over
// [BH, S, dh] bf16 or float32, for Hopper.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   fa_flash_attention  <- _flash_kernel  (flash_attention)
//
// Semantics, as the reference's: scores are q.k accumulated in float32
// times 1/sqrt(dh); key kpos is visible to query qpos when qpos >= kpos and,
// with a window, qpos - kpos < window; masked scores are -1e30 (not -inf);
// m, l and acc are float32; p is rounded to v's type before the P.V product
// and l sums the unrounded p; the output is acc / max(l, 1e-30) in q's type.
// The TPU version walked every KV tile of 128 keys for every query tile as
// its sequential grid dimension, masked ones included.
//
// What bounds it on the H100: the operations. A visible (q, k) pair costs
// 4 * dh flops (two products of dh), so at recurrentgemma-9b's local
// attention ([16, 4096, 256] bf16, window 2048) the 1.0e11 flops take
// 0.104 ms at the 989 TFLOP/s of the bf16 tensor cores, and its 134 MB of
// q, k, v and o 0.040 ms at 3.35 TB/s.
//
// bf16 (fa_tc_kernel): tensor cores, fed by TMA. One block of three
// warpgroups per (bh, 128-query tile), the heaviest tiles of the causal
// triangle launched first. Warpgroup 2 produces: one thread loads the
// block's Q once and then the K and V tiles of 64 keys x dh through TMA
// into a ring of ST stages in shared memory, each stage guarded by a
// "full" mbarrier (the TMA's bytes) and an "empty" one (the 8 consumer
// warps' arrivals). Warpgroups 0 and 1 consume, 64 query rows each: per
// tile S = Q K^T by wgmma m64n64k16 (Q and K from shared memory, K-major,
// 128-byte swizzle as TMA writes it), the mask in registers on tiles that
// cross the diagonal or the window's edge, the online softmax in
// registers (each row's max and sum reduced over the 4 lanes that hold
// it), p rounded to bf16 in registers, which is already the layout of
// wgmma's A operand, and O += P V by wgmma with P from registers and V
// from shared memory as a transposed (N-major) B. A tile that holds no
// visible key for a warpgroup's rows is skipped by that warpgroup, as by
// the CUDA-core kernel (a skipped tile would add exactly nothing, or sums
// that alpha = 0 wipes later). The producer hands its registers to the
// consumers (setmaxnreg 40 / 232): at dh 256 a consumer thread holds 128
// floats of O. Head widths go in tiers of 64, 128 and 256 (a TMA box is 64
// columns, one 128-byte swizzle row); a row of dh < tier reads zeros past
// its end (the TMA's out-of-bounds fill). TMA needs rows of a multiple of
// 16 bytes, so for dh % 8 != 0 the wrapper pads q, k and v with zero
// columns to the tier and passes the real dh for the scale. The tensor
// maps are encoded on the host by cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library needs no -lcuda. Left for later:
// each warpgroup runs S, softmax and P V one after another, with no
// overlap of one tile's softmax with the next tile's products (the two
// warpgroups overlap each other); N = 64 products read Q from shared memory
// for every tile; O is stored from registers, not by TMA.
//
// float32 (fa_kernel): tensor cores cannot hold float32's
// rtol of 1e-5 without emulation, so float32 stays on CUDA cores: one
// block of 256 threads per (bh, 64-query tile), the query tile staged once
// in shared memory as float32, then for each 64-key tile that holds a
// visible key for some row of the block, K staged, a 4 x 4 block of scores
// per thread from shared memory, V over K in the same buffer, the online
// softmax in registers, P through shared memory, and P.V into 4 rows x
// dh/16 columns of acc per thread in registers. Rows are padded to DHP + 1
// floats (DHP the width tier), so the column reads of a warp fall in
// distinct banks. Its 49-148 KB of shared memory is above the 48 KB a
// launch gets by default, so every launch first raises the kernel's
// dynamic limit, as the bf16 launch does.
//
// Built without fast math: expf is the accurate one and '/' is IEEE.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
#define FA_NEG (-1e30f)
static_assert(FA_BQ == FA_BK, "stage() fills query and key tiles alike");

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

// rows [0, FA_BQ) of a [rows, dh] slab into a [FA_BQ, DHP + 1] float tile
template <int DHP>
__device__ __forceinline__ void stage(const float* __restrict__ src, int dh, float* dst) {
    for (int e = threadIdx.x; e < FA_BQ * DHP; e += FA_THREADS) {
        const int r = e / DHP, c = e % DHP;
        dst[r * (DHP + 1) + c] = c < dh ? src[(long long)r * dh + c] : 0.0f;
    }
}

template <int DHP>
__global__ void __launch_bounds__(FA_THREADS)
fa_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          float* __restrict__ o, int s_len, int dh, int window, float scale) {
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

    stage<DHP>(q + (slab + q0) * dh, dh, qs);
    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const int k0 = kt * FA_BK;
        __syncthreads();  // the last tile's P.V has read kv and ps
        stage<DHP>(k + (slab + k0) * dh, dh, kv);
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
        stage<DHP>(v + (slab + k0) * dh, dh, kv);

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
                ps[(ty * 4 + i) * PLD + tx + 16 * j] = p;
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
        float* row = o + (slab + q0 + ty * 4 + i) * dh;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
            const int c = tx + 16 * n;
            if (c < dh) row[c] = acc[i][n] / denom;
        }
    }
}

template <int DHP>
static int fa_launch(const void* q, const void* k, const void* v, void* o, long long bh,
                     long long s_len, long long dh, long long window, float scale,
                     cudaStream_t st) {
    const size_t shmem = (size_t)(FA_BQ * (DHP + 1) + FA_BK * (DHP + 1) + FA_BQ * (FA_BK + 1)) *
                         sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fa_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = bh * (s_len / FA_BQ);
    fa_kernel<DHP><<<(unsigned)blocks, FA_THREADS, shmem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, (int)s_len, (int)dh,
        (int)window, scale);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), tiles through TMA
// ---------------------------------------------------------------------------

#define TC_BQ 128      // query rows of a block: two consumer warpgroups of 64
#define TC_BK 64       // keys of a tile (BLOCK_K of the plain version)
#define TC_BOX 64      // bf16 columns of a TMA box: one 128-byte swizzle row
#define TC_THREADS 384 // warpgroups 0 and 1 consume, 2 produces
#define TC_CONSUMER_WARPS 8

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    }
}

// box (c0 = column, c1 = row) of a 2-D tensor map into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
        "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(bar)
        : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1
// (SWIZZLE_128B). K-major: rows of 128 bytes, 8-row groups 1,024 bytes
// apart (stride), the leading offset unused. N-major: stride = the 8-row
// groups along K, leading = the 64-column groups along N.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
           ((uint64_t)(stride >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from touching accumulators across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B over one m64n64k16 step, A and B in shared memory (K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B over one m64n64k16 step, A in registers (four bf16 pairs a
// thread), B in shared memory with N contiguous (transposed)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// shared memory of fa_tc_kernel<D, ST>, in bytes from a 1,024-aligned base
template <int D, int ST>
struct TcSmem {
    static constexpr int NB = D / TC_BOX;              // boxes across a row
    static constexpr int Q_BOX = TC_BQ * 128;          // one box of the Q tile
    static constexpr int KV_BOX = TC_BK * 128;         // one box of a K or V tile
    static constexpr int KV_BYTES = NB * KV_BOX;
    static constexpr int K_OFF = NB * Q_BOX;
    static constexpr int V_OFF = K_OFF + ST * KV_BYTES;
    static constexpr int BAR_OFF = V_OFF + ST * KV_BYTES;
    static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * ST) + 1024;  // + alignment slack
};

template <int D, int ST>
__global__ void __launch_bounds__(TC_THREADS, 1)
fa_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int n_bh,
             int s_len, int dh, int window, float scale) {
    using L = TcSmem<D, ST>;
    constexpr int NB = L::NB;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t sq = base, sk = base + L::K_OFF, sv = base + L::V_OFF;
    const uint32_t bar_q = base + L::BAR_OFF;
    const uint32_t bar_full = bar_q + 8, bar_empty = bar_q + 8 * (1 + ST);

    // the heaviest query tiles of the causal triangle first
    const int n_q = s_len / TC_BQ;
    const int q0 = (n_q - 1 - (int)blockIdx.x / n_bh) * TC_BQ;
    const long long row0 = (long long)((int)blockIdx.x % n_bh) * s_len;
    // key tiles holding a visible key for some row of the block
    int kt_lo = 0;
    if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / TC_BK;
    const int n_tiles = (q0 + TC_BQ - 1) / TC_BK - kt_lo + 1;

    if (threadIdx.x == 0) {
        mbar_init(bar_q, 1);
        for (int s = 0; s < ST; ++s) {
            mbar_init(bar_full + 8 * s, 1);
            mbar_init(bar_empty + 8 * s, TC_CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 2) {  // producer
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (threadIdx.x == 256) {
            mbar_expect_tx(bar_q, NB * L::Q_BOX);
            for (int b = 0; b < NB; ++b)
                tma_load(sq + b * L::Q_BOX, &tq, b * TC_BOX, (int)(row0 + q0), bar_q);
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % ST;
                mbar_wait(bar_empty + 8 * s, ((i / ST) & 1) ^ 1);
                mbar_expect_tx(bar_full + 8 * s, 2 * L::KV_BYTES);
                const int r = (int)(row0 + (kt_lo + i) * TC_BK);
                for (int b = 0; b < NB; ++b) {
                    tma_load(sk + s * L::KV_BYTES + b * L::KV_BOX, &tk, b * TC_BOX, r,
                             bar_full + 8 * s);
                    tma_load(sv + s * L::KV_BYTES + b * L::KV_BOX, &tv, b * TC_BOX, r,
                             bar_full + 8 * s);
                }
            }
        }
        return;
    }

    // consumers: warpgroup wg owns rows r0 .. r0 + 63; this thread rows
    // row_a and row_b = row_a + 8 of them (the wgmma accumulator layout)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int r0 = q0 + wg * 64;
    const int row_a = r0 + warp * 16 + g, row_b = row_a + 8;
    int my_lo = 0;
    if (window > 0 && r0 - window + 1 > 0) my_lo = (r0 - window + 1) / TC_BK;
    const int my_hi = (r0 + 63) / TC_BK;
    const uint32_t q_wg = sq + wg * 64 * 128;  // this warpgroup's rows of each Q box

    float acc[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[nb][e] = 0.0f;
    float m_a = FA_NEG, m_b = FA_NEG, l_a = 0.0f, l_b = 0.0f;

    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
        const int kt = kt_lo + i, s = i % ST;
        mbar_wait(bar_full + 8 * s, (i / ST) & 1);
        if (kt >= my_lo && kt <= my_hi) {
            const uint32_t k_st = sk + s * L::KV_BYTES, v_st = sv + s * L::KV_BYTES;
            // S = Q K^T over dh in steps of 16: 4 steps per 128-byte box
            float sc[32];
#pragma unroll
            for (int e = 0; e < 32; ++e) sc[e] = 0.0f;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const uint32_t col = (kk % 4) * 32;
                wgmma_ss(sc, sw128_desc(q_wg + (kk / 4) * L::Q_BOX + col, 16, 1024),
                         sw128_desc(k_st + (kk / 4) * L::KV_BOX + col, 16, 1024), 1);
            }
            wgmma_commit();
            wgmma_wait0();
            fence_regs(sc);

            // scale, mask, and the online softmax; sc[4j + e] is key
            // 8j + 2 t4 + (e & 1) of row_a (e < 2) or row_b (e >= 2)
            const int k0 = kt * TC_BK;
            const bool edge =
                !(k0 + TC_BK - 1 <= r0 && (window <= 0 || k0 >= r0 + 63 - window + 1));
            float mx_a = FA_NEG, mx_b = FA_NEG;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
                    const int qpos = e < 2 ? row_a : row_b;
                    float x = sc[4 * j + e] * scale;
                    if (edge && !(qpos >= kpos && (window <= 0 || qpos - kpos < window)))
                        x = FA_NEG;
                    sc[4 * j + e] = x;
                    if (e < 2)
                        mx_a = fmaxf(mx_a, x);
                    else
                        mx_b = fmaxf(mx_b, x);
                }
            }
            const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
            // p as bf16 pairs: pk[4 kk .. 4 kk + 3] is the A operand of keys
            // 16 kk .. 16 kk + 15
            uint32_t pk[16];
            float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float p0 = expf(sc[4 * j] - mn_a), p1 = expf(sc[4 * j + 1] - mn_a);
                const float p2 = expf(sc[4 * j + 2] - mn_b), p3 = expf(sc[4 * j + 3] - mn_b);
                sum_a += p0 + p1;
                sum_b += p2 + p3;
                pk[2 * j] = pack_bf16(p0, p1);
                pk[2 * j + 1] = pack_bf16(p2, p3);
            }
            const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
            l_a = l_a * al_a + quad_sum(sum_a);
            l_b = l_b * al_b + quad_sum(sum_b);
            m_a = mn_a;
            m_b = mn_b;
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    acc[nb][4 * j] *= al_a;
                    acc[nb][4 * j + 1] *= al_a;
                    acc[nb][4 * j + 2] *= al_b;
                    acc[nb][4 * j + 3] *= al_b;
                }

            // O += P V: V's 64 x 64 boxes are N-major; 16 keys = 2,048 bytes
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < TC_BK / 16; ++kk)
#pragma unroll
                for (int nb = 0; nb < NB; ++nb)
                    wgmma_rs_tb(acc[nb], pk + 4 * kk,
                                sw128_desc(v_st + nb * L::KV_BOX + kk * 2048, L::KV_BOX, 1024));
            wgmma_commit();
            wgmma_wait0();
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }

    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    __nv_bfloat16* out_a = o + (row0 + row_a) * dh;
    __nv_bfloat16* out_b = o + (row0 + row_b) * dh;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = nb * TC_BOX + 8 * j + 2 * t4;  // dh is even: c < dh covers c + 1
            if (c < dh) {
                *reinterpret_cast<__nv_bfloat162*>(out_a + c) =
                    __floats2bfloat162_rn(acc[nb][4 * j] / den_a, acc[nb][4 * j + 1] / den_a);
                *reinterpret_cast<__nv_bfloat162*>(out_b + c) =
                    __floats2bfloat162_rn(acc[nb][4 * j + 2] / den_b, acc[nb][4 * j + 3] / den_b);
            }
        }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
                cudaSuccess &&
            found == cudaDriverEntryPointSuccess)
            fn = (EncodeTiled)p;
    }
    return fn;
}

// [rows, dh] bf16 rows in boxes of box_rows x 64 columns, 128-byte swizzle;
// columns past dh read as zeros
static bool tensor_map(CUtensorMap* map, const void* ptr, long long rows, long long dh,
                       int box_rows) {
    EncodeTiled enc = encoder();
    if (enc == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)dh, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)dh * 2};
    const cuuint32_t box[2] = {TC_BOX, (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int ST>
static int tc_launch(const void* q, const void* k, const void* v, void* o, long long bh,
                     long long s_len, long long dh, long long window, float scale,
                     cudaStream_t st) {
    using L = TcSmem<D, ST>;
    CUtensorMap tq, tk, tv;
    const long long rows = bh * s_len;
    if (!tensor_map(&tq, q, rows, dh, TC_BQ) || !tensor_map(&tk, k, rows, dh, TC_BK) ||
        !tensor_map(&tv, v, rows, dh, TC_BK))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fa_tc_kernel<D, ST>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return (int)err;
    fa_tc_kernel<D, ST><<<(unsigned)(bh * (s_len / TC_BQ)), TC_THREADS, L::BYTES, st>>>(
        tq, tk, tv, (__nv_bfloat16*)o, (int)bh, (int)s_len, (int)dh, (int)window, scale);
    return (int)cudaGetLastError();
}

// q, k, v, o [bh, s_len, dh], all float32 (is_bf16 == 0) or all bf16;
// s_len % 128 == 0, 1 <= dh <= 256, and for bf16 dh % 8 == 0 (a TMA row is
// a multiple of 16 bytes); window <= 0 means causal only; the scale is
// 1/sqrt(scale_dh) (scale_dh < dh where the caller padded the rows).
extern "C" int fa_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  long long bh, long long s_len, long long dh, long long window,
                                  long long is_bf16, long long scale_dh, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (bh == 0 || s_len == 0) return (int)cudaGetLastError();
    if (dh < 1 || dh > 256 || scale_dh < 1 || scale_dh > dh || s_len % TC_BQ != 0 ||
        bh * s_len > INT32_MAX || (is_bf16 && dh % 8 != 0))
        return (int)cudaErrorInvalidValue;
    // the reference's scale: 1/sqrt(dh) in double, rounded once to float
    const float scale = (float)(1.0 / sqrt((double)scale_dh));
    if (is_bf16) {
        if (dh <= 64) return tc_launch<64, 4>(q, k, v, o, bh, s_len, dh, window, scale, st);
        if (dh <= 128) return tc_launch<128, 3>(q, k, v, o, bh, s_len, dh, window, scale, st);
        return tc_launch<256, 2>(q, k, v, o, bh, s_len, dh, window, scale, st);
    }
    if (dh <= 64) return fa_launch<64>(q, k, v, o, bh, s_len, dh, window, scale, st);
    if (dh <= 128) return fa_launch<128>(q, k, v, o, bh, s_len, dh, window, scale, st);
    return fa_launch<256>(q, k, v, o, bh, s_len, dh, window, scale, st);
}
