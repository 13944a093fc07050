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
// (in float32, not rounded) and l sums the unrounded p; the output is acc / max(l, 1e-30) in q's type.
// The TPU version walked every KV tile of 128 keys for every query tile as
// its sequential grid dimension, masked ones included.
//
// What bounds it on the H100: the operations. A visible (q, k) pair costs
// 4 * dh flops (two products of dh), so at recurrentgemma-9b's local
// attention ([16, 4096, 256] bf16, window 2048) the 1.0e11 flops take
// 0.104 ms at the 989 TFLOP/s of the bf16 tensor cores, and its 134 MB of
// q, k, v and o 0.040 ms at 3.35 TB/s. In float32 the fastest rate that
// holds float32's accuracy is three TF32 products at 494.7 TFLOP/s, so
// 164.9 TFLOP/s: starcoder2-7b's causal [36, 4096, 128] (1.55e11 flops)
// takes at least 0.94 ms.
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
// visible key for a warpgroup's rows is skipped by that warpgroup (a
// skipped tile would add exactly nothing, or sums that alpha = 0 wipes
// later). The producer hands its registers to the
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
// float32 (fa_tf32x3_kernel): tensor cores too, float32 emulated by three
// TF32 products. A TF32 product alone keeps 10 mantissa bits and misses
// float32's rtol of 1e-5 by some 10x at these widths. So each operand x is
// split as it is loaded from shared memory into x_hi = tf32(x), rounded to
// nearest (ties away, the value cvt.rna gives a finite x), and x_lo = x -
// x_hi (exact in float32), and a.b is taken as a_hi.b_lo + a_lo.b_hi +
// a_hi.b_hi, the two small terms accumulated before the large one;
// a_lo.b_lo, at most 2^-22 |a| |b|, is left out. x_lo goes to the tensor
// core as it is, which reads its top 19 bits (a truncation to TF32, at most
// 2^-21 |x| off). Rounding with two integer operations, and letting the
// tensor core truncate x_lo, costs 3 instructions a split; ptxas emulates
// cvt.rna with compares and selects around it, and two of them a split
// made the kernel markedly slower at the same largest error. Both products
// are split so: q and k for S, p and v for O (p unrounded, as float32
// asks). The products are warp-level mma.sync m16n8k8 (TF32 in, float32
// accumulators); the operands are split in registers, not in shared
// memory, which would double the tiles' bytes and their shared loads,
// and the splits are the kernel's main cost besides the products. One
// block of NW warps per (bh, 16 NW-query tile), the heaviest
// causal tiles first; each warp owns 16 query rows. The block stages its
// Q tile once and double-buffers K and V tiles of BK keys with cp.async,
// so the next tile's copy overlaps this tile's products. Tiers (dh, NW,
// BK): (64, 4, 64), (128, 8, 64), (256, 4, 32), at 94, 210 and 201 KB of
// shared memory; columns past dh are zero-filled by the copy (dh % 8 == 0;
// the wrapper pads other widths to the tier). A warp skips the tiles that
// hold no visible key for its rows and masks only tiles that cross the
// diagonal or the window's edge, as the bf16 kernel does. The reduction
// dimension of a product may be walked in any order, so each thread loads
// 16 bytes at once: for S, elements 4t .. 4t + 3 of a 16-column step give
// the k-slots t and t + 4 of two k-steps; for O, the k-slots t and t + 4
// are keys 2t and 2t + 1, which is where the accumulator layout of S
// already holds p, so P goes from S to the A operand in place, with no
// trip through shared memory; and the 8 columns of V an n-tile reads are
// spread over four n-tiles, so V's fragments are 16-byte loads too and a
// thread's outputs are 8 consecutive columns. Rows of Q and K are padded
// to dh + 16 floats and rows of V to dh + 4, so the 16-byte loads of each
// quarter warp fall in distinct banks. Left for later: wgmma (it takes
// TF32 only K-major from shared memory, so V would be transposed first).
//
// Built without fast math: expf is the accurate one and '/' is IEEE.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FA_NEG (-1e30f)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// float32: tensor cores, three TF32 products (mma.sync)
// ---------------------------------------------------------------------------

// 16 bytes from global to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna rounds a finite x), lo the exact rest, which the tensor core
// truncates to TF32 as it reads it
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += A B, A 16 x 8 (row), B 8 x 8 (col), TF32 in, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in three products, a_hi.b_lo + a_lo.b_hi, then a_hi.b_hi; both
// operands come split (each is reused over other fragments)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bl0,
                                           uint32_t bh1, uint32_t bl1) {
    mma_tf32(d, ah, bl0, bl1);
    mma_tf32(d, al, bh0, bh1);
    mma_tf32(d, ah, bh0, bh1);
}

// shared memory of fa_tf32x3_kernel<D, NW, BK>, in floats: the Q tile, then
// two stages of K, then two of V
template <int D, int NW, int BK>
struct F32Smem {
    static constexpr int BQ = 16 * NW;
    static constexpr int LDK = D + 16;  // rows of Q and K
    static constexpr int LDV = D + 4;   // rows of V
    static constexpr int Q_FLOATS = BQ * LDK;
    static constexpr int K_FLOATS = BK * LDK;
    static constexpr int V_FLOATS = BK * LDV;
    static constexpr int BYTES = 4 * (Q_FLOATS + 2 * (K_FLOATS + V_FLOATS));
};

// rows [0, ROWS) of a [rows, dh] slab into a [ROWS, LD] tile, columns past
// dh (a multiple of 4) zero-filled; asynchronous (cp.async)
template <int ROWS, int D, int LD, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int dh) {
    constexpr int CH = D / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < ROWS * CH; e += NT) {
        const int r = e / CH, c = (e % CH) * 4;
        const bool in = c < dh;
        cp_async16(dst + r * LD + c, in ? src + (long long)r * dh + c : src, in ? 16 : 0);
    }
}

__device__ __forceinline__ float4 lds128(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

template <int D, int NW, int BK>
__global__ void __launch_bounds__(32 * NW, 1)
fa_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int n_bh, int s_len, int dh,
                 int window, float scale) {
    using L = F32Smem<D, NW, BK>;
    constexpr int BQ = L::BQ, NT = 32 * NW, NJ = BK / 8, NO = D / 8;
    static_assert(D % 32 == 0 && BK % 8 == 0, "n-tiles of V come in fours, keys in eights");
    extern __shared__ float4 smem_f4[];
    float* qs = reinterpret_cast<float*>(smem_f4);
    float* ks = qs + L::Q_FLOATS;
    float* vs = ks + 2 * L::K_FLOATS;

    // the heaviest query tiles of the causal triangle first
    const int n_q = s_len / BQ;
    const int q0 = (n_q - 1 - (int)blockIdx.x / n_bh) * BQ;
    const long long slab = (long long)((int)blockIdx.x % n_bh) * s_len;
    // key tiles holding a visible key for some row of the block
    int kt_lo = 0;
    if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BK;
    const int n_tiles = (q0 + BQ - 1) / BK - kt_lo + 1;

    load_rows<BQ, D, L::LDK, NT>(qs, q + (slab + q0) * dh, dh);
    load_rows<BK, D, L::LDK, NT>(ks, k + (slab + (long long)kt_lo * BK) * dh, dh);
    load_rows<BK, D, L::LDV, NT>(vs, v + (slab + (long long)kt_lo * BK) * dh, dh);
    cp_async_commit();

    // this warp's rows r0 .. r0 + 15; this thread rows row_a and row_b =
    // row_a + 8 of them (the mma accumulator layout: g = lane / 4 the row,
    // t = lane % 4 the column pair)
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = q0 + 16 * warp;
    const int row_a = r0 + g, row_b = row_a + 8;
    int my_lo = 0;
    if (window > 0 && r0 - window + 1 > 0) my_lo = (r0 - window + 1) / BK;
    const int my_hi = (r0 + 15) / BK;
    const float* q_a = qs + (16 * warp + g) * L::LDK + 4 * t;
    const float* q_b = q_a + 8 * L::LDK;

    float acc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    float m_a = FA_NEG, m_b = FA_NEG, l_a = 0.0f, l_b = 0.0f;

    for (int i = 0; i < n_tiles; ++i) {
        const int kt = kt_lo + i, st = i & 1;
        if (i + 1 < n_tiles) {  // the next tile into the other stage
            const long long r = slab + (long long)(kt + 1) * BK;
            load_rows<BK, D, L::LDK, NT>(ks + (st ^ 1) * L::K_FLOATS, k + r * dh, dh);
            load_rows<BK, D, L::LDV, NT>(vs + (st ^ 1) * L::V_FLOATS, v + r * dh, dh);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (kt >= my_lo && kt <= my_hi) {
            const float* k_st = ks + st * L::K_FLOATS + g * L::LDK + 4 * t;
            const float* v_st = vs + st * L::V_FLOATS + 2 * t * L::LDV + 4 * g;

            // S = Q K^T: per 16 columns, elements 4t .. 4t + 3 of a thread's
            // rows give k-slots (t, t + 4) of two k-steps
            float sc[NJ][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
            for (int c = 0; c < D; c += 16) {
                const float4 xa = lds128(q_a + c), xb = lds128(q_b + c);
                uint32_t ah0[4], al0[4], ah1[4], al1[4];
                split_tf32(xa.x, ah0[0], al0[0]);
                split_tf32(xb.x, ah0[1], al0[1]);
                split_tf32(xa.y, ah0[2], al0[2]);
                split_tf32(xb.y, ah0[3], al0[3]);
                split_tf32(xa.z, ah1[0], al1[0]);
                split_tf32(xb.z, ah1[1], al1[1]);
                split_tf32(xa.w, ah1[2], al1[2]);
                split_tf32(xb.w, ah1[3], al1[3]);
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    const float4 kk = lds128(k_st + 8 * j * L::LDK + c);
                    uint32_t bh[4], bl[4];
                    split_tf32(kk.x, bh[0], bl[0]);
                    split_tf32(kk.y, bh[1], bl[1]);
                    split_tf32(kk.z, bh[2], bl[2]);
                    split_tf32(kk.w, bh[3], bl[3]);
                    mma_3xtf32(sc[j], ah0, al0, bh[0], bl[0], bh[1], bl[1]);
                    mma_3xtf32(sc[j], ah1, al1, bh[2], bl[2], bh[3], bl[3]);
                }
            }

            // scale, mask, and the online softmax; sc[j] holds keys
            // 8j + 2t (+1) of row_a (e < 2) and row_b (e >= 2)
            const int k0 = kt * BK;
            const bool edge = !(k0 + BK - 1 <= r0 && (window <= 0 || k0 >= r0 + 15 - window + 1));
            float mx_a = FA_NEG, mx_b = FA_NEG;
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int kpos = k0 + 8 * j + 2 * t + (e & 1);
                    const int qpos = e < 2 ? row_a : row_b;
                    float x = sc[j][e] * scale;
                    if (edge && !(qpos >= kpos && (window <= 0 || qpos - kpos < window)))
                        x = FA_NEG;
                    sc[j][e] = x;
                    if (e < 2)
                        mx_a = fmaxf(mx_a, x);
                    else
                        mx_b = fmaxf(mx_b, x);
                }
            const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
            float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                sc[j][0] = expf(sc[j][0] - mn_a);
                sc[j][1] = expf(sc[j][1] - mn_a);
                sc[j][2] = expf(sc[j][2] - mn_b);
                sc[j][3] = expf(sc[j][3] - mn_b);
                sum_a += sc[j][0] + sc[j][1];
                sum_b += sc[j][2] + sc[j][3];
            }
            const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
            l_a = l_a * al_a + quad_sum(sum_a);
            l_b = l_b * al_b + quad_sum(sum_b);
            m_a = mn_a;
            m_b = mn_b;
#pragma unroll
            for (int n = 0; n < NO; ++n) {
                acc[n][0] *= al_a;
                acc[n][1] *= al_a;
                acc[n][2] *= al_b;
                acc[n][3] *= al_b;
            }

            // O += P V: k-step j is keys 8j .. 8j + 7, slots (t, t + 4) keys
            // (2t, 2t + 1), which sc[j] holds as (c0, c1) of row_a and (c2,
            // c3) of row_b; n-tile 4J + n column g is output column 32J +
            // 4g + n, so a 16-byte load of V feeds four n-tiles
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                uint32_t ph[4], pl[4];
                split_tf32(sc[j][0], ph[0], pl[0]);
                split_tf32(sc[j][2], ph[1], pl[1]);
                split_tf32(sc[j][1], ph[2], pl[2]);
                split_tf32(sc[j][3], ph[3], pl[3]);
                const float* v_j = v_st + 8 * j * L::LDV;
#pragma unroll
                for (int J = 0; J < D / 32; ++J) {
                    const float4 v0 = lds128(v_j + 32 * J), v1 = lds128(v_j + L::LDV + 32 * J);
                    const float x0[4] = {v0.x, v0.y, v0.z, v0.w};
                    const float x1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
                    for (int n = 0; n < 4; ++n) {
                        uint32_t bh0, bl0, bh1, bl1;
                        split_tf32(x0[n], bh0, bl0);
                        split_tf32(x1[n], bh1, bl1);
                        mma_3xtf32(acc[4 * J + n], ph, pl, bh0, bl0, bh1, bl1);
                    }
                }
            }
        }
        __syncthreads();  // every warp is done with this stage before it is refilled
    }

    // this thread's columns of a row: 32J + 8t .. 32J + 8t + 7 (dh % 8 == 0)
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    float* out_a = o + (slab + row_a) * dh;
    float* out_b = o + (slab + row_b) * dh;
#pragma unroll
    for (int J = 0; J < D / 32; ++J) {
        const int c = 32 * J + 8 * t;
        if (c < dh) {
            const float(&a0)[4] = acc[4 * J];
            const float(&a1)[4] = acc[4 * J + 1];
            const float(&a2)[4] = acc[4 * J + 2];
            const float(&a3)[4] = acc[4 * J + 3];
            *reinterpret_cast<float4*>(out_a + c) =
                make_float4(a0[0] / den_a, a1[0] / den_a, a2[0] / den_a, a3[0] / den_a);
            *reinterpret_cast<float4*>(out_a + c + 4) =
                make_float4(a0[1] / den_a, a1[1] / den_a, a2[1] / den_a, a3[1] / den_a);
            *reinterpret_cast<float4*>(out_b + c) =
                make_float4(a0[2] / den_b, a1[2] / den_b, a2[2] / den_b, a3[2] / den_b);
            *reinterpret_cast<float4*>(out_b + c + 4) =
                make_float4(a0[3] / den_b, a1[3] / den_b, a2[3] / den_b, a3[3] / den_b);
        }
    }
}

template <int D, int NW, int BK>
static int f32_launch(const void* q, const void* k, const void* v, void* o, long long bh,
                      long long s_len, long long dh, long long window, float scale,
                      cudaStream_t st) {
    using L = F32Smem<D, NW, BK>;
    cudaError_t err = cudaFuncSetAttribute(
        fa_tf32x3_kernel<D, NW, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return (int)err;
    fa_tf32x3_kernel<D, NW, BK><<<(unsigned)(bh * (s_len / L::BQ)), 32 * NW, L::BYTES, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, (int)bh, (int)s_len, (int)dh,
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
// s_len % 128 == 0, 1 <= dh <= 256, dh % 8 == 0 (a bf16 TMA row is a
// multiple of 16 bytes, a float32 row a whole number of 16-byte copies and
// output stores); window <= 0 means causal only; the scale is
// 1/sqrt(scale_dh) (scale_dh < dh where the caller padded the rows).
extern "C" int fa_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  long long bh, long long s_len, long long dh, long long window,
                                  long long is_bf16, long long scale_dh, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (bh == 0 || s_len == 0) return (int)cudaGetLastError();
    if (dh < 1 || dh > 256 || scale_dh < 1 || scale_dh > dh || s_len % TC_BQ != 0 ||
        bh * s_len > INT32_MAX || dh % 8 != 0)
        return (int)cudaErrorInvalidValue;
    // TMA (bf16) and the 16-byte cp.async copies (float32) need each base
    // address on a 16-byte boundary
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    // the reference's scale: 1/sqrt(dh) in double, rounded once to float
    const float scale = (float)(1.0 / sqrt((double)scale_dh));
    if (is_bf16) {
        if (dh <= 64) return tc_launch<64, 4>(q, k, v, o, bh, s_len, dh, window, scale, st);
        if (dh <= 128) return tc_launch<128, 3>(q, k, v, o, bh, s_len, dh, window, scale, st);
        return tc_launch<256, 2>(q, k, v, o, bh, s_len, dh, window, scale, st);
    }
    if (dh <= 64) return f32_launch<64, 4, 64>(q, k, v, o, bh, s_len, dh, window, scale, st);
    if (dh <= 128) return f32_launch<128, 8, 64>(q, k, v, o, bh, s_len, dh, window, scale, st);
    return f32_launch<256, 4, 32>(q, k, v, o, bh, s_len, dh, window, scale, st);
}
