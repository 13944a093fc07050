// Fused morsel stage chain for Hopper: one launch runs a morsel's whole
// packed stage chain — bounded linear probe -> entry lookup -> lens word
// translation -> compiled grants -> AND into the ownership words ->
// interval stage filters, for every stage in turn — then the build sink's
// word translation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_chain.py
// _build_kernel (launched by _chain_fn). The TPU version is specialised and
// compiled once per chain spec; compiling a CUDA kernel per spec at run time
// would cost an nvcc call per new wave shape, so this is ONE generic kernel
// that reads the spec from a small descriptor and walks the stages with
// runtime loop bounds.
//
// What bounds it on the H100: at the engine's sizes (65,536 rows), neither
// bytes nor operations but latency — per row a chain of dependent gathers
// (key, probe slots, entry id, two-half lens word, byte-lane tables) — and,
// around the kernel, the host's work per launch. The design:
//   * launch: the argument block travels by value, as a __grid_constant__
//     kernel parameter, so nothing is copied to the device before the
//     launch and nothing waits; the caller's stats and slot counters are
//     zeroed by cudaMemsetAsync in the same C call;
//   * grid: persistent, as many 256-row tiles at once as the card holds
//     blocks, each block striding over the tiles;
//   * counts: per stage (alive, matched, matched-visible) and the 64 slot
//     counts come from warp ballots and __popc, into shared counters (the
//     slot counts in registers, lane j counting bit j), and each block adds
//     its non-zero counters to the outputs once, at its end. Integer sums
//     are exact in any order, so the outputs keep their bits;
//   * tables: the 8 x 256 byte-lane translation tables (16 KB per lo/hi
//     pair) are read through the read-only path and stay in L1. Staging
//     them in shared memory by cp.async, once per block, was slower on the
//     card at the engine's sizes, most of all on chains with a sink: a
//     block loads a pair for each stage and two for the sink, for 256 rows.
// Every intermediate stays in registers; of a stage only its entry ids are
// written, and each chain walk ends at its first hit or EMPTY slot.
//
// Argument block (int64, host memory, passed by address to fc_chain):
//   [D, n_in, desc[D], in_ptr[n_in], out_ptr[...]]
//   desc = [n_stages, sink, then per stage: key_mode, n_grants, grant_attrs,
//           table_capacity, n_members (-1: no filter), n_fattrs,
//           fattr_src[n_fattrs]]
//   in_ptr follows repro_torch.kernels.fused_chain.input_kinds(spec).
//   out_ptr = bits_lo, bits_hi, entry[s] per stage, stats[S,3], slots[64],
//             then for a sink: vis_lo, vis_hi, em_lo, em_hi.
// Every uint64 word is a (lo, hi) pair of 32-bit halves, as in the
// reference. float64 bounds arrive total-order encoded as (hi, lo) pairs,
// so unsigned lexicographic compares reproduce IEEE >= / <= exactly.
//
// Size of the by-value block. A stage takes 6 + F descriptor words and
// 7 + (G ? 7 + 2 G : 0) + (filter ? 2 F + 4 : 0) input pointers and one
// output pointer (G grant attrs, F filter attrs); the chain adds 2 + 2
// header words, 2 + 4 input and 8 output pointers. So a block holds
// 18 + sum_s (25 + 2 G_s + 3 F_s) words at most. The engine's stages are
// the joins of one pipeline and G_s, F_s count attributes of its tables:
// FC_MAX_STAGES = 32 stages with G_s = F_s = 16 (a TPC-H table has at most
// 16 columns) take 18 + 32 * 105 = 3,378 words, under FC_MAX_WORDS = 4,032
// (32,256 bytes; with the 280-byte head, 32,536 of the 32,764 bytes of
// kernel parameters that sm_90 takes from CUDA 12.1 on). A block that
// does not fit is refused here and raises in the wrapper. Blocks of up to
// FC_SMALL_WORDS words (every TPC-H chain of the tests) launch a 2 KB
// instance: a launch copies the whole struct, and one of 32 KB took
// longer to launch on the card.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define EMPTY_KEY (-0x7FFFFFFF)
#define MAX_PROBE 16
#define MULT 2654435761u
#define FC_ROWS 256
#define FC_MAX_STAGES 32
#define FC_SMALL_WORDS 224
#define FC_MAX_WORDS 4032
#define FULL_MASK 0xFFFFFFFFu

struct ChainHead {
    int n_rows;
    int n_tiles;
    int n_stages;
    int sink;
    int dbase[FC_MAX_STAGES];      // descriptor index of stage s
    int pbase[FC_MAX_STAGES + 1];  // input pointer index of stage s; [n_stages]: the sink's
    int obase;                     // index of the first output pointer in w
};

template <int W>
struct ChainArgs {
    ChainHead h;
    long long w[W];  // the argument block
};
static_assert(sizeof(ChainArgs<FC_MAX_WORDS>) <= 32764, "kernel parameters exceed sm_90's limit");

__device__ __forceinline__ bool ge(uint32_t xh, uint32_t xl, uint32_t bh, uint32_t bl) {
    return (xh > bh) || (xh == bh && xl >= bl);
}

__device__ __forceinline__ bool le(uint32_t xh, uint32_t xl, uint32_t bh, uint32_t bl) {
    return (xh < bh) || (xh == bh && xl <= bl);
}

template <typename T>
__device__ __forceinline__ const T* ptr(long long p) {
    return reinterpret_cast<const T*>(p);
}

// core.visibility.translate_bits on (lo, hi) halves: OR the split [8,256]
// byte-lane tables over every byte of the word.
__device__ __forceinline__ void translate(uint32_t wl, uint32_t wh, long long tlo_p,
                                          long long thi_p, uint32_t& olo, uint32_t& ohi) {
    const uint32_t* tlo = ptr<uint32_t>(tlo_p);
    const uint32_t* thi = ptr<uint32_t>(thi_p);
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        const uint32_t idx = b * 256 + ((wl >> (8 * b)) & 0xFFu);
        lo |= __ldg(tlo + idx);
        hi |= __ldg(thi + idx);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        const uint32_t idx = (4 + b) * 256 + ((wh >> (8 * b)) & 0xFFu);
        lo |= __ldg(tlo + idx);
        hi |= __ldg(thi + idx);
    }
    olo = lo;
    ohi = hi;
}

template <int W>
__global__ void __launch_bounds__(FC_ROWS)
chain_kernel(const __grid_constant__ ChainArgs<W> args) {
    __shared__ int cnt[3 * FC_MAX_STAGES];
    const ChainHead& h = args.h;
    const long long* w = args.w;
    const long long* desc = w + 2;
    const long long* inp = desc + w[0];
    const long long* outp = w + h.obase;
    const int n_stages = h.n_stages;
    const int lane = threadIdx.x & 31;

    for (int i = threadIdx.x; i < 3 * n_stages; i += blockDim.x) cnt[i] = 0;
    __syncthreads();

    uint32_t slot_lo = 0, slot_hi = 0;  // bit `lane` of this warp's final words
    for (int tile = blockIdx.x; tile < h.n_tiles; tile += gridDim.x) {
        const int row = tile * FC_ROWS + threadIdx.x;
        const bool live = row < h.n_rows;
        uint32_t bl = live ? __ldg(ptr<uint32_t>(inp[0]) + row) : 0u;
        uint32_t bh = live ? __ldg(ptr<uint32_t>(inp[1]) + row) : 0u;

        for (int s = 0; s < n_stages; ++s) {
            const long long* d = desc + h.dbase[s];
            const int key_mode = (int)d[0];
            const int n_grants = (int)d[1];
            const int gattrs = (int)d[2];
            const uint32_t cap_mask = (uint32_t)(d[3] - 1);
            const int n_members = (int)d[4];
            const int n_fattrs = (int)d[5];
            const long long* fsrc = d + 6;
            const long long* p = inp + h.pbase[s];
            int* oent = reinterpret_cast<int*>(outp[2 + s]);

            const bool alive = (bl | bh) != 0;
            int key = EMPTY_KEY;
            if (alive) {
                if (key_mode == -1) {
                    key = __ldg(ptr<int>(p[0]) + row);
                } else {
                    // keys gathered through an earlier stage's matched entry,
                    // which this thread wrote: a plain (coherent) load
                    const int e = reinterpret_cast<const int*>(outp[2 + key_mode])[row];
                    key = e >= 0 ? __ldg(ptr<int>(p[0]) + e) : EMPTY_KEY;
                }
            }
            int found = -1;
            if (key != EMPTY_KEY) {
                const int* tkeys = ptr<int>(p[1]);
                uint32_t pos = ((uint32_t)key * MULT) & cap_mask;
                for (int hop = 0; hop < MAX_PROBE; ++hop) {
                    const int sk = __ldg(tkeys + pos);
                    if (sk == key) {
                        found = (int)pos;
                        break;
                    }
                    if (sk == EMPTY_KEY) break;
                    pos = (pos + 1) & cap_mask;
                }
            }
            const bool matched = found >= 0;
            const int entry = matched ? __ldg(ptr<int>(p[2]) + found) : -1;
            if (live) oent[row] = entry;
            const int se = matched ? entry : 0;
            const uint32_t vlo = matched ? __ldg(ptr<uint32_t>(p[3]) + se) : 0u;
            const uint32_t vhi = matched ? __ldg(ptr<uint32_t>(p[4]) + se) : 0u;
            uint32_t plo, phi;
            translate(vlo, vhi, p[5], p[6], plo, phi);

            int pi = 7;
            if (n_grants) {
                // compiled extent-scoped grants: emask ∩ allowed, then the
                // conjunction's interval bounds on total-order-encoded columns
                const uint32_t* gbit = ptr<uint32_t>(p[9]);
                const uint32_t* gallow = ptr<uint32_t>(p[10]);
                const int* gcon = ptr<int>(p[11]);
                const uint32_t* glo = ptr<uint32_t>(p[12]);
                const uint32_t* ghi = ptr<uint32_t>(p[13]);
                const int A = gattrs > 1 ? gattrs : 1;
                const uint32_t elo = matched ? __ldg(ptr<uint32_t>(p[7]) + se) : 0u;
                const uint32_t ehi = matched ? __ldg(ptr<uint32_t>(p[8]) + se) : 0u;
                for (int g = 0; g < n_grants; ++g) {
                    bool gok = ((elo & gallow[2 * g]) | (ehi & gallow[2 * g + 1])) != 0;
                    for (int a = 0; a < gattrs; ++a) {
                        const uint32_t xh = __ldg(ptr<uint32_t>(p[14 + 2 * a]) + se);
                        const uint32_t xl = __ldg(ptr<uint32_t>(p[15 + 2 * a]) + se);
                        const int c = g * A + a;
                        const bool inb = ge(xh, xl, glo[2 * c], glo[2 * c + 1]) &&
                                         le(xh, xl, ghi[2 * c], ghi[2 * c + 1]);
                        gok = gok && (inb || gcon[c] == 0);
                    }
                    if (gok) {
                        plo |= gbit[2 * g];
                        phi |= gbit[2 * g + 1];
                    }
                }
                pi += 7 + 2 * gattrs;
            }
            const uint32_t nbl = bl & (matched ? plo : 0u);
            const uint32_t nbh = bh & (matched ? phi : 0u);
            const bool m_post = matched && ((nbl | nbh) != 0);
            bl = nbl;
            bh = nbh;

            if (n_members >= 0) {
                // interval stage-filter matrix: member m keeps its bit iff
                // every constrained attr lies inside its closed bounds
                const long long* fv = p + pi;
                const uint32_t* flo = ptr<uint32_t>(fv[2 * n_fattrs]);
                const uint32_t* fhi = ptr<uint32_t>(fv[2 * n_fattrs + 1]);
                const int* fcon = ptr<int>(fv[2 * n_fattrs + 2]);
                const uint32_t* fbit = ptr<uint32_t>(fv[2 * n_fattrs + 3]);
                uint32_t fblo = 0, fbhi = 0, fmlo = 0, fmhi = 0;
                for (int m = 0; m < n_members; ++m) {
                    bool okm = true;
                    for (int a = 0; a < n_fattrs; ++a) {
                        uint32_t xh = 0, xl = 0;
                        if (live) {
                            const int src = (int)fsrc[a];
                            int idx = row;
                            if (src != -1) {
                                const int e2 = reinterpret_cast<const int*>(outp[2 + src])[row];
                                idx = e2 >= 0 ? e2 : 0;
                            }
                            xh = __ldg(ptr<uint32_t>(fv[2 * a]) + idx);
                            xl = __ldg(ptr<uint32_t>(fv[2 * a + 1]) + idx);
                        }
                        const int c = m * n_fattrs + a;
                        const bool inb = ge(xh, xl, flo[2 * c], flo[2 * c + 1]) &&
                                         le(xh, xl, fhi[2 * c], fhi[2 * c + 1]);
                        okm = okm && (inb || fcon[c] == 0);
                    }
                    if (okm) {
                        fblo |= fbit[2 * m];
                        fbhi |= fbit[2 * m + 1];
                    }
                    fmlo |= fbit[2 * m];
                    fmhi |= fbit[2 * m + 1];
                }
                bl &= (~fmlo | fblo);
                bh &= (~fmhi | fbhi);
            }

            const unsigned ca = __ballot_sync(FULL_MASK, alive);
            const unsigned cm = __ballot_sync(FULL_MASK, matched);
            const unsigned cp = __ballot_sync(FULL_MASK, m_post);
            if (lane == 0) {
                if (ca) atomicAdd(cnt + 3 * s, __popc(ca));
                if (cm) atomicAdd(cnt + 3 * s + 1, __popc(cm));
                if (cp) atomicAdd(cnt + 3 * s + 2, __popc(cp));
            }
        }

        if (live) {
            reinterpret_cast<uint32_t*>(outp[0])[row] = bl;
            reinterpret_cast<uint32_t*>(outp[1])[row] = bh;
        }
#pragma unroll 8
        for (int j = 0; j < 32; ++j) {
            const unsigned cl = __ballot_sync(FULL_MASK, (bl >> j) & 1u);
            const unsigned ch = __ballot_sync(FULL_MASK, (bh >> j) & 1u);
            if (lane == j) {
                slot_lo += __popc(cl);
                slot_hi += __popc(ch);
            }
        }
        if (h.sink) {
            const long long* p = inp + h.pbase[n_stages];
            uint32_t vlo, vhi, elo, ehi;
            translate(bl, bh, p[0], p[1], vlo, vhi);
            translate(bl, bh, p[2], p[3], elo, ehi);
            if (live) {
                reinterpret_cast<uint32_t*>(outp[4 + n_stages])[row] = vlo;
                reinterpret_cast<uint32_t*>(outp[5 + n_stages])[row] = vhi;
                reinterpret_cast<uint32_t*>(outp[6 + n_stages])[row] = elo;
                reinterpret_cast<uint32_t*>(outp[7 + n_stages])[row] = ehi;
            }
        }
    }
    __syncthreads();
    // one global add per non-zero counter of the block
    int* ostats = reinterpret_cast<int*>(outp[2 + n_stages]);
    int* oslots = reinterpret_cast<int*>(outp[3 + n_stages]);
    for (int i = threadIdx.x; i < 3 * n_stages; i += blockDim.x)
        if (cnt[i]) atomicAdd(ostats + i, cnt[i]);
    __shared__ unsigned warp_slots[FC_ROWS / 32][64];
    warp_slots[threadIdx.x >> 5][lane] = slot_lo;
    warp_slots[threadIdx.x >> 5][32 + lane] = slot_hi;
    __syncthreads();
    if (threadIdx.x < 64) {
        unsigned total = 0;
        for (int wp = 0; wp < FC_ROWS / 32; ++wp) total += warp_slots[wp][threadIdx.x];
        if (total) atomicAdd(oslots + threadIdx.x, (int)total);
    }
}

namespace {

struct Launch {
    int blocks_per_sm[2];  // by instance; 0: not asked yet
    int sms;
};
Launch g_launch[16];  // by device

template <int W>
int launch(const long long* block, long long n_words, const ChainHead& head, int tier,
           cudaStream_t stream) {
    thread_local ChainArgs<W> args;  // host copy of the parameter struct
    args.h = head;
    memcpy(args.w, block, (size_t)n_words * sizeof(long long));
    int dev = 0;
    cudaGetDevice(&dev);
    Launch& L = g_launch[dev & 15];
    if (!L.sms) cudaDeviceGetAttribute(&L.sms, cudaDevAttrMultiProcessorCount, dev);
    int& per_sm = L.blocks_per_sm[tier];
    if (!per_sm) {
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_kernel<W>, FC_ROWS, 0);
        if (per_sm < 1) per_sm = 1;
    }
    long long grid = (long long)per_sm * L.sms;
    if (grid > head.n_tiles) grid = head.n_tiles;
    chain_kernel<W><<<(unsigned)grid, FC_ROWS, 0, stream>>>(args);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fc_chain(const long long* block, long long n_words, long long n_rows,
                        void* stream) {
    if (n_words < 4 || n_words > FC_MAX_WORDS) return (int)cudaErrorInvalidValue;
    const long long D = block[0];
    const long long n_in = block[1];
    const long long* desc = block + 2;
    const int n_stages = (int)desc[0];
    if (n_stages < 0 || n_stages > FC_MAX_STAGES || n_rows <= 0 || n_rows > (1ll << 30))
        return (int)cudaErrorInvalidValue;
    ChainHead head;
    head.n_rows = (int)n_rows;
    head.n_tiles = (int)((n_rows + FC_ROWS - 1) / FC_ROWS);
    head.n_stages = n_stages;
    head.sink = desc[1] != 0;
    long long di = 2, pi = 2;
    for (int s = 0; s < n_stages; ++s) {
        head.dbase[s] = (int)di;
        head.pbase[s] = (int)pi;
        const long long n_grants = desc[di + 1], gattrs = desc[di + 2];
        const long long n_members = desc[di + 4], n_fattrs = desc[di + 5];
        pi += 7 + (n_grants ? 7 + 2 * gattrs : 0) + (n_members >= 0 ? 2 * n_fattrs + 4 : 0);
        di += 6 + n_fattrs;
        if (di > D || pi > n_in) return (int)cudaErrorInvalidValue;
    }
    head.pbase[n_stages] = (int)pi;
    const long long n_out = 4 + n_stages + (head.sink ? 4 : 0);
    if (di != D || pi + (head.sink ? 4 : 0) != n_in || 2 + D + n_in + n_out != n_words)
        return (int)cudaErrorInvalidValue;
    head.obase = (int)(2 + D + n_in);

    // zero the stats and slot counters the blocks add into
    cudaStream_t st = (cudaStream_t)stream;
    const long long* outp = block + head.obase;
    const long long stats = outp[2 + n_stages], slots = outp[3 + n_stages];
    if (stats + 12ll * n_stages == slots) {
        cudaMemsetAsync((void*)stats, 0, (12 * n_stages + 256), st);
    } else {
        if (n_stages) cudaMemsetAsync((void*)stats, 0, 12 * n_stages, st);
        cudaMemsetAsync((void*)slots, 0, 256, st);
    }
    if (n_words <= FC_SMALL_WORDS) return launch<FC_SMALL_WORDS>(block, n_words, head, 0, st);
    return launch<FC_MAX_WORDS>(block, n_words, head, 1, st);
}
