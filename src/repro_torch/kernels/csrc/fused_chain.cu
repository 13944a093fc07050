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
// What bounds it on the H100: memory. Per row it reads the two ownership
// words and per stage one key, a probe chain of a few slots, an entry id, a
// two-half lens word, 8 byte-lane table lookups (the 16 KB translation
// tables stay in L1/L2) and, for grant or filter stages, a few
// total-order-encoded column halves; it writes the words, one entry id per
// stage and the sink words. Integer compares and ORs are cheap next to
// those gathers. The design keeps every intermediate in registers — nothing
// of a stage is written back except its entry id — and ends each chain walk
// at its first hit or EMPTY slot.
//
// Argument block (int64, in device memory):
//   [D, n_in, desc[D], in_ptr[n_in], out_ptr[...]]
//   desc = [n_stages, sink, then per stage: key_mode, n_grants, grant_attrs,
//           table_capacity, n_members (-1: no filter), n_fattrs,
//           fattr_src[n_fattrs]]
//   in_ptr follows repro_torch.kernels.fused_chain.input_kinds(spec).
//   out_ptr = bits_lo, bits_hi, entry[s] per stage, stats[S,3], slots[64],
//             then for a sink: vis_lo, vis_hi, em_lo, em_hi.
// Every uint32 word is a (lo, hi) pair of 32-bit halves, as in the
// reference. float64 bounds arrive total-order encoded as (hi, lo) pairs,
// so unsigned lexicographic compares reproduce IEEE >= / <= exactly.
//
// The row count is a power of two >= 8 and the block size divides it, so
// every thread owns a row and can take part in the block-wide counts.
// stats and slots accumulate across blocks with integer atomicAdd on
// buffers the caller zeroed: integer sums are exact in any order.

#include <cuda_runtime.h>
#include <stdint.h>

#define EMPTY_KEY (-0x7FFFFFFF)
#define MAX_PROBE 16
#define MULT 2654435761u

__device__ __forceinline__ bool ge(uint32_t xh, uint32_t xl, uint32_t bh, uint32_t bl) {
    return (xh > bh) || (xh == bh && xl >= bl);
}

__device__ __forceinline__ bool le(uint32_t xh, uint32_t xl, uint32_t bh, uint32_t bl) {
    return (xh < bh) || (xh == bh && xl <= bl);
}

// core.visibility.translate_bits on (lo, hi) halves: OR the split [8,256]
// byte-lane tables over every byte of the word.
__device__ __forceinline__ void translate(uint32_t wl, uint32_t wh,
                                          const uint32_t* __restrict__ tlo,
                                          const uint32_t* __restrict__ thi,
                                          uint32_t& olo, uint32_t& ohi) {
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        const uint32_t idx = b * 256 + ((wl >> (8 * b)) & 0xFFu);
        lo |= tlo[idx];
        hi |= thi[idx];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        const uint32_t idx = (4 + b) * 256 + ((wh >> (8 * b)) & 0xFFu);
        lo |= tlo[idx];
        hi |= thi[idx];
    }
    olo = lo;
    ohi = hi;
}

template <typename T>
__device__ __forceinline__ const T* in_ptr(const long long* inp, int& pi) {
    return reinterpret_cast<const T*>(inp[pi++]);
}

__global__ void chain_kernel(const long long* __restrict__ args) {
    const long long D = args[0];
    const long long n_in = args[1];
    const long long* desc = args + 2;
    const long long* inp = desc + D;
    const long long* outp = inp + n_in;
    const int row = blockIdx.x * blockDim.x + threadIdx.x;

    const int n_stages = (int)desc[0];
    const bool sink = desc[1] != 0;
    int di = 2;
    int pi = 0;

    uint32_t bl = in_ptr<uint32_t>(inp, pi)[row];
    uint32_t bh = in_ptr<uint32_t>(inp, pi)[row];
    int* ostats = reinterpret_cast<int*>(outp[2 + n_stages]);
    int* oslots = reinterpret_cast<int*>(outp[3 + n_stages]);

    for (int s = 0; s < n_stages; ++s) {
        const int key_mode = (int)desc[di++];
        const int n_grants = (int)desc[di++];
        const int gattrs = (int)desc[di++];
        const long long cap = desc[di++];
        const int n_members = (int)desc[di++];
        const int n_fattrs = (int)desc[di++];
        const long long* fsrc = desc + di;
        di += n_fattrs;

        const int* keyarr = in_ptr<int>(inp, pi);
        const int* tkeys = in_ptr<int>(inp, pi);
        const int* tentry = in_ptr<int>(inp, pi);
        const uint32_t* evlo = in_ptr<uint32_t>(inp, pi);
        const uint32_t* evhi = in_ptr<uint32_t>(inp, pi);
        const uint32_t* ttlo = in_ptr<uint32_t>(inp, pi);
        const uint32_t* tthi = in_ptr<uint32_t>(inp, pi);
        int* oent = reinterpret_cast<int*>(outp[2 + s]);

        const bool alive = (bl | bh) != 0;
        int key = EMPTY_KEY;
        if (alive) {
            if (key_mode == -1) {
                key = keyarr[row];
            } else {
                // keys gathered through an earlier stage's matched entry
                const int e = reinterpret_cast<const int*>(outp[2 + key_mode])[row];
                key = e >= 0 ? keyarr[e] : EMPTY_KEY;
            }
        }
        int found = -1;
        if (key != EMPTY_KEY) {
            const uint32_t mask = (uint32_t)(cap - 1);
            uint32_t pos = ((uint32_t)key * MULT) & mask;
            for (int h = 0; h < MAX_PROBE; ++h) {
                const int sk = tkeys[pos];
                if (sk == key) {
                    found = (int)pos;
                    break;
                }
                if (sk == EMPTY_KEY) break;
                pos = (pos + 1) & mask;
            }
        }
        const bool matched = found >= 0;
        const int entry = matched ? tentry[found] : -1;
        oent[row] = entry;
        const int se = matched ? entry : 0;
        uint32_t plo, phi;
        translate(matched ? evlo[se] : 0u, matched ? evhi[se] : 0u, ttlo, tthi, plo, phi);

        if (n_grants) {
            // compiled extent-scoped grants: emask ∩ allowed, then the
            // conjunction's interval bounds on total-order-encoded columns
            const uint32_t* eemlo = in_ptr<uint32_t>(inp, pi);
            const uint32_t* eemhi = in_ptr<uint32_t>(inp, pi);
            const uint32_t* gbit = in_ptr<uint32_t>(inp, pi);
            const uint32_t* gallow = in_ptr<uint32_t>(inp, pi);
            const int* gcon = in_ptr<int>(inp, pi);
            const uint32_t* glo = in_ptr<uint32_t>(inp, pi);
            const uint32_t* ghi = in_ptr<uint32_t>(inp, pi);
            const int gbase = pi;
            pi += 2 * gattrs;
            const int A = gattrs > 1 ? gattrs : 1;
            const uint32_t elo = matched ? eemlo[se] : 0u;
            const uint32_t ehi = matched ? eemhi[se] : 0u;
            for (int g = 0; g < n_grants; ++g) {
                bool gok = ((elo & gallow[2 * g]) | (ehi & gallow[2 * g + 1])) != 0;
                for (int a = 0; a < gattrs; ++a) {
                    const uint32_t xh = reinterpret_cast<const uint32_t*>(inp[gbase + 2 * a])[se];
                    const uint32_t xl = reinterpret_cast<const uint32_t*>(inp[gbase + 2 * a + 1])[se];
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
        }
        const uint32_t nbl = bl & (matched ? plo : 0u);
        const uint32_t nbh = bh & (matched ? phi : 0u);
        const bool m_post = matched && ((nbl | nbh) != 0);
        bl = nbl;
        bh = nbh;

        if (n_members >= 0) {
            // interval stage-filter matrix: member m keeps its bit iff every
            // constrained attr lies inside its closed bounds
            const int fbase = pi;
            pi += 2 * n_fattrs;
            const uint32_t* flo = in_ptr<uint32_t>(inp, pi);
            const uint32_t* fhi = in_ptr<uint32_t>(inp, pi);
            const int* fcon = in_ptr<int>(inp, pi);
            const uint32_t* fbit = in_ptr<uint32_t>(inp, pi);
            uint32_t fblo = 0, fbhi = 0, fmlo = 0, fmhi = 0;
            for (int m = 0; m < n_members; ++m) {
                bool okm = true;
                for (int a = 0; a < n_fattrs; ++a) {
                    const int src = (int)fsrc[a];
                    int idx = row;
                    if (src != -1) {
                        const int e2 = reinterpret_cast<const int*>(outp[2 + src])[row];
                        idx = e2 >= 0 ? e2 : 0;
                    }
                    const uint32_t xh = reinterpret_cast<const uint32_t*>(inp[fbase + 2 * a])[idx];
                    const uint32_t xl = reinterpret_cast<const uint32_t*>(inp[fbase + 2 * a + 1])[idx];
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

        const int c_alive = __syncthreads_count(alive);
        const int c_match = __syncthreads_count(matched);
        const int c_post = __syncthreads_count(m_post);
        if (threadIdx.x == 0) {
            if (c_alive) atomicAdd(ostats + 3 * s, c_alive);
            if (c_match) atomicAdd(ostats + 3 * s + 1, c_match);
            if (c_post) atomicAdd(ostats + 3 * s + 2, c_post);
        }
    }

    reinterpret_cast<uint32_t*>(outp[0])[row] = bl;
    reinterpret_cast<uint32_t*>(outp[1])[row] = bh;
    for (int j = 0; j < 32; ++j) {
        const int cl = __syncthreads_count((bl >> j) & 1u);
        const int ch = __syncthreads_count((bh >> j) & 1u);
        if (threadIdx.x == 0) {
            if (cl) atomicAdd(oslots + j, cl);
            if (ch) atomicAdd(oslots + 32 + j, ch);
        }
    }
    if (sink) {
        const uint32_t* stlo = in_ptr<uint32_t>(inp, pi);
        const uint32_t* sthi = in_ptr<uint32_t>(inp, pi);
        const uint32_t* selo = in_ptr<uint32_t>(inp, pi);
        const uint32_t* sehi = in_ptr<uint32_t>(inp, pi);
        uint32_t vlo, vhi, elo, ehi;
        translate(bl, bh, stlo, sthi, vlo, vhi);
        translate(bl, bh, selo, sehi, elo, ehi);
        reinterpret_cast<uint32_t*>(outp[4 + n_stages])[row] = vlo;
        reinterpret_cast<uint32_t*>(outp[5 + n_stages])[row] = vhi;
        reinterpret_cast<uint32_t*>(outp[6 + n_stages])[row] = elo;
        reinterpret_cast<uint32_t*>(outp[7 + n_stages])[row] = ehi;
    }
}

extern "C" int fc_chain(const void* args, long long n_rows, long long block, void* stream) {
    if (n_rows > 0)
        chain_kernel<<<(unsigned)(n_rows / block), (unsigned)block, 0, (cudaStream_t)stream>>>(
            (const long long*)args);
    return (int)cudaGetLastError();
}
