// Hash-join probe kernels with a fused per-query state lens, for Hopper.
//
// Replace the Pallas TPU kernels of src/repro/kernels/hash_probe.py:
//   hp_probe_lens     <- _probe_kernel          (hash_probe_lens)
//   hp_probe_lens64   <- _probe_lens64_kernel   (hash_probe_lens64)
//   hp_probe_multi64  <- _probe_multi64_kernel  (hash_probe_lens_multi64)
//
// What bounds them on the H100: memory. Per probe key a thread reads one
// key, walks at most MAX_PROBE slots of an open-addressing table (at 50%
// load most chains end after one or two slots) and gathers one or two
// entry-indexed visibility words: a few dependent 4-byte gathers per key and
// no arithmetic worth counting. The SF-1 orders table (2^22 slots, 32 MB of
// keys + entry ids) and its 1.5 M-entry word mirrors fit the 50 MB L2, so
// the gathers hit L2 after the first touch.
//
// Design: one thread per probe key, early exit as soon as the key's chain
// ends (a hit or an EMPTY slot), which the TPU version could not do (it ran
// all MAX_PROBE vector steps). The TPU version kept the whole table in VMEM
// per grid step; here the table stays in device memory and L2 does that
// job. Each entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define EMPTY_KEY (-0x7FFFFFFF)
#define MAX_PROBE 16
#define MULT 2654435761u
#define BLOCK 256

__device__ __forceinline__ uint32_t home_slot(int key, uint32_t mask) {
    return ((uint32_t)key * MULT) & mask;
}

// An entry id read from a table slot that holds no entry is -1; like the
// reference's gather it then wraps to the mirror's last element.
__device__ __forceinline__ long long wrap(int e, long long n_entries) {
    return e < 0 ? e + n_entries : e;
}

__global__ void probe_lens_kernel(const int* __restrict__ keys, long long n,
                                  const int* __restrict__ tkeys,
                                  const uint32_t* __restrict__ tvis, long long cap,
                                  const uint32_t* __restrict__ qmask,
                                  int* __restrict__ out) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int key = keys[i];
    const uint32_t mask = (uint32_t)(cap - 1);
    const uint32_t q = qmask[0];
    uint32_t pos = home_slot(key, mask);
    int found = -1;
    for (int h = 0; h < MAX_PROBE; ++h) {
        const int sk = tkeys[pos];
        if (sk == key) {  // a key hit ends the search, visible or not
            if (tvis[pos] & q) found = (int)pos;
            break;
        }
        if (sk == EMPTY_KEY) break;
        pos = (pos + 1) & mask;
    }
    out[i] = found;
}

__global__ void probe_lens64_kernel(const int* __restrict__ keys, long long n,
                                    const int* __restrict__ tkeys,
                                    const int* __restrict__ tentry, long long cap,
                                    const uint32_t* __restrict__ evlo,
                                    const uint32_t* __restrict__ evhi,
                                    long long n_entries,
                                    const uint32_t* __restrict__ qmask,
                                    int* __restrict__ out) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int key = keys[i];
    const uint32_t mask = (uint32_t)(cap - 1);
    const uint32_t qlo = qmask[0], qhi = qmask[1];
    uint32_t pos = home_slot(key, mask);
    int found = -1;
    for (int h = 0; h < MAX_PROBE; ++h) {
        const int sk = tkeys[pos];
        if (sk == key) {
            const long long e = wrap(tentry[pos], n_entries);
            if ((evlo[e] & qlo) | (evhi[e] & qhi)) found = (int)pos;
            break;
        }
        if (sk == EMPTY_KEY) break;
        pos = (pos + 1) & mask;
    }
    out[i] = found;
}

__global__ void probe_multi64_kernel(const int* __restrict__ keys, long long n,
                                     const int* __restrict__ tkeys,
                                     const int* __restrict__ tentry, long long cap,
                                     const uint32_t* __restrict__ evlo,
                                     const uint32_t* __restrict__ evhi,
                                     long long n_entries,
                                     int* __restrict__ out_slot,
                                     uint32_t* __restrict__ out_lo,
                                     uint32_t* __restrict__ out_hi) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int key = keys[i];
    const uint32_t mask = (uint32_t)(cap - 1);
    uint32_t pos = home_slot(key, mask);
    int found = -1;
    for (int h = 0; h < MAX_PROBE; ++h) {
        const int sk = tkeys[pos];
        if (sk == key) {
            found = (int)pos;
            break;
        }
        if (sk == EMPTY_KEY) break;
        pos = (pos + 1) & mask;
    }
    uint32_t lo = 0, hi = 0;
    if (found >= 0) {
        const long long e = wrap(tentry[found], n_entries);
        lo = evlo[e];
        hi = evhi[e];
    }
    out_slot[i] = found;
    out_lo[i] = lo;
    out_hi[i] = hi;
}

static unsigned grid_of(long long n) { return (unsigned)((n + BLOCK - 1) / BLOCK); }

extern "C" int hp_probe_lens(const void* keys, const void* tkeys, const void* tvis,
                             const void* qmask, void* out, long long n, long long cap,
                             void* stream) {
    if (n > 0)
        probe_lens_kernel<<<grid_of(n), BLOCK, 0, (cudaStream_t)stream>>>(
            (const int*)keys, n, (const int*)tkeys, (const uint32_t*)tvis, cap,
            (const uint32_t*)qmask, (int*)out);
    return (int)cudaGetLastError();
}

extern "C" int hp_probe_lens64(const void* keys, const void* tkeys, const void* tentry,
                               const void* evlo, const void* evhi, const void* qmask,
                               void* out, long long n, long long cap, long long n_entries,
                               void* stream) {
    if (n > 0)
        probe_lens64_kernel<<<grid_of(n), BLOCK, 0, (cudaStream_t)stream>>>(
            (const int*)keys, n, (const int*)tkeys, (const int*)tentry, cap,
            (const uint32_t*)evlo, (const uint32_t*)evhi, n_entries,
            (const uint32_t*)qmask, (int*)out);
    return (int)cudaGetLastError();
}

extern "C" int hp_probe_multi64(const void* keys, const void* tkeys, const void* tentry,
                                const void* evlo, const void* evhi, void* out_slot,
                                void* out_lo, void* out_hi, long long n, long long cap,
                                long long n_entries, void* stream) {
    if (n > 0)
        probe_multi64_kernel<<<grid_of(n), BLOCK, 0, (cudaStream_t)stream>>>(
            (const int*)keys, n, (const int*)tkeys, (const int*)tentry, cap,
            (const uint32_t*)evlo, (const uint32_t*)evhi, n_entries, (int*)out_slot,
            (uint32_t*)out_lo, (uint32_t*)out_hi);
    return (int)cudaGetLastError();
}
