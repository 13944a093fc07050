// Hash-join probe kernels with a fused per-query state lens, and the
// batch insert that builds their table, for Hopper.
//
// Replace the Pallas TPU kernels of src/repro/kernels/hash_probe.py:
//   hp_probe_lens     <- _probe_kernel          (hash_probe_lens)
//   hp_probe_multi    <- _probe_multi_kernel    (hash_probe_lens_multi)
//   hp_probe_lens64   <- _probe_lens64_kernel   (hash_probe_lens64; its note
//                        says how it differs from the others)
//   hp_probe_multi64  <- _probe_multi64_kernel  (hash_probe_lens_multi64)
//   hp_build_insert   <- _insert_kernel         (hash_build_insert)
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
//
// The batch insert builds the table the reference builds key by key in
// batch order (key i takes the first EMPTY slot of its MAX_PROBE-slot
// window; meeting its own key first, or no EMPTY slot, clears ok), and the
// engine needs that very table. A parallel insert by CAS or by winner
// election builds another one. This kernel builds the same table as a
// parallel sweep over the slots instead. Linear probing that serves keys
// first come, first served has this property: walk the slots in probe
// order from just after a slot that ends up empty; at each slot put into a
// pool the keys whose home is that slot, place the pool's key with the
// lowest batch index there and take it out of the pool. Proof sketch, by
// induction over the slots: let x be the lowest-index key in the pool at
// slot s. Every slot from home(x) to s - 1 took a key of lower index than
// x, so those slots were full when x arrived; a key z that the sequential
// insert put at s with a lower index than x would be in the pool and beat
// x. The sweep also gives the same ok: the first failing key in batch
// order sees the same table in both; a window overflow is a placement at
// distance >= MAX_PROBE from home (certain once a pool would hold more than
// MAX_PROBE keys); equal keys share a home, so a duplicate is two equal
// keys of one home bucket. So the table cuts into independent segments at
// the slots that end up empty, and each segment is swept by its own thread.
//
// The number of keys waiting to enter slot s after slot s - 1 follows
// o_s = max(0, o_{s-1} + count_s - 1), count_s the keys whose home is s, and
// slot s ends up empty iff o_{s-1} + count_s == 0. These maps x -> max(a,
// x + b) compose, so the o's come from a chunked scan (the three-pass shape
// of linrec.cu): per-tile compositions, the carry across tiles, then per
// thread its slots' state. The table is circular; since n < cap, the whole
// round's composition max(A, x + B) has B = n - cap < 0, and its fixed
// point A is the true carry into slot 0. Passes, one C entry point:
//   0. ins_fill_kernel: tkeys = EMPTY, tentry = -1, counts 0, buckets empty;
//   1. ins_link_kernel: per key count[home] += 1 and a push onto its home's
//      bucket list (integer atomics; order inside a bucket does not matter);
//   2. ins_tile_kernel: each 4,096-slot tile's composition;
//   3. ins_carry_kernel: one block, the carry into every tile;
//   4. ins_sweep_kernel: per 4 slots (a thread) the first that ends up
//      empty; from just after it the thread sweeps to the first empty slot
//      at or after the next thread's first slot, so the segments cover the
//      circle once. n == cap leaves no slot empty: that case alone runs the
//      one-warp sequential insert (ins_seq_kernel), which stops at the first
//      failure. n > cap cannot succeed: ok = 0 at once.
// What bounds it: bytes, 4 n for the keys and 8 cap for the two tables, plus
// the scratch (counts and bucket heads, 8 cap, read back twice; bucket links,
// 4 n) that the sweep moves through L2. Where ok is 0 a thread stops at its
// failure, so the table is not the plain version's; callers discard it.

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

__global__ void probe_multi_kernel(const int* __restrict__ keys, long long n,
                                   const int* __restrict__ tkeys,
                                   const uint32_t* __restrict__ tvis, long long cap,
                                   int* __restrict__ out_slot,
                                   uint32_t* __restrict__ out_vis) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int key = keys[i];
    const uint32_t mask = (uint32_t)(cap - 1);
    uint32_t pos = home_slot(key, mask);
    int found = -1;
    uint32_t vis = 0;
    for (int h = 0; h < MAX_PROBE; ++h) {
        const int sk = tkeys[pos];
        if (sk == key) {  // pre-visibility: the slot's whole word goes out
            found = (int)pos;
            vis = tvis[pos];
            break;
        }
        if (sk == EMPTY_KEY) break;
        pos = (pos + 1) & mask;
    }
    out_slot[i] = found;
    out_vis[i] = vis;
}

// B2, the single-query probe of probe_visible. Its work is a chain of four
// dependent gathers per key (key, slot keys, entry id, lens word): 3 us of
// device time at 65,536 keys on an H100 80GB HBM3 at 700 W, against 25 us
// a call by CUDA events, the rest being the host's. So the 64-bit query
// mask comes by value (two kernel parameters, no device copy of 8 bytes
// before each call), and the loads go through the read-only path. Tried
// on the card and not kept, since none was faster: 128-thread blocks
// (512 blocks over the 132 SMs), two keys per thread with their first
// gathers issued together.
__global__ void __launch_bounds__(BLOCK)
probe_lens64_kernel(const int* __restrict__ keys, long long n,
                    const int* __restrict__ tkeys, const int* __restrict__ tentry,
                    long long cap, const uint32_t* __restrict__ evlo,
                    const uint32_t* __restrict__ evhi, long long n_entries,
                    uint32_t qlo, uint32_t qhi, int* __restrict__ out) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int key = __ldg(keys + i);
    const uint32_t mask = (uint32_t)(cap - 1);
    uint32_t pos = home_slot(key, mask);
    int found = -1;
    for (int h = 0; h < MAX_PROBE; ++h) {
        const int sk = __ldg(tkeys + pos);
        if (sk == key) {
            const long long e = wrap(__ldg(tentry + pos), n_entries);
            if ((__ldg(evlo + e) & qlo) | (__ldg(evhi + e) & qhi)) found = (int)pos;
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

// -- B6: batch insert as a parallel sweep ------------------------------------

#define INS_TILE 4096  // slots of one block of passes 2 and 4
#define INS_SPT 4      // slots of one thread: where its segment may start

// x -> max(a, x + b) over x >= 0, so (0, 0) is the identity
struct MaxPlus {
    int a, b;
};

// f, then g
__device__ __forceinline__ MaxPlus mp_then(MaxPlus f, MaxPlus g) {
    return {max(g.a, f.a + g.b), f.b + g.b};
}

__device__ __forceinline__ int mp_apply(MaxPlus f, int x) { return max(f.a, x + f.b); }

// slots [first, first + spt): keys waiting before them -> keys waiting after
__device__ __forceinline__ MaxPlus slots_map(const int* __restrict__ count, long long first,
                                             int spt) {
    MaxPlus f = {0, 0};
    for (int j = 0; j < spt; ++j) f = mp_then(f, {0, count[first + j] - 1});
    return f;
}

// exclusive scan of the block's maps in thread order; *total gets them all
__device__ MaxPlus block_scan(MaxPlus f, MaxPlus* sh, MaxPlus* total) {
    const int t = threadIdx.x, nt = blockDim.x;
    sh[t] = f;
    __syncthreads();
    for (int off = 1; off < nt; off <<= 1) {
        const MaxPlus mine = sh[t];
        const MaxPlus before = t >= off ? sh[t - off] : MaxPlus{0, 0};
        __syncthreads();
        sh[t] = mp_then(before, mine);
        __syncthreads();
    }
    const MaxPlus excl = t > 0 ? sh[t - 1] : MaxPlus{0, 0};
    *total = sh[nt - 1];
    return excl;
}

// pass 0: a fresh table, zero counts, empty buckets
__global__ void ins_fill_kernel(int* __restrict__ tkeys, int* __restrict__ tentry,
                                int* __restrict__ count, int* __restrict__ head, long long cap,
                                int* __restrict__ ok, int ok0) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < cap;
         i += (long long)gridDim.x * blockDim.x) {
        tkeys[i] = EMPTY_KEY;
        tentry[i] = -1;
        count[i] = 0;
        head[i] = -1;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) ok[0] = ok0;
}

// pass 1: per key, its home's count and a push onto its home's bucket list.
// A key equal to EMPTY cannot be told from an empty slot: ok = 0.
__global__ void ins_link_kernel(const int* __restrict__ keys, int n, int* __restrict__ count,
                                int* __restrict__ head, int* __restrict__ next, uint32_t mask,
                                int* __restrict__ ok) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int key = keys[i];
    if (key == EMPTY_KEY) ok[0] = 0;
    const uint32_t h = home_slot(key, mask);
    atomicAdd(&count[h], 1);
    next[i] = atomicExch(&head[h], i);
}

// pass 2: each tile's composition
__global__ void ins_tile_kernel(const int* __restrict__ count, int spt,
                                MaxPlus* __restrict__ tile_map) {
    extern __shared__ MaxPlus sh[];
    const long long first = (long long)blockIdx.x * blockDim.x * spt + (long long)threadIdx.x * spt;
    MaxPlus total;
    block_scan(slots_map(count, first, spt), sh, &total);
    if (threadIdx.x == 0) tile_map[blockIdx.x] = total;
}

// pass 3, one block: the keys waiting to enter each tile. Thread t owns the
// tiles [t * per, (t + 1) * per).
__global__ void ins_carry_kernel(const MaxPlus* __restrict__ tile_map, int n_tiles,
                                 int* __restrict__ carry) {
    extern __shared__ MaxPlus sh[];
    const int per = (n_tiles + blockDim.x - 1) / blockDim.x;
    const int lo = min(n_tiles, (int)threadIdx.x * per), hi = min(n_tiles, lo + per);
    MaxPlus f = {0, 0};
    for (int i = lo; i < hi; ++i) f = mp_then(f, tile_map[i]);
    MaxPlus total;
    const MaxPlus excl = block_scan(f, sh, &total);
    // n < cap, so total.b < 0 and the round's fixed point is total.a
    int x = mp_apply(excl, total.a);
    for (int i = lo; i < hi; ++i) {
        carry[i] = x;
        x = mp_apply(tile_map[i], x);
    }
}

// pass 4: each thread finds the first of its slots that ends up empty and
// sweeps the segment after it (see the note at the top)
__global__ void ins_sweep_kernel(const int* __restrict__ keys, const int* __restrict__ count,
                                 const int* __restrict__ head, const int* __restrict__ next,
                                 const int* __restrict__ carry, int spt, uint32_t mask,
                                 int* __restrict__ tkeys, int* __restrict__ tentry,
                                 int* __restrict__ ok) {
    extern __shared__ MaxPlus sh[];
    const long long first = (long long)blockIdx.x * blockDim.x * spt + (long long)threadIdx.x * spt;
    MaxPlus total;
    const MaxPlus excl = block_scan(slots_map(count, first, spt), sh, &total);
    int waiting = mp_apply(excl, carry[blockIdx.x]);
    long long empty = -1;
    for (int j = 0; j < spt; ++j) {
        const int c = count[first + j];
        if (waiting + c == 0) {
            empty = first + j;
            break;
        }
        waiting = max(0, waiting + c - 1);
    }
    if (empty < 0) return;  // no segment starts among these slots

    // the pool: batch indices and keys of at most MAX_PROBE waiting keys
    int pidx[MAX_PROBE], pkey[MAX_PROBE];
    int np = 0;
    const long long stop = first + spt;
    for (long long u = empty + 1;; ++u) {
        const uint32_t s = (uint32_t)u & mask;
        const int bucket = np;
        for (int i = head[s]; i >= 0; i = next[i]) {
            if (np == MAX_PROBE) {  // a window overflow is certain
                ok[0] = 0;
                return;
            }
            const int key = keys[i];
            for (int j = bucket; j < np; ++j)
                if (pkey[j] == key) {  // a duplicate
                    ok[0] = 0;
                    return;
                }
            pidx[np] = i;
            pkey[np] = key;
            ++np;
        }
        if (np == 0) {  // slot s ends up empty
            if (u >= stop) return;
            continue;
        }
        int best = 0;
        for (int j = 1; j < np; ++j)
            if (pidx[j] < pidx[best]) best = j;
        const int key = pkey[best];
        if (((s - home_slot(key, mask)) & mask) >= MAX_PROBE) {  // outside its window
            ok[0] = 0;
            return;
        }
        tkeys[s] = key;
        tentry[s] = pidx[best];
        --np;
        pidx[best] = pidx[np];
        pkey[best] = pkey[np];
    }
}

// n == cap only (no slot ends up empty): the sequential insert, one warp
// in batch order. Lanes 0..15 read the key's window in one load, a ballot
// finds the first EMPTY or equal slot, one lane stores, and __syncwarp()
// orders that store before the next key's load. It stops at the first
// failure. tkeys is read and written by different lanes, so it is neither
// const nor __restrict__.
__global__ void ins_seq_kernel(const int* __restrict__ keys, long long n, int* tkeys,
                               int* tentry, long long cap, int* __restrict__ ok) {
    const unsigned FULL = 0xFFFFFFFFu;
    const int lane = threadIdx.x;
    const uint32_t mask = (uint32_t)(cap - 1);
    int good = 1;
    for (long long base = 0; base < n && good; base += 32) {
        const int mine = base + lane < n ? keys[base + lane] : 0;
        const int count = n - base < 32 ? (int)(n - base) : 32;
        for (int j = 0; j < count; ++j) {
            const int key = __shfl_sync(FULL, mine, j);
            if (key == EMPTY_KEY) {
                good = 0;
                break;
            }
            const uint32_t slot = (home_slot(key, mask) + (uint32_t)lane) & mask;
            const int cur = lane < MAX_PROBE ? tkeys[slot] : 0;
            // the first EMPTY or equal slot in probe order; EMPTY wins a tie,
            // as in the reference
            const unsigned stop =
                __ballot_sync(FULL, lane < MAX_PROBE && (cur == EMPTY_KEY || cur == key));
            const int first = __ffs(stop) - 1;
            const int seen = __shfl_sync(FULL, cur, first < 0 ? 0 : first);
            if (first < 0 || seen != EMPTY_KEY) {  // window full, or a duplicate
                good = 0;
                break;
            }
            if (lane == first) {
                tkeys[slot] = key;
                tentry[slot] = (int)(base + j);
            }
            __syncwarp();
        }
    }
    if (lane == 0) ok[0] = good;
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

extern "C" int hp_probe_multi(const void* keys, const void* tkeys, const void* tvis,
                              void* out_slot, void* out_vis, long long n, long long cap,
                              void* stream) {
    if (n > 0)
        probe_multi_kernel<<<grid_of(n), BLOCK, 0, (cudaStream_t)stream>>>(
            (const int*)keys, n, (const int*)tkeys, (const uint32_t*)tvis, cap,
            (int*)out_slot, (uint32_t*)out_vis);
    return (int)cudaGetLastError();
}

extern "C" int hp_probe_lens64(const void* keys, const void* tkeys, const void* tentry,
                               const void* evlo, const void* evhi, void* out, long long n,
                               long long cap, long long n_entries, long long qlo,
                               long long qhi, void* stream) {
    if (n > 0)
        probe_lens64_kernel<<<grid_of(n), BLOCK, 0, (cudaStream_t)stream>>>(
            (const int*)keys, n, (const int*)tkeys, (const int*)tentry, cap,
            (const uint32_t*)evlo, (const uint32_t*)evhi, n_entries, (uint32_t)qlo,
            (uint32_t)qhi, (int*)out);
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

// the sweep's tiling of a table of cap slots
static void ins_tiling(long long cap, int* spt, int* threads, long long* n_tiles) {
    const long long tile = cap < INS_TILE ? cap : INS_TILE;
    *spt = cap < INS_SPT ? (int)cap : INS_SPT;
    *threads = (int)(tile / *spt);
    *n_tiles = cap / tile;
}

// int32 words of scratch hp_build_insert needs: counts and bucket heads
// (cap each), bucket links (n), tile maps (2 per tile) and carries
extern "C" long long hp_build_insert_scratch(long long n, long long cap) {
    int spt, threads;
    long long n_tiles;
    ins_tiling(cap, &spt, &threads, &n_tiles);
    return 2 * cap + n + 3 * n_tiles;
}

// keys [n] -> tkeys, tentry [cap], ok [1]; cap a power of two; scratch holds
// hp_build_insert_scratch(n, cap) int32 words
extern "C" int hp_build_insert(const void* keys, void* tkeys, void* tentry, void* ok,
                               void* scratch, long long n, long long cap, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (cap < 1 || (cap & (cap - 1)) || cap > (1LL << 30)) return (int)cudaErrorInvalidValue;
    int* count = (int*)scratch;
    int* head = count + cap;
    int* next = head + cap;
    const long long fill_blocks = (cap + BLOCK - 1) / BLOCK;
    ins_fill_kernel<<<(unsigned)(fill_blocks < 4096 ? fill_blocks : 4096), BLOCK, 0, st>>>(
        (int*)tkeys, (int*)tentry, count, head, cap, (int*)ok, n <= cap);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n == 0 || n > cap) return (int)err;
    if (n == cap) {
        ins_seq_kernel<<<1, 32, 0, st>>>((const int*)keys, n, (int*)tkeys, (int*)tentry, cap,
                                         (int*)ok);
        return (int)cudaGetLastError();
    }
    int spt, threads;
    long long n_tiles;
    ins_tiling(cap, &spt, &threads, &n_tiles);
    MaxPlus* tile_map = (MaxPlus*)(next + n);
    int* carry = (int*)(tile_map + n_tiles);
    const uint32_t mask = (uint32_t)(cap - 1);
    ins_link_kernel<<<grid_of(n), BLOCK, 0, st>>>((const int*)keys, (int)n, count, head, next,
                                                  mask, (int*)ok);
    const size_t shmem = threads * sizeof(MaxPlus);
    ins_tile_kernel<<<(unsigned)n_tiles, threads, shmem, st>>>(count, spt, tile_map);
    ins_carry_kernel<<<1, 1024, 1024 * sizeof(MaxPlus), st>>>(tile_map, (int)n_tiles, carry);
    ins_sweep_kernel<<<(unsigned)n_tiles, threads, shmem, st>>>(
        (const int*)keys, count, head, next, carry, spt, mask, (int*)tkeys, (int*)tentry,
        (int*)ok);
    return (int)cudaGetLastError();
}
