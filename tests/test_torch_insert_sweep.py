"""The batch insert's parallel sweep (``csrc/hash_probe.cu``, B6), modelled
in Python and held against the sequential insert.

The CUDA kernel cannot run here, so this file models its passes 2-4 step
for step: the max-plus scan that finds the slots that end up empty (per
thread of ``SPT`` slots, per tile, the circular carry across tiles), the
home buckets, and the sweep of each segment with its pool of waiting keys
(the lowest batch index placed first; ok cleared by a placement at
distance >= 16, a pool that would pass 16 keys, or two equal keys of one
bucket). n == cap leaves no slot empty and runs the sequential insert; n >
cap cannot succeed. The model is held against the port's plain version
(``hash_build_insert_plain``, the sequential spec) and the reference's
Pallas kernel in interpret mode: ``ok`` always equal, the tables equal
where ``ok`` is 1 (a failing segment stops where it fails). The kernel
itself is held against the plain version on the card in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.kernels import hash_probe as ref_hp
from repro_torch.kernels import hash_probe
from repro_torch.kernels.hash_probe import EMPTY, MAX_PROBE, MULT, keys_at

torch.set_num_threads(2)

#: the kernel's tiling is 4,096 slots a tile and 4 a thread; the model's
#: default tile is small, so that tables of 32 slots and more span several
#: tiles and the carry across them is exercised
TILE, SPT = 16, 4


def _home(key, mask):
    return ((key & 0xFFFFFFFF) * MULT) & mask


def _then(f, g):
    """The max-plus map x -> max(a, x + b): f, then g."""
    return max(g[0], f[0] + g[1]), f[1] + g[1]


def _apply(f, x):
    return max(f[0], x + f[1])


def _compose(maps):
    out = (0, 0)
    for f in maps:
        out = _then(out, f)
    return out


def sweep_insert(keys, cap, tile=TILE, spt=SPT):
    """The kernel's passes on host integers: ``(tkeys, tentry, ok)``."""
    keys = [int(k) for k in keys]
    n, mask = len(keys), cap - 1
    if n >= cap:  # no slot ends up empty: the kernel inserts in batch order
        return _plain(keys, cap)
    tk = np.full(cap, EMPTY, np.int32)
    te = np.full(cap, -1, np.int32)
    ok = int(EMPTY not in keys)
    # pass 1: counts and buckets (the kernel's lists come out in any order)
    count = [0] * cap
    bucket = [[] for _ in range(cap)]
    for i in reversed(range(n)):
        h = _home(keys[i], mask)
        count[h] += 1
        bucket[h].append(i)
    # passes 2-3: per thread its slots' map, per tile their composition, the
    # circular carry into each tile (n < cap: the round's fixed point)
    tile, spt = min(cap, tile), min(cap, spt)
    per_tile = tile // spt
    thread_map = [_compose((0, count[s] - 1) for s in range(t * spt, (t + 1) * spt))
                  for t in range(cap // spt)]
    tile_map = [_compose(thread_map[i * per_tile:(i + 1) * per_tile]) for i in range(cap // tile)]
    total = _compose(tile_map)
    assert total[1] == n - cap < 0
    carry, x = [], total[0]
    for f in tile_map:
        carry.append(x)
        x = _apply(f, x)
    # pass 4: each thread's first slot that ends up empty, and the sweep
    # of the segment after it, up to the first empty slot at or after the
    # next thread's first slot
    def sweep(start, stop):
        pool, u = [], start
        while True:
            s = u & mask
            new = len(pool)
            for j in bucket[s]:
                if len(pool) == MAX_PROBE:  # a window overflow is certain
                    return False
                if any(keys[p] == keys[j] for p in pool[new:]):  # a duplicate
                    return False
                pool.append(j)
            if pool:
                j = min(pool)
                if (s - _home(keys[j], mask)) & mask >= MAX_PROBE:
                    return False
                tk[s], te[s] = keys[j], j
                pool.remove(j)
            elif u >= stop:
                return True
            u += 1

    for t in range(cap // spt):
        i, first = t // per_tile, t * spt
        waiting = _apply(_compose(thread_map[i * per_tile:t]), carry[i])
        for s in range(first, first + spt):
            if waiting + count[s] == 0:
                if not sweep(s + 1, first + spt):
                    ok = 0
                break
            waiting = max(0, waiting + count[s] - 1)
    return tk, te, ok


def _norm(out):
    """(table keys, table entries, ok) as numpy arrays and an int."""
    tk, te, ok = out
    return np.asarray(tk), np.asarray(te), int(np.asarray(ok).reshape(-1)[0])


def _assert_same(got, want, label):
    (tk, te, ok), (wk, we, wok) = _norm(got), _norm(want)
    assert ok == wok, f"{label}: ok {ok} != {wok}"
    if ok:
        np.testing.assert_array_equal(tk, wk, err_msg=f"{label}: table keys")
        np.testing.assert_array_equal(te, we, err_msg=f"{label}: table entries")


def _plain(keys, cap):
    keys = torch.from_numpy(np.asarray(keys, np.int32))
    return _norm(hash_probe.hash_build_insert_plain(keys, cap))


@st.composite
def _insert_case(draw):
    """Capacities 4-256, n from 0 to cap + 2: dense keys 0..40, sparse
    random keys, keys on a few homes, clusters that wrap round the table
    end, and duplicates."""
    cap = 1 << draw(st.integers(2, 8))
    n = draw(st.integers(0, cap + 2))
    mode = draw(st.sampled_from(["dense", "sparse", "homes", "wrap"]))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    if mode == "dense":
        keys = rng.permutation(41)[:n] if n <= 41 else rng.integers(0, 41, n)
    elif mode == "sparse":
        keys = rng.choice(1 << 31, n, replace=False) - (1 << 30)
    elif mode == "homes":
        keys = keys_at(rng.choice(rng.integers(0, cap, 4), n), cap, rng.integers(1 << 20))
    else:
        keys = keys_at((cap + 1 - rng.geometric(0.3, n)) % cap, cap, rng.integers(1 << 20))
    keys = np.asarray(keys, np.int32)
    if n >= 2 and draw(st.integers(0, 3)) == 0:
        i, j = sorted(rng.choice(n, 2, replace=False))
        keys[j] = keys[i]
    return keys, cap


@settings(max_examples=300, deadline=None)
@given(_insert_case())
def test_sweep_matches_sequential_insert(case):
    keys, cap = case
    _assert_same(sweep_insert(keys, cap), _plain(keys, cap), f"cap {cap} n {len(keys)}")


def _named_case(name):
    rng = np.random.default_rng(3)
    if name == "dense_0_40":
        return np.arange(41, dtype=np.int32), 64
    if name == "window_16":  # 16 keys on one home: the last at distance 15
        return keys_at([9] * 16, 64, rng.integers(1 << 20)), 64
    if name == "window_17":  # the 17th at distance 16: overflow
        return keys_at([9] * 17, 64, rng.integers(1 << 20)), 64
    if name == "wrap":  # a cluster across the table's end, among other keys
        homes = np.concatenate([[126, 127, 127, 0, 126, 1, 127], rng.integers(0, 128, 40)])
        return keys_at(homes, 128, rng.integers(1 << 20)), 128
    if name == "duplicate":
        keys = keys_at(rng.integers(0, 256, 100), 256, rng.integers(1 << 20))
        keys[70] = keys[12]
        return keys, 256
    if name == "full":  # n == cap: no slot ends up empty
        return keys_at(rng.permutation(8), 8, rng.integers(1 << 20)), 8
    if name == "full_clustered":
        return keys_at([3, 3, 4, 6, 6, 7, 0, 0], 8, rng.integers(1 << 20)), 8
    if name == "over_cap":
        return keys_at(rng.integers(0, 8, 9), 8, rng.integers(1 << 20)), 8
    raise ValueError(name)


NAMED = ["dense_0_40", "window_16", "window_17", "wrap", "duplicate", "full",
         "full_clustered", "over_cap"]


@pytest.mark.parametrize("name", NAMED)
def test_sweep_matches_reference_kernel(name):
    """The model, the plain version and the reference's Pallas kernel
    (interpret mode) agree: ok always, the tables where ok is 1."""
    keys, cap = _named_case(name)
    want = _norm(ref_hp.hash_build_insert(keys, capacity=cap, interpret=True))
    _assert_same(sweep_insert(keys, cap), want, name)
    _assert_same(_plain(keys, cap), want, name)
    assert want[2] == (0 if name in ("window_17", "duplicate", "over_cap") else 1)


def test_sweep_of_an_empty_batch():
    """n = 0 (the reference's kernel takes no empty batch): a table of
    EMPTY slots and ok 1, as in the plain version."""
    keys = np.zeros(0, np.int32)
    got = sweep_insert(keys, 16)
    _assert_same(got, _plain(keys, 16), "n = 0")
    assert got[2] == 1 and (got[0] == EMPTY).all() and (got[1] == -1).all()


def test_sweep_window_edge_is_16():
    """A home shared by 16 keys fills its window; a 17th overflows."""
    rng = np.random.default_rng(5)
    for count, ok in ((16, 1), (17, 0)):
        keys = keys_at([30] * count, 64, rng.integers(1 << 20))
        assert sweep_insert(keys, 64)[2] == ok
        assert _plain(keys, 64)[2] == ok


@pytest.mark.parametrize("load", [0.36, 0.5])
def test_sweep_at_the_kernels_tiling(load):
    """The kernel's own tiling (4,096-slot tiles, 4 slots a thread) on a
    table of 2^14 slots, with a cluster across the end: at SF 1's load of
    0.36 every window holds (ok 1, tables equal); at 0.5 a run of random
    homes overflows one (ok 0 in both)."""
    rng = np.random.default_rng(11)
    cap = 1 << 14
    homes = np.concatenate([rng.integers(0, cap, int(cap * load) - 8), [cap - 1] * 4, [0] * 4])
    keys = keys_at(homes, cap, rng.integers(1 << 20))
    got = sweep_insert(keys, cap, tile=4096, spt=4)
    _assert_same(got, _plain(keys, cap), f"2^14 slots at load {load}")
    assert got[2] == (1 if load < 0.4 else 0)


def test_sweep_and_plain_clear_ok_on_an_empty_key():
    """A key equal to EMPTY (outside the reference's contract) clears ok in
    both the model of the kernel and the plain version."""
    keys = np.array([5, EMPTY, 9], np.int32)
    assert sweep_insert(keys, 8)[2] == 0
    assert _plain(keys, 8)[2] == 0
    assert sweep_insert(np.array([5, EMPTY, 9, 1, 2, 3, 4, 6], np.int32), 8)[2] == 0
