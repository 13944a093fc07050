"""The port's probe, insert, aggregate and fused-chain kernels against the
reference's.

Every case feeds the same numpy-made inputs to the reference's Pallas
kernel (interpret mode, as the reference's own tests run it) and to the
port's wrapper on CPU tensors, which runs the plain PyTorch version.
Probe and insert outputs are integers, so equality is exact; the
segmented sum accumulates in float32 in the reference, so it is held at
the reference's own tolerance (rtol/atol 1e-4). The fused chain is checked on
``(spec, arrays)`` captured from real reference sessions and on random
chains whose float operands include NaN, ±inf and -0.0. The CUDA kernels
themselves are held against these plain versions in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import graftdb
from graftdb import EngineConfig
from repro.kernels import fused_chain as ref_chain
from repro.kernels import hash_probe as ref_hp
from repro.kernels import ops as ref_ops
from repro.kernels import seg_aggregate as ref_seg
from repro.kernels.ops import build_hash_table
from repro.relational import queries
from repro_torch.kernels import fused_chain, hash_probe, ops, seg_aggregate

torch.set_num_threads(2)

EMPTY = ref_hp.EMPTY


def _t(a):
    """numpy -> CPU int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32))


def _np(t, dtype=np.int32):
    return t.cpu().numpy().view(dtype)


# ---------------------------------------------------------------------------
# constants and the total-order encoding are copies of the reference's
# ---------------------------------------------------------------------------


def test_constants_match_reference():
    assert hash_probe.EMPTY == ref_hp.EMPTY
    assert hash_probe.MAX_PROBE == ref_hp.MAX_PROBE
    assert hash_probe.MULT == ref_hp.MULT


def test_total_order_encoding_matches_reference():
    vals = np.array(
        [-np.inf, -1e300, -1.5, -5e-324, -0.0, 0.0, 5e-324, 1.0, 1e300, np.inf,
         np.nan, -np.nan]
    )
    for a, b in zip(fused_chain.total_order_u32(vals), ref_chain.total_order_u32(vals)):
        np.testing.assert_array_equal(a, b)
    for v in (-np.inf, -0.0, 7.5, np.inf, np.nan):
        assert fused_chain.total_order_bound(v) == ref_chain.total_order_bound(v)


# ---------------------------------------------------------------------------
# B2-B4: hash probes on random tables
# ---------------------------------------------------------------------------


def _colliding_keys(cap, home, count, start):
    """``count`` keys >= start whose hash lands on slot ``home``."""
    out, k = [], start
    while len(out) < count:
        if (k * ref_hp.MULT) & 0xFFFFFFFF & (cap - 1) == home:
            out.append(k)
        k += 1
    return out


def _probe_case(case, seed=0):
    """(probe keys, table keys, slot vis, slot->entry, entry vis lo/hi,
    64-bit lens mask, 32-bit mask of the slot vis) for one named case."""
    rng = np.random.default_rng(seed)
    n = 600
    keys = rng.choice(1 << 20, n, replace=False).astype(np.int64)
    if case == "cluster":
        # one home slot carries a chain longer than MAX_PROBE: the keys past
        # the 16th are unreachable and must miss in both versions
        cap = 1 << int(np.ceil(np.log2(n / 0.5)))
        extra = _colliding_keys(cap, 5, 24, 1 << 21)
        keys = np.concatenate([keys[: n - len(extra)], extra])
    keys = keys.astype(np.int32)
    evlo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    evhi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    if case == "zero_vis":
        dead = rng.random(n) < 0.5
        evlo[dead] = 0
        evhi[dead] = 0
    mask = (np.uint32(1 << 7), np.uint32(0))
    if case == "hi_bits":
        evlo[:] = 0
        mask = (np.uint32(0), np.uint32(1 << 30))
    # the slot-indexed 32-bit words of B4 are the half the mask selects
    half, mask32 = (evhi, mask[1]) if case == "hi_bits" else (evlo, mask[0])
    tk, tv, te = (np.asarray(a) for a in build_hash_table(keys, half))
    miss = (rng.choice(1 << 20, 400) + (1 << 22)).astype(np.int32)
    probe = np.concatenate([keys, miss])
    rng.shuffle(probe)
    return (probe, tk, tv, te, evlo, evhi, np.array(mask, np.uint32),
            np.array([mask32], np.uint32))


CASES = ["misses", "cluster", "hi_bits", "zero_vis"]


@pytest.mark.parametrize("case", CASES)
def test_probe_lens_slot32_matches_reference(case):
    pk, tk, tv, _, _, _, _, m32 = _probe_case(case)
    want = np.asarray(ref_hp.hash_probe_lens(pk, tk, tv, m32, interpret=True))
    got = hash_probe.hash_probe_lens(_t(pk), _t(tk), _t(tv), _t(m32))
    np.testing.assert_array_equal(_np(got), want)
    assert (want >= 0).any() and (want < 0).any()


@pytest.mark.parametrize("case", CASES)
def test_probe_lens64_matches_reference(case):
    pk, tk, _, te, evlo, evhi, mask, _ = _probe_case(case)
    want = np.asarray(
        ref_hp.hash_probe_lens64(pk, tk, te, evlo, evhi, mask, interpret=True)
    )
    got = hash_probe.hash_probe_lens64(  # the mask by value, as a (lo, hi) pair
        _t(pk), _t(tk), _t(te), _t(evlo), _t(evhi), tuple(mask)
    )
    np.testing.assert_array_equal(_np(got), want)
    assert (want >= 0).any()


@pytest.mark.parametrize("case", CASES)
def test_probe_multi64_matches_reference(case):
    pk, tk, _, te, evlo, evhi, _, _ = _probe_case(case)
    want = [np.asarray(a) for a in ref_hp.hash_probe_lens_multi64(
        pk, tk, te, evlo, evhi, interpret=True
    )]
    got = hash_probe.hash_probe_lens_multi64(_t(pk), _t(tk), _t(te), _t(evlo), _t(evhi))
    np.testing.assert_array_equal(_np(got[0]), want[0])
    np.testing.assert_array_equal(_np(got[1], np.uint32), want[1])
    np.testing.assert_array_equal(_np(got[2], np.uint32), want[2])
    if case == "cluster":
        # the colliding keys past the MAX_PROBE window miss
        assert (want[0] < 0).sum() > 400


@pytest.mark.parametrize("case", CASES)
def test_probe_multi_slot32_matches_reference(case):
    """B5: pre-visibility slots and the slots' 32-bit words (zero words in
    ``zero_vis``, high-bit words in ``hi_bits``)."""
    pk, tk, tv, _, _, _, _, _ = _probe_case(case)
    want = [np.asarray(a) for a in ref_hp.hash_probe_lens_multi(pk, tk, tv, interpret=True)]
    got = hash_probe.hash_probe_lens_multi(_t(pk), _t(tk), _t(tv))
    np.testing.assert_array_equal(_np(got[0]), want[0])
    np.testing.assert_array_equal(_np(got[1], np.uint32), want[1])
    assert (want[0] >= 0).any() and (want[0] < 0).any()
    hit_words = want[1][want[0] >= 0]
    if case == "zero_vis":
        assert (hit_words == 0).any()
    if case == "hi_bits":
        assert (hit_words >= 1 << 31).any()


def test_probe_rejects_mixed_devices_and_dtypes():
    pk, tk, tv, _, _, _, _, m32 = _probe_case("misses")
    with pytest.raises(TypeError):
        hash_probe.hash_probe_lens(torch.from_numpy(pk.astype(np.int64)), _t(tk), _t(tv), _t(m32))
    with pytest.raises(ValueError):
        hash_probe.hash_probe_lens(_t(pk), _t(tk[:-1]), _t(tv[:-1]), _t(m32))


# ---------------------------------------------------------------------------
# B1: fused chain on launches captured from reference sessions
# ---------------------------------------------------------------------------


def _capture_launches(db, qs, **cfg):
    """Run a reference session with the chain launch wrapped; return every
    launch's (spec, input arrays, output arrays) as numpy."""
    session = graftdb.connect(db, EngineConfig(backend="pallas", **cfg))
    backend = session.backend
    orig = backend._chain_launch
    calls = []

    def spy(spec, arrays, **kw):
        out = orig(spec, arrays, **kw)
        calls.append((spec, [np.asarray(a) for a in arrays], [np.asarray(o) for o in out]))
        return out

    backend._chain_launch = spy
    session.submit_all(qs)
    session.run()
    return calls


def _grant_wave(db):
    seq = [(750.0, 0.0), (760.0, 0.01), (750.0, 0.02), (800.0, 0.03)]
    return [
        queries.make_query(db, "q3", {"segment": 1.0, "date": d}, arrival=t)
        for d, t in seq
    ]


def _fuzz(db, seed):
    rng = np.random.default_rng(seed)
    qs, t = [], 0.0
    for _ in range(5):
        t += float(rng.choice([0.0, 0.002, 0.02]))
        qs.append(queries.sample_query(db, rng, arrival=t))
    return qs


WORKLOADS = {
    "grants": lambda db: (_grant_wave(db), dict(mode="graft", morsel_size=16384)),
    "residual": lambda db: (_fuzz(db, 42_001), dict(mode="residual", morsel_size=16384)),
}


def _assert_chain_equal(spec, arrays, want):
    n = arrays[0].shape[0]
    flat = fused_chain.chain_launch(spec, [_t(a) for a in arrays])
    got = fused_chain.split_outputs(spec, n, flat.numpy())
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.view(w.dtype), w, err_msg=f"output {i} of {spec}")


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_chain_replays_reference_launches(db, workload):
    qs, cfg = WORKLOADS[workload](db)
    calls = _capture_launches(db, qs, **cfg)
    assert calls, "the reference session launched no chain"
    specs = set()
    for spec, arrays, want in calls:
        _assert_chain_equal(spec, arrays, want)
        specs.add(spec)
    if workload == "grants":
        assert any(st[1] > 0 for spec in specs for st in spec[0]), "no grant stage"
    else:
        assert any(spec[1] for spec in specs), "no build-sink chain"


# ---------------------------------------------------------------------------
# B1: random chains with special float operands
# ---------------------------------------------------------------------------

SPECIALS = np.array(
    [np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-324, -5e-324, 1.5, -1.5, 2.0, 1e300]
)


def _random_chain(seed, n=64):
    """A two-stage chain (host keys, then keys gathered through stage 0),
    each stage with compiled grants and an interval filter over a host
    column and an entry-indexed column, ending in a build sink. Float
    operands and bounds are drawn from ``SPECIALS``."""
    rng = np.random.default_rng(seed)

    def words(*shape):
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)

    def enc(vals):
        return ref_chain.total_order_u32(vals)

    def bounds(shape):
        lo, hi = rng.choice(SPECIALS, shape), rng.choice(SPECIALS, shape)
        lh, ll = enc(lo.ravel())
        hh, hl = enc(hi.ravel())
        return (np.stack([lh, ll], -1).reshape(*shape, 2),
                np.stack([hh, hl], -1).reshape(*shape, 2))

    n_e = 40
    tables = []
    for s in range(2):
        keys = rng.choice(1 << 16, n_e, replace=False).astype(np.int32)
        tk, _, te = (np.asarray(a) for a in build_hash_table(keys, np.ones(n_e, np.uint32)))
        tables.append((keys, tk, te))
    bits_lo, bits_hi = words(n), words(n)
    dead = rng.random(n) < 0.2
    bits_lo[dead] = 0
    bits_hi[dead] = 0
    arrays = [bits_lo, bits_hi]
    stages = []
    for s in range(2):
        keys, tk, te = tables[s]
        if s == 0:
            pick = rng.integers(0, n_e, n)
            k = np.where(rng.random(n) < 0.7, keys[pick], rng.integers(1 << 17, 1 << 18, n))
            arrays.append(k.astype(np.int32))
            key_mode = -1
        else:
            # stage 0's entry-indexed key column points into stage 1's keys
            col = np.where(rng.random(n_e) < 0.8, keys[rng.integers(0, n_e, n_e)], 1 << 20)
            arrays.append(col.astype(np.int32))
            key_mode = 0
        arrays += [tk, te, words(n_e), words(n_e), words(8, 256), words(8, 256)]
        n_g, g_a = 2, 2
        glo, ghi = bounds((n_g, g_a))
        arrays += [words(n_e), words(n_e), words(n_g, 2), words(n_g, 2),
                   rng.integers(0, 2, (n_g, g_a)).astype(np.int32), glo, ghi]
        for _ in range(g_a):
            arrays += list(enc(rng.choice(SPECIALS, n_e)))
        n_m = 3
        srcs = (-1, s)
        for src in srcs:
            arrays += list(enc(rng.choice(SPECIALS, n if src == -1 else n_e)))
        flo, fhi = bounds((n_m, len(srcs)))
        arrays += [flo, fhi, rng.integers(0, 2, (n_m, len(srcs))).astype(np.int32),
                   words(n_m, 2)]
        stages.append((key_mode, n_g, g_a, (n_m, srcs)))
    arrays += [words(8, 256) for _ in range(4)]
    spec = (tuple(stages), True)
    assert len(arrays) == len(ref_chain.input_kinds(spec))
    return spec, arrays


@pytest.mark.parametrize("seed", range(4))
def test_chain_special_float_bounds_match_reference(seed):
    spec, arrays = _random_chain(seed)
    want = [np.asarray(o) for o in ref_chain.chain_launch(spec, tuple(arrays), interpret=True)]
    _assert_chain_equal(spec, arrays, want)
    stats = want[2 + len(spec[0])]
    assert stats[:, 1].sum() > 0  # some rows matched


def test_chain_rejects_unpadded_rows():
    spec, arrays = _random_chain(0, n=64)
    arrays = [a[:60] if k == "row" else a for k, a in zip(ref_chain.input_kinds(spec), arrays)]
    with pytest.raises(ValueError):
        fused_chain.chain_launch(spec, [_t(a) for a in arrays])


# ---------------------------------------------------------------------------
# B6: batch insert into a fresh table
# ---------------------------------------------------------------------------


def _insert_case(case, seed=0):
    """(keys, capacity, expected ok) of one named case; random keys at a
    given load leave ``ok`` to the reference (None)."""
    rng = np.random.default_rng(seed)
    if case == "unique_25":
        return rng.choice(1 << 24, 1000, replace=False), 4096, None
    if case == "unique_50":
        return rng.choice(1 << 24, 1024, replace=False), 2048, None
    cap = 1024
    keys = list(rng.choice(1 << 20, 200, replace=False))
    if case == "home_collisions":
        # chains on shared and neighbouring home slots, one wrapping past
        # the end of the table
        for home, count in ((5, 6), (6, 2), (cap - 2, 4)):
            keys += _colliding_keys(cap, home, count, (1 << 21) + 1000 * home)
        rng.shuffle(keys)
        return np.array(keys), cap, 1
    if case == "duplicate":
        keys.insert(200, keys[17])
        return np.array(keys), cap, 0
    if case == "cluster":
        # 24 keys on one home slot: the 17th finds no EMPTY slot in its window
        keys[100:100] = _colliding_keys(cap, 9, 24, 1 << 21)
        return np.array(keys), cap, 0
    raise ValueError(case)


@pytest.mark.parametrize(
    "case", ["unique_25", "unique_50", "home_collisions", "duplicate", "cluster"]
)
def test_build_insert_matches_reference(case):
    keys, cap, ok = _insert_case(case)
    keys = np.asarray(keys, np.int32)
    want = [np.asarray(a) for a in ref_hp.hash_build_insert(keys, capacity=cap, interpret=True)]
    got = hash_probe.hash_build_insert(_t(keys), cap)
    assert ok is None or int(want[2][0]) == ok
    for g, w in zip(got, want):  # layout and ok, also where ok is 0
        np.testing.assert_array_equal(_np(g), w)


# ---------------------------------------------------------------------------
# B7: segmented sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,v,g", [(100, 1, 8), (3000, 8, 64), (10000, 4, 200)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_seg_aggregate_matches_reference(n, v, g, dtype):
    """The reference's sweep (``test_kernels.py``), with pad codes (-1 and
    >= G) that must match no group."""
    rng = np.random.default_rng(n + v + g)
    codes = rng.integers(-1, g + 2, n).astype(np.int32)
    vals = rng.normal(size=(n, v)).astype(dtype)
    want = np.asarray(ref_seg.seg_aggregate(codes, vals, g, interpret=True))
    got = ops.segmented_sum(codes, vals, g, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (g, v)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_seg_aggregate_plain_fixes_the_kernel_order():
    """The plain version adds in the CUDA kernel's order: per chunk of
    ``seg_chunk(V)`` rows in ascending row order into a float64, then the
    chunk partials in chunk order, one rounding to float32. Held bit for
    bit against that order written out in Python."""
    rng = np.random.default_rng(3)
    n, v, g = 1500, 2, 6
    codes = rng.integers(-1, g + 1, n).astype(np.int32)
    vals = (rng.normal(size=(n, v)) * 10.0 ** rng.integers(-6, 7, (n, v))).astype(np.float32)
    got = seg_aggregate.seg_aggregate(_t(codes), torch.from_numpy(vals), g).numpy()
    chunk = seg_aggregate.seg_chunk(v)
    want = np.zeros((g, v), np.float64)
    for b in range(0, n, chunk):
        part = np.zeros((g, v), np.float64)
        for r in range(b, min(n, b + chunk)):
            if 0 <= codes[r] < g:
                part[codes[r]] += vals[r].astype(np.float64)
        want += part
    np.testing.assert_array_equal(got, want.astype(np.float32))


# ---------------------------------------------------------------------------
# kernels/ops.py against the reference's ops.py
# ---------------------------------------------------------------------------


def test_ops_build_and_probe_match_reference():
    rng = np.random.default_rng(11)
    keys = rng.choice(1 << 20, 700, replace=False).astype(np.int32)
    vis = rng.integers(0, 1 << 32, 700, dtype=np.uint64).astype(np.uint32)
    want = [np.asarray(a) for a in ref_ops.build_hash_table(keys, vis)]
    got = ops.build_hash_table(keys, vis, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g, w.dtype), w)
    pk = np.concatenate([keys[::3], (rng.choice(1 << 20, 200) + (1 << 21)).astype(np.int32)])
    qm = np.uint32(1 << 31)
    want_p = np.asarray(ref_ops.probe(pk, *want[:2], qm, interpret=True))
    np.testing.assert_array_equal(_np(ops.probe(pk, *got[:2], qm, device="cpu")), want_p)


@pytest.mark.parametrize("n", [64, 1000])
def test_ops_build_insert_matches_reference(n):
    """The default capacity (<= 25% load) and the table it gives."""
    keys = np.random.default_rng(n).choice(1 << 20, n, replace=False).astype(np.int32)
    want = [np.asarray(a) for a in ref_ops.build_insert(keys, interpret=True)]
    got = ops.build_insert(keys, device="cpu")
    assert got[0].shape[0] == want[0].shape[0] >= 4 * n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), w)
