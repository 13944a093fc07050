"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. The inputs are made with numpy from a seed. Probe and insert outputs
are integers, so equality is exact; the segmented sum and the linear
recurrence fix the order of their float operations, and their plain
versions repeat that order, so they are held bit for bit too. Flash
attention adds its products in another order than its plain version, so
it is held within limits: rtol 1e-5 / atol 1e-4 in float32 (the
reference's), and in bf16 2e-2 |want| + 0.1 rms(want's row), the row
being one query's output vector (the reference's atol of 0.2 would pass
an output that left out a 64-key tile).

This file imports neither JAX nor the reference package, so it also runs
on a machine that has only PyTorch; there, run it without the repository's
``conftest.py``:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Every case needs a card and skips where none is visible.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_traces import burst_trace
from repro_torch.kernels import _build, flash_attention, fused_chain, hash_probe, linrec
from repro_torch.kernels import ref, seg_aggregate
from repro_torch.kernels.fused_chain import total_order_u32
from repro_torch.kernels.hash_probe import EMPTY, MULT, keys_at

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _t(a, dev="cpu"):
    """numpy -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32)).to(dev)


def _table(keys, load=0.5):
    """Open-addressing table by unbounded linear probing in key order:
    (table keys, slot -> entry id)."""
    cap = 8
    while cap < len(keys) / load:
        cap *= 2
    tk = np.full(cap, EMPTY, np.int32)
    te = np.full(cap, -1, np.int32)
    for i, k in enumerate(keys):
        p = (int(k) * MULT) & 0xFFFFFFFF & (cap - 1)
        while tk[p] != EMPTY:
            p = (p + 1) & (cap - 1)
        tk[p], te[p] = k, i
    return tk, te


def _words(rng, *shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _probe_inputs(case, seed=0, n=4000):
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 20, n, replace=False).astype(np.int64)
    if case == "cluster":
        # a chain longer than MAX_PROBE on one home slot
        cap = 8
        while cap < n / 0.5:
            cap *= 2
        extra, k = [], 1 << 21
        while len(extra) < 24:
            if (k * MULT) & 0xFFFFFFFF & (cap - 1) == 5:
                extra.append(k)
            k += 1
        keys = np.concatenate([keys[: n - 24], extra])
    keys = keys.astype(np.int32)
    tk, te = _table(keys)
    evlo, evhi = _words(rng, n), _words(rng, n)
    if case == "zero_vis":
        dead = rng.random(n) < 0.5
        evlo[dead] = 0
        evhi[dead] = 0
    tv = np.where(te >= 0, evlo[np.maximum(te, 0)], 0).astype(np.uint32)
    probe = np.concatenate([keys, (rng.choice(1 << 20, n) + (1 << 22)).astype(np.int32)])
    rng.shuffle(probe)
    mask = np.array([1 << 7, 1 << 30], np.uint32)
    return probe, tk, tv, te, evlo, evhi, mask


@pytest.mark.parametrize("case", ["misses", "cluster", "zero_vis"])
def test_cuda_probes_match_plain(cuda, case):
    arrays = _probe_inputs(case)
    k, tk, tv, te, lo, hi, m = (_t(a, cuda) for a in arrays)
    c = [_t(a) for a in arrays]
    got = hash_probe.hash_probe_lens(k, tk, tv, c[6][:1])  # the masks on the host
    assert torch.equal(got.cpu(), hash_probe.hash_probe_lens_plain(c[0], c[1], c[2], c[6][:1]))
    got = hash_probe.hash_probe_lens64(k, tk, te, lo, hi, c[6])
    want = hash_probe.hash_probe_lens64_plain(c[0], c[1], c[3], c[4], c[5], c[6])
    assert torch.equal(got.cpu(), want)
    got = hash_probe.hash_probe_lens_multi64(k, tk, te, lo, hi)
    want = hash_probe.hash_probe_lens_multi64_plain(c[0], c[1], c[3], c[4], c[5])
    buf = got[0]._base  # the three rows of one [3, N] buffer
    assert buf.is_cuda and tuple(buf.shape) == (3, k.shape[0])
    assert all(g._base is buf for g in got)
    assert torch.equal(buf.cpu(), want[0]._base)
    with pytest.raises(TypeError, match="query_mask"):  # a mask on the card
        hash_probe.hash_probe_lens(k, tk, tv, m[:1])
    torch.cuda.synchronize()


@pytest.mark.parametrize("mask", [0, 1, 1 << 31, 0x55555555, 0xFFFFFFFF])
def test_cuda_probe_lens_mask_values(cuda, mask):
    """B4's 32-bit mask by value: no bit, the lowest, the highest, every
    other bit and all bits, against the plain version."""
    probe, tk, tv, *_ = _probe_inputs("zero_vis", seed=mask & 0xFF)
    want = hash_probe.hash_probe_lens_plain(_t(probe), _t(tk), _t(tv), mask)
    got = hash_probe.hash_probe_lens(_t(probe, cuda), _t(tk, cuda), _t(tv, cuda), mask)
    assert torch.equal(got.cpu(), want)
    assert int((want >= 0).sum()) > 0 or mask == 0


SPECIALS = np.array(
    [np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-324, -5e-324, 1.5, -1.5, 2.0, 1e300]
)


def _chain_inputs(seed, n=4096, n_e=3000, n_stages=2, lenient=False):
    """``n_stages`` stages (host keys, then keys gathered through the
    previous stage's entries), each with compiled grants and an interval
    filter over a host and an entry-indexed column, ending in a build sink;
    float operands drawn from ``SPECIALS``. ``lenient`` makes every key hit
    and leaves every filter attr unconstrained, so rows live through a long
    chain."""
    rng = np.random.default_rng(seed)

    def enc(vals):
        return list(total_order_u32(vals))

    def bounds(shape):
        lh, ll = total_order_u32(rng.choice(SPECIALS, shape).ravel())
        hh, hl = total_order_u32(rng.choice(SPECIALS, shape).ravel())
        return (np.stack([lh, ll], -1).reshape(*shape, 2),
                np.stack([hh, hl], -1).reshape(*shape, 2))

    bits_lo, bits_hi = _words(rng, n), _words(rng, n)
    dead = rng.random(n) < 0.2
    bits_lo[dead] = 0
    bits_hi[dead] = 0
    arrays, stages = [bits_lo, bits_hi], []
    for s in range(n_stages):
        keys = rng.choice(1 << 22, n_e, replace=False).astype(np.int32)
        tk, te = _table(keys)
        hit = 1.0 if lenient else 0.7 if s == 0 else 0.8
        if s == 0:
            hits = keys[rng.integers(0, n_e, n)]
            arrays.append(np.where(rng.random(n) < hit, hits, rng.integers(1 << 23, 1 << 24, n))
                          .astype(np.int32))
        else:
            arrays.append(np.where(rng.random(n_e) < hit, keys[rng.integers(0, n_e, n_e)],
                                   1 << 25).astype(np.int32))
        arrays += [tk, te, _words(rng, n_e), _words(rng, n_e), _words(rng, 8, 256),
                   _words(rng, 8, 256)]
        glo, ghi = bounds((2, 2))
        arrays += [_words(rng, n_e), _words(rng, n_e), _words(rng, 2, 2), _words(rng, 2, 2),
                   rng.integers(0, 2, (2, 2)).astype(np.int32), glo, ghi]
        arrays += enc(rng.choice(SPECIALS, n_e)) + enc(rng.choice(SPECIALS, n_e))
        srcs = (-1, s)
        arrays += enc(rng.choice(SPECIALS, n)) + enc(rng.choice(SPECIALS, n_e))
        flo, fhi = bounds((3, 2))
        fcon = rng.integers(0, 2, (3, 2)).astype(np.int32) * (not lenient)
        arrays += [flo, fhi, fcon, _words(rng, 3, 2)]
        stages.append((-1 if s == 0 else s - 1, 2, 2, (3, srcs)))
    arrays += [_words(rng, 8, 256) for _ in range(4)]
    return (tuple(stages), True), arrays


@pytest.mark.parametrize("seed", range(3))
def test_cuda_chain_matches_plain(cuda, seed):
    spec, arrays = _chain_inputs(seed)
    want = fused_chain.chain_plain(spec, [_t(a) for a in arrays])
    got = fused_chain.chain_launch(spec, [_t(a, cuda) for a in arrays])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    stats = fused_chain.split_outputs(spec, len(arrays[0]), want)[2 + len(spec[0])]
    assert int(stats[:, 1].sum()) > 0  # rows matched


@pytest.mark.parametrize("n", [8, 16, 128, 256, 512, 4096, 65_536, 1 << 17])
def test_cuda_chain_row_counts(cuda, n):
    """Power-of-two row counts below, at and above one 256-row tile, up to
    2^17 rows, where the persistent grid (as many blocks as the card holds
    at once) strides over 512 tiles."""
    spec, arrays = _chain_inputs(5, n=n, n_e=500)
    want = fused_chain.chain_plain(spec, [_t(a) for a in arrays])
    got = fused_chain.chain_launch(spec, [_t(a, cuda) for a in arrays])
    assert torch.equal(got.cpu(), want)


def test_cuda_chain_most_stages(cuda):
    """A spec of ``MAX_STAGES`` stages with grants, filters and a sink,
    which launches the kernel's large parameter struct."""
    spec, arrays = _chain_inputs(6, n=2048, n_e=400, n_stages=fused_chain.MAX_STAGES,
                                 lenient=True)
    want = fused_chain.chain_plain(spec, [_t(a) for a in arrays])
    got = fused_chain.chain_launch(spec, [_t(a, cuda) for a in arrays])
    assert torch.equal(got.cpu(), want)
    stats = fused_chain.split_outputs(spec, 2048, want)[2 + len(spec[0])]
    assert int(stats[-1, 1]) > 0  # rows match at the last stage, past the staged tables


@pytest.mark.parametrize("slot", [0, 31, 32, 63])
def test_cuda_probe_lens64_mask_slots(cuda, slot):
    """The lens mask by value, on each half's first and last slot, as a
    (lo, hi) pair and as a CPU tensor."""
    probe, tk, _, te, lo, hi, _ = _probe_inputs("zero_vis", seed=slot)
    bit = 1 << slot
    pair = (bit & 0xFFFFFFFF, bit >> 32)
    want = hash_probe.hash_probe_lens64_plain(_t(probe), _t(tk), _t(te), _t(lo), _t(hi), pair)
    args = [_t(a, cuda) for a in (probe, tk, te, lo, hi)]
    for mask in (pair, _t(np.array(pair, np.uint32))):
        assert torch.equal(hash_probe.hash_probe_lens64(*args, mask).cpu(), want)
    assert int((want >= 0).sum()) > 0 and int((want < 0).sum()) > 0


def test_cuda_launch_path_does_not_synchronize(cuda):
    """No wrapper of B1-B4 waits for the card: each runs under
    ``set_sync_debug_mode("error")``, which raises on any call that would."""
    spec, arrays = _chain_inputs(9, n=4096, n_e=500)
    chain_in = [_t(a, cuda) for a in arrays]
    probe, tk, tv, te, lo, hi, mask = _probe_inputs("misses")
    probe_in = [_t(a, cuda) for a in (probe, tk, te, lo, hi)]
    slot_in = [_t(a, cuda) for a in (probe, tk, tv)]
    pair = tuple(int(w) for w in mask)

    def calls():
        return (fused_chain.chain_launch(spec, chain_in),
                hash_probe.hash_probe_lens64(*probe_in, pair),
                hash_probe.hash_probe_lens(*slot_in, pair[0]),
                hash_probe.hash_probe_lens_multi64(*probe_in)[0]._base)

    calls()  # builds and binds first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = calls()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[0].cpu(), fused_chain.chain_plain(spec, [_t(a) for a in arrays]))
    host = [_t(a) for a in (probe, tk, te, lo, hi)]
    assert torch.equal(got[1].cpu(), hash_probe.hash_probe_lens64_plain(*host, pair))
    assert torch.equal(got[2].cpu(), hash_probe.hash_probe_lens_plain(
        *(_t(a) for a in (probe, tk, tv)), pair[0]))
    assert torch.equal(got[3].cpu(), hash_probe.hash_probe_lens_multi64_plain(*host)[0]._base)


@pytest.mark.parametrize("name", ["probe_chain", "probe_visible", "probe", "probe_visible_multi"])
def test_cuda_backend_calls_wait_once(cuda, name):
    """Each call of a session's backend to the chain (B1), the lens probe
    (B2), the plain probe (B4) or the multi-member probe (B3) that launches
    its kernel, made again at once on its own arguments, waits once:
    everything but its one wait runs under ``set_sync_debug_mode("error")``,
    and the wait is counted. The first call brings the mirrors and buffers
    up to date; the second gives its result. The chain runs member-major;
    the other probes come from the per-member loops of sampled queries, and
    the multi-member probe from two concurrent q5s."""
    import graftdb_torch
    from repro_torch.api.backends import TorchBackend
    from repro_torch.relational import queries, tpch

    db = tpch.get_database(0.01, seed=7)
    rng = np.random.default_rng(7)
    if name == "probe_visible_multi":
        qs = [queries.make_query(db, "q5", {"region": 1.0, "date": d}, arrival=0.0)
              for d in (730.0, 800.0)]
    else:
        qs = [queries.sample_query(db, rng, arrival=0.01 * i) for i in range(6)]
    member_major = name in ("probe_chain", "probe_visible_multi")
    backend = TorchBackend(device="cuda")
    orig, stage, waits = getattr(backend, name), backend._staging, []

    def wait():
        waits[-1] += 1
        torch.cuda.set_sync_debug_mode(0)
        try:
            torch.cuda.synchronize(cuda)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    def launches():
        return backend.kernel_probes + backend.chain_launches

    def twice(*args, **kw):
        before = launches()
        want = orig(*args, **kw)
        if want is None or launches() == before:  # declined, or the host probe served it
            return want
        waits.append(0)
        stage.wait = wait
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = orig(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            del stage.wait
        pairs = ([(got[k], want[k]) for k in want if k != "entries"]
                 + list(zip(got["entries"], want["entries"])) if name == "probe_chain"
                 else zip(got, want))
        for g, w in pairs:
            np.testing.assert_array_equal(g, w)
        return want

    setattr(backend, name, twice)
    session = graftdb_torch.connect(db, graftdb_torch.EngineConfig(
        backend=backend, mode="graft", member_major=member_major))
    session.submit_all(qs)
    session.run()
    assert waits and waits == [1] * len(waits), waits


def test_cuda_wrappers_count_launches(cuda):
    arrays = _probe_inputs("misses")
    k, tk, tv, te, lo, hi, m = (_t(a, cuda) for a in arrays)
    c = [_t(a) for a in arrays]
    before = _build.launch_counts().get("hash_probe_lens64", 0)
    hash_probe.hash_probe_lens64(k, tk, te, lo, hi, c[6])
    assert _build.launch_counts()["hash_probe_lens64"] == before + 1
    hash_probe.hash_probe_lens64(c[0], c[1], c[3], c[4], c[5], c[6])  # plain: not counted
    assert _build.launch_counts()["hash_probe_lens64"] == before + 1


@pytest.mark.parametrize("case", ["misses", "cluster", "zero_vis"])
def test_cuda_probe_multi_slot32_matches_plain(cuda, case):
    probe, tk, tv, *_ = _probe_inputs(case)
    got = hash_probe.hash_probe_lens_multi(_t(probe, cuda), _t(tk, cuda), _t(tv, cuda))
    want = hash_probe.hash_probe_lens_multi_plain(_t(probe), _t(tk), _t(tv))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int((want[0] >= 0).sum()) > 0


def test_cuda_probe_multi_rows_of_one_buffer(cuda):
    """B5's card wrapper returns slot and word as the rows of one int32
    ``[2, N]`` tensor, as the plain version does."""
    probe, tk, tv, *_ = _probe_inputs("misses")
    got = hash_probe.hash_probe_lens_multi(_t(probe, cuda), _t(tk, cuda), _t(tv, cuda))
    buf = got[0]._base
    assert buf is not None and buf.is_cuda and buf.dtype == torch.int32
    assert tuple(buf.shape) == (2, len(probe))
    for row, g in enumerate(got):
        assert g._base is buf and g.data_ptr() == buf[row].data_ptr()
    want = hash_probe.hash_probe_lens_multi_plain(_t(probe), _t(tk), _t(tv))
    assert torch.equal(buf.cpu(), want[0]._base)


def _insert_keys(case, n=3000):
    """(keys, capacity, expected ok) of one case."""
    rng = np.random.default_rng(7)
    keys = rng.choice(1 << 24, n, replace=False).astype(np.int32)
    if case == "unique":
        return keys, 8192, 1
    if case == "duplicate":
        keys[n // 2] = keys[n // 3]
        return keys, 8192, 0
    if case == "cluster":
        extra, k = [], 1 << 25
        while len(extra) < 20:
            if (k * MULT) & 0xFFFFFFFF & 8191 == 77:
                extra.append(k)
            k += 1
        keys[100:120] = extra
        return keys, 8192, 0
    if case == "dense_2^20":  # 2^20 keys into 2^21 slots, every window holds
        return rng.permutation(1 << 20).astype(np.int32), 1 << 21, 1
    if case == "random_2^20":  # the same size, one window overflows
        return rng.choice(1 << 30, 1 << 20, replace=False).astype(np.int32), 1 << 21, 0
    if case == "wrap":  # clusters across the table's end among distinct homes
        homes = np.concatenate([[8191] * 6, [0] * 6, 8 + rng.choice(8176, 2940, replace=False)])
        return keys_at(homes, 8192, rng.integers(1 << 20)), 8192, 1
    if case in ("window_16", "window_17"):  # the last key at distance 15 / 16
        count = int(case[-2:])
        cluster = keys_at([40] * count, 8192, rng.integers(1 << 20))
        return np.concatenate([cluster, keys[:500]]), 8192, count == 16
    if case == "full":  # n == cap: no slot ends up empty
        return keys_at(rng.permutation(8), 8, rng.integers(1 << 20)), 8, 1
    if case == "empty":
        return keys[:0], 64, 1
    raise ValueError(case)


@pytest.mark.parametrize("case", ["unique", "duplicate", "cluster", "dense_2^20", "random_2^20",
                                  "wrap", "window_16", "window_17", "full", "empty"])
def test_cuda_build_insert_matches_plain(cuda, case):
    """Tables equal where ``ok`` is 1 (a failing segment of the sweep stops
    where it fails, the plain version goes on); ``ok`` always."""
    keys, cap, ok = _insert_keys(case)
    got = hash_probe.hash_build_insert(_t(keys, cuda), cap)
    want = hash_probe.hash_build_insert_plain(_t(keys), cap)
    assert torch.equal(got[2].cpu(), want[2])
    assert int(want[2][0]) == ok
    if ok:
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


def _seg_inputs(n, v, g, seed=0, specials=False):
    """Codes in [-1, G]: -1 and G match no group. Values over nine orders
    of magnitude; with ``specials``, a few rows hold -0.0, +-inf or NaN."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-1, g + 1, n).astype(np.int32)
    vals = (rng.normal(size=(n, v)) * 10.0 ** rng.integers(-4, 5, (n, v))).astype(np.float32)
    if specials and n:
        rows = rng.choice(n, min(n, 6), replace=False)
        vals[rows] = rng.choice(np.array([-0.0, np.inf, -np.inf, np.nan], np.float32),
                                (len(rows), v))
    return torch.from_numpy(codes), torch.from_numpy(vals)


def _same_bits(got, want):
    """Equal bits everywhere, and NaN exactly where ``want`` is NaN (IEEE
    754 leaves a NaN's sign and payload open, and x86 and the card choose
    differently)."""
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got.view(torch.int32)[~nan], want.view(torch.int32)[~nan])


_SEG_CASES = [(n, v, g) for g in (1, 8, 4096, 65_536) for n in (0, 1, 511, 512, 513, 129_246)
              for v in (1, 8)] + [(100, 1, 8), (65_536, 1, 4096), (3000, 8, 64)]


@pytest.mark.parametrize("n,v,g", _SEG_CASES)
def test_cuda_seg_aggregate_matches_plain(cuda, n, v, g):
    """Bit for bit against the plain version on the CPU and on the card,
    with -0.0, +-inf and NaN among the values: chunk edges (511, 512, 513
    rows), one group to more groups than a block has threads or shared
    memory holds, and the engine's largest call (129,246 rows)."""
    codes, vals = _seg_inputs(n, v, g, seed=n + v + g, specials=True)
    got = seg_aggregate.seg_aggregate(codes.to(cuda), vals.to(cuda), g)
    want = seg_aggregate.seg_aggregate_plain(codes, vals, g)
    assert got.shape == want.shape and _same_bits(got, want)
    on_card = seg_aggregate.seg_aggregate_plain(codes.to(cuda), vals.to(cuda), g)
    assert _same_bits(got, on_card)


def test_cuda_seg_aggregate_is_deterministic(cuda):
    codes, vals = _seg_inputs(65_536, 1, 4096, seed=1)
    codes, vals = codes.to(cuda), vals.to(cuda)
    a = seg_aggregate.seg_aggregate(codes, vals, 4096)
    b = seg_aggregate.seg_aggregate(codes, vals, 4096)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_cuda_optin_wrappers_count_launches(cuda):
    probe, tk, tv, *_ = _probe_inputs("misses")
    codes, vals = _seg_inputs(1000, 1, 8)
    calls = {
        "hash_probe_lens_multi": lambda d: hash_probe.hash_probe_lens_multi(
            _t(probe, d), _t(tk, d), _t(tv, d)),
        "hash_build_insert": lambda d: hash_probe.hash_build_insert(_t(probe[:1000], d), 4096),
        "seg_aggregate": lambda d: seg_aggregate.seg_aggregate(codes.to(d), vals.to(d), 8),
    }
    for name, call in calls.items():
        before = _build.launch_counts().get(name, 0)
        call(cuda)
        assert _build.launch_counts()[name] == before + 1
        call("cpu")  # plain: not counted
        assert _build.launch_counts()[name] == before + 1


def _attention_inputs(bh, s, dh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(bh, s, dh)).astype(np.float32)).to(dtype)
            for _ in range(3)]


def _assert_attention_close(got, want):
    """float32: rtol 1e-5 / atol 1e-4; bf16: |got - want| <= 2e-2 |want| +
    0.1 rms(want's row) everywhere."""
    assert got.dtype == want.dtype
    bf16 = got.dtype == torch.bfloat16
    got, want = got.cpu().float(), want.cpu().float()
    if not bf16:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        return
    diff = (got - want).abs()
    limit = 2e-2 * want.abs() + 0.1 * want.square().mean(-1, keepdim=True).sqrt()
    assert bool((diff <= limit).all()), f"off by {float(diff.max())}"


@pytest.mark.parametrize("s", [128, 512, 4096])
@pytest.mark.parametrize("dh", [64, 100, 120, 128, 256])
@pytest.mark.parametrize("window", [None, 1, 64, 200, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_flash_attention_matches_plain(cuda, s, dh, window, dtype):
    """Every width tier (dh 120 reads zeros past its rows; bf16 dh 100 is
    padded to 128 by the wrapper), windows from 1 key to wider than S."""
    q, k, v = (t.to(cuda) for t in _attention_inputs(3 if s <= 512 else 1, s, dh, dtype, seed=dh))
    got = flash_attention.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    _assert_attention_close(got, flash_attention.flash_attention_plain(q, k, v, window))
    _assert_attention_close(got, ref.flash_attention_ref(q, k, v, window=window))


def _attention_kernels(q, k, v):
    """Names of the CUDA kernels one ``flash_attention`` call launches (after
    a warm-up call that builds the library), and the launches it counts."""
    flash_attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    before = _build.launch_counts().get("flash_attention", 0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        flash_attention.flash_attention(q, k, v, window=64)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return names, _build.launch_counts()["flash_attention"] - before


@pytest.mark.parametrize("dh", [100, 128])
def test_cuda_flash_attention_is_one_kernel(cuda, dh):
    """A bf16 call launches one attention kernel (the padding of dh 100 is
    PyTorch's own copies), and counts one launch."""
    q, k, v = (t.to(cuda) for t in _attention_inputs(2, 256, dh, torch.bfloat16))
    names, counted = _attention_kernels(q, k, v)
    assert sum("fa_tc_kernel" in n for n in names) == 1, names
    assert not any("fa_kernel" in n or "fa_tf32x3_kernel" in n for n in names), names
    assert counted == 1


@pytest.mark.parametrize("dh", [100, 128])
def test_cuda_flash_attention_f32_is_one_kernel(cuda, dh):
    """A float32 call launches one tensor-core kernel, the three-TF32-product
    one, and none of the CUDA-core kernel it replaced."""
    q, k, v = (t.to(cuda) for t in _attention_inputs(2, 256, dh, torch.float32))
    names, counted = _attention_kernels(q, k, v)
    assert sum("fa_tf32x3_kernel" in n for n in names) == 1, names
    assert not any("fa_kernel" in n or "fa_tc_kernel" in n for n in names), names
    assert counted == 1


def _linrec_inputs(b, s, d):
    rng = np.random.default_rng(s + d)
    a = torch.from_numpy(rng.uniform(0.7, 0.999, size=(b, s, d)).astype(np.float32))
    bb = torch.from_numpy((rng.normal(size=(b, s, d)) * 0.2).astype(np.float32))
    return a, bb


# blocks of 4 chunks (256 steps): S = 256 is one group, 768 three, 4,352
# seventeen, 8,192 thirty-two a strip; D = 4,096 is 128 strips of a row
@pytest.mark.parametrize("b,s,d", [(1, 256, 128), (2, 1024, 256), (3, 512, 384), (1, 256, 4096),
                                   (1, 768, 128), (2, 8192, 256), (1, 4352, 384)])
def test_cuda_linrec_matches_plain(cuda, b, s, d):
    a, bb = _linrec_inputs(b, s, d)
    got = linrec.linrec(a.to(cuda), bb.to(cuda))
    assert torch.equal(got.cpu(), linrec.linrec_plain(a, bb))
    on_card = linrec.linrec_plain(a.to(cuda), bb.to(cuda))
    assert torch.equal(on_card.cpu(), got.cpu())


@pytest.mark.parametrize("s", [256, 768, 4096, 4352])
def test_cuda_linrec_is_one_kernel(cuda, s):
    """A call launches one kernel (beside the memset of its tickets and
    flags), a block per group of 4 chunks of a 32-channel strip, and counts
    one launch."""
    a, bb = (t.to(cuda) for t in _linrec_inputs(1, s, 128))
    before = _build.launch_counts().get("linrec", 0)
    linrec.linrec(a, bb)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        linrec.linrec(a, bb)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith("Mem")]
    assert len(names) == 1 and "lr_chain_kernel" in names[0], names
    assert _build.launch_counts()["linrec"] == before + 2
    info = linrec.launch_info((1, s, 128))
    assert info["blocks"] == -(-s // 256) * 4 and info["threads"] == 128
    assert info["blocks_per_sm"] >= 1


def test_cuda_kernel_ops_wrappers_count_launches(cuda):
    q, k, v = _attention_inputs(1, 128, 64, torch.float32)
    a = torch.full((1, 256, 128), 0.9)
    calls = {
        "flash_attention": lambda d: flash_attention.flash_attention(
            q.to(d), k.to(d), v.to(d), window=64),
        "linrec": lambda d: linrec.linrec(a.to(d), a.to(d)),
    }
    for name, call in calls.items():
        before = _build.launch_counts().get(name, 0)
        call(cuda)
        assert _build.launch_counts()[name] == before + 1
        call("cpu")  # plain: not counted
        assert _build.launch_counts()[name] == before + 1


def test_cuda_flash_attention_refuses_wide_heads(cuda):
    q = torch.zeros(1, 128, 512, device=cuda)
    before = _build.launch_counts().get("flash_attention", 0)
    with pytest.raises(ValueError, match="head width"):
        flash_attention.flash_attention(q, q, q)
    assert _build.launch_counts().get("flash_attention", 0) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_flash_attention_takes_offset_views(cuda, dtype):
    """Contiguous views that start one element into their storage, off the
    16-byte boundary the kernels read from, are copied by the wrapper and
    give the plain version's result."""
    bh, s, dh = 2, 256, 64
    q, k, v = (torch.cat([t.flatten()[:1], t.flatten()]).to(cuda)[1:].view(bh, s, dh)
               for t in _attention_inputs(bh, s, dh, dtype))
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    got = flash_attention.flash_attention(q, k, v, window=64)
    torch.cuda.synchronize()
    _assert_attention_close(got, flash_attention.flash_attention_plain(q, k, v, 64))


@pytest.mark.parametrize("is_bf16", [0, 1], ids=["f32", "bf16"])
def test_cuda_flash_attention_entry_refuses_misaligned(cuda, is_bf16):
    """The C entry point refuses a base address off the 16-byte boundary
    (cudaErrorInvalidValue) and launches nothing, so the card goes on."""
    buf = torch.zeros(128 * 64 + 8, device=cuda)
    o = torch.empty(128 * 64, device=cuda)
    fn = _build.bind("flash_attention", "fa_flash_attention", 4, 6, 1)
    for base in (buf.data_ptr() + 4, buf.data_ptr() + 8):
        err = fn(base, buf.data_ptr(), buf.data_ptr(), o.data_ptr(), 1, 128, 64, 0, is_bf16, 64,
                 _build.stream_ptr(cuda))
        assert err == 1  # cudaErrorInvalidValue
    torch.cuda.synchronize()
    q, k, v = (t.to(cuda) for t in _attention_inputs(1, 128, 64, torch.float32))
    _assert_attention_close(flash_attention.flash_attention(q, k, v),
                            flash_attention.flash_attention_plain(q, k, v))


def test_cuda_stream_ptr_is_current_stream(cuda):
    """``_build.stream_ptr`` reads the raw handle of PyTorch's current
    stream; it is the one ``torch.cuda.current_stream`` names, on the
    default stream and on a side stream, so the kernels launch in order
    with PyTorch's own work."""
    assert _build.stream_ptr(cuda) == torch.cuda.current_stream(cuda).cuda_stream
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        assert _build.stream_ptr(cuda) == side.cuda_stream != 0
        assert _build.stream_ptr(torch.device("cuda", 0)) == side.cuda_stream
    assert _build.stream_ptr(cuda) == torch.cuda.current_stream(cuda).cuda_stream


def test_cuda_seg_launch_fills_buffers(cuda):
    """``seg_launch`` into ``seg_buffers`` (the wrapper's own two steps, which
    ``chip_smoke.py`` times) gives the plain version's bits and counts one
    launch."""
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(-2, 40, 3000).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(3000, 2)).astype(np.float32))
    partial, out = seg_aggregate.seg_buffers(37, vals.to(cuda))
    before = _build.launch_counts().get("seg_aggregate", 0)
    seg_aggregate.seg_launch(codes.to(cuda), vals.to(cuda), partial, out)
    assert _build.launch_counts()["seg_aggregate"] == before + 1
    want = seg_aggregate.seg_aggregate_plain(codes, vals, 37)
    assert torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# the reuse and fault planes on the card
# ---------------------------------------------------------------------------

_REPEAT = [
    ("q3", {"segment": 1.0, "date": 750.0}),
    ("q6", {"date": 400.0, "discount": 0.05, "quantity": 25.0}),
    ("q3", {"segment": 1.0, "date": 750.0}),
    ("q3", {"segment": 1.0, "date": 800.0}),
    ("q3", {"segment": 1.0, "date": 750.0}),
    ("q10", {"date": 500.0}),
    ("q3", {"segment": 1.0, "date": 800.0}),
    ("q10", {"date": 500.0}),
]


def _small_db():
    from repro_torch.relational import tpch

    return tpch.get_database(0.01, seed=7)


@pytest.mark.parametrize("optin", [False, True], ids=["default", "opt_in"])
def test_cuda_reuse_fault_twin(cuda, optin):
    """A repeat trace with every retirement spilling into a cache whose
    small memory tier demotes to the disk tier, under a FaultPlan: the card
    and the CPU give identical statuses, results, counters, backend stats
    and clocks."""
    import graftdb_torch
    from repro_torch.api.backends import TorchBackend
    from repro_torch.relational import queries

    db = _small_db()
    runs = []
    for dev in ("cuda", "cpu"):
        flags = dict(use_insert_kernel=True, use_agg_kernel=True) if optin else {}
        session = graftdb_torch.connect(db, graftdb_torch.EngineConfig(
            mode="graft", morsel_size=2048, backend=TorchBackend(device=dev, **flags),
            retention="epoch", memory_budget=0, reuse_cache_budget=20_000,
            reuse_disk_budget=64_000_000,
            faults=graftdb_torch.FaultPlan(
                seed=7, schedule={"morsel": 0.02, "stall": 0.05, "rehydrate": 0.3}),
        ))
        _build.reset_launch_counts()
        futs = session.submit_all([
            queries.make_query(db, t, p, arrival=float(i)) for i, (t, p) in enumerate(_REPEAT)
        ])
        session.run()
        runs.append((session, futs, _build.launch_counts()))
    (s_gpu, f_gpu, launches), (s_cpu, f_cpu, _) = runs
    assert [f.status for f in f_gpu] == [f.status for f in f_cpu]
    for a, b in zip(f_gpu, f_cpu):
        if a.status == "done":
            for k, v in a.result().items():
                np.testing.assert_array_equal(v, b.result()[k])
    assert dict(s_gpu.counters) == dict(s_cpu.counters)
    assert s_gpu.backend.stats() == s_cpu.backend.stats()
    assert s_gpu.now == s_cpu.now
    assert s_gpu.counters["cache_hits"] > 0 and s_gpu.counters["cache_disk_high_water_bytes"] > 0
    assert s_gpu.counters["faults_injected"] > 0
    assert launches.get("fused_chain", 0) > 0
    if optin:
        assert launches.get("hash_build_insert", 0) > 0
    for s in (s_gpu, s_cpu):
        s.close()


def test_cuda_rehydrated_table_by_insert_kernel_matches_host(cuda):
    """A rehydrated state's probe table built by the batch-insert kernel
    (B6) and by the host election return the same entries (and visibility
    words) for every probe key through B3 and B4, and those of the
    never-evicted state whose table grew morsel by morsel."""
    import graftdb_torch
    from repro_torch.api.backends import TorchBackend
    from repro_torch.core.reuse import ReusePlane, hash_state_fingerprint
    from repro_torch.relational import queries

    db = _small_db()
    session = graftdb_torch.connect(db, graftdb_torch.EngineConfig(
        mode="graft", morsel_size=256, retention="epoch"))
    session.submit_all([queries.make_query(db, "q3", {"segment": 1.0, "date": 750.0}),
                        queries.make_query(db, "q10", {"date": 500.0}, arrival=0.01)])
    session.run()
    eng = session.engine
    states = [s for lst in eng.state_index.values() for s in lst if s.keycode.n > 1024]
    assert states
    plane = ReusePlane(eng.cost_model, 1 << 30)
    host, kernel = TorchBackend(device="cuda"), TorchBackend(device="cuda", use_insert_kernel=True)
    rng = np.random.default_rng(3)
    for st in states:
        assert plane.spill(st)
        extents = [st.extents[eid] for eid in sorted(st.extents)]
        art = plane.store.take(hash_state_fingerprint(st.sig, extents))
        twin = plane._build_hash(10_000 + st.state_id, art, eng.n_partitions, None)
        keys = np.concatenate([st.keycode.data[: st.keycode.n],
                               rng.integers(0, int(st.keycode.data.max()) + 1000, 4096)])
        rng.shuffle(keys)
        _build.reset_launch_counts()
        for call in ("probe_visible_multi", "probe"):
            by_kernel = getattr(kernel, call)(twin, keys)
            by_host = getattr(host, call)(twin, keys)
            grown = getattr(session.backend, call)(st, keys)
            for a, b, c in zip(by_kernel, by_host, grown):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)
        launches = _build.launch_counts()
        assert launches.get("hash_build_insert", 0) == 1
        assert launches.get("hash_probe_lens", 0) == 3
        assert launches.get("hash_probe_lens_multi64", 0) == 3
    session.close()


@pytest.mark.parametrize("template", ["q3", "q5"])
@pytest.mark.parametrize("workers", [1, 4])
def test_cuda_batch_planning_twin(cuda, workers, template):
    """Bursts admitted as planned cohorts: the card and the CPU give
    identical results, counters (the ``batch_*`` ones among them), admission
    logs, cohort plans, backend stats and clocks. q5's cohort members see
    different rows of one orders state, so their probes reach the lens
    probes (B2 or B3) on the card."""
    import graftdb_torch

    db = _small_db()
    runs = []
    for dev in ("cuda", "cpu"):
        session = graftdb_torch.connect(db, graftdb_torch.EngineConfig(
            mode="graft", morsel_size=2048, device=dev, batch_planning=True,
            workers=workers, partitions=workers,
        ))
        _build.reset_launch_counts()
        # pinned query ids: the plans name their members by id
        futs = session.submit_all([
            dataclasses.replace(q, qid=30_000 + i)
            for i, q in enumerate(burst_trace(db, 4, 4, template=template))
        ])
        session.run()
        plans = [(e["cohort"], e["t"], e["plan"].to_dict()) for e in session.cohort_log()]
        log = [session._runner.admission_log[f.qid] for f in futs]
        runs.append((session, futs, plans, log, _build.launch_counts()))
    (s_gpu, f_gpu, p_gpu, l_gpu, launches), (s_cpu, f_cpu, p_cpu, l_cpu, _) = runs
    for a, b in zip(f_gpu, f_cpu):
        for k, v in a.result().items():
            np.testing.assert_array_equal(v, b.result()[k])
    assert dict(s_gpu.counters) == dict(s_cpu.counters)
    assert s_gpu.counters["batch_cohorts"] == 4
    assert s_gpu.counters["batch_planned_queries"] == 16
    assert s_gpu.counters["batch_coverage_gain_rows"] > 0
    assert p_gpu == p_cpu
    assert l_gpu == l_cpu
    assert s_gpu.backend.stats() == s_cpu.backend.stats()
    assert s_gpu.now == s_cpu.now
    assert launches.get("fused_chain", 0) > 0
    if template == "q5":
        assert launches.get("hash_probe_lens64", 0) + launches.get("hash_probe_lens_multi64", 0) > 0
    for s in (s_gpu, s_cpu):
        s.close()


@pytest.mark.parametrize("d", [1, 2, 4])
def test_cuda_sharded_chain_matches_unsharded(cuda, d):
    """The shard-local chain on a d-shard mesh of the card: one launch of
    B1 per shard, bit-identical to the unsharded launch and to the plain
    version on the CPU."""
    from repro_torch.launch.db_plane import _chain_parity
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh(d)
    spec, arrays = _chain_inputs(7, n=4096, n_e=500)
    want = fused_chain.chain_plain(spec, [_t(a) for a in arrays])
    _build.reset_launch_counts()
    got = fused_chain.chain_launch(spec, [_t(a, cuda) for a in arrays], mesh=mesh)
    torch.cuda.synchronize()
    assert _build.launch_counts().get("fused_chain", 0) == d
    assert torch.equal(got.cpu(), want)
    block = _chain_parity(mesh, rows=65_536)
    assert block["parity"] and block["matched_rows"] > 0
    assert block["shard_launches"] == d


@pytest.mark.parametrize("d", [1, 4])
def test_cuda_exchange_matches_cpu(cuda, d):
    """The bucketed exchange (grown from capacity 4) and the partitioned
    join on the card equal the same calls on CPU shards, bit for bit."""
    from repro_torch.core.hashindex import key_partition
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.relational import distributed as dist

    rng = np.random.default_rng(d)
    keys = rng.choice(1 << 24, 10_001, replace=False).astype(np.int64)
    vals = np.stack([keys, keys % 97], -1).astype(np.float32)
    recs = [dist.exchange_by_key(make_data_mesh(d, dev), keys, vals,
                                 dest=key_partition(keys, d), capacity=4)
            for dev in ("cuda", "cpu")]
    for k in ("capacity", "attempts", "bucket_overflow_rows"):
        assert recs[0][k] == recs[1][k], k
    assert recs[0]["attempts"] > 1
    for k in ("keys", "values", "valid"):
        assert recs[0][k].is_cuda and torch.equal(recs[0][k].cpu(), recs[1][k]), k
    bk, pk = keys[:5000], np.concatenate([keys[:2500], keys[5000:7500]])
    bv, pv = vals[:5000, :1], vals[:5000]
    joined = []
    for dev in ("cuda", "cpu"):
        join = dist.make_partitioned_join(make_data_mesh(d, dev), 1, 2, capacity=16384 // d)
        joined.append(join(*dist.pad_partition(bk, bv, d)[:2], *dist.pad_partition(pk, pv, d)[:2]))
    for a, b in zip(*joined):
        assert torch.equal(a.cpu(), b)
    assert int(joined[0][1].sum()) == 2500 and int(joined[0][3]) == 0


def test_cuda_mesh_session_twin(cuda):
    """A mesh=2 session at SF 0.01 (two shards on the card, or on two
    cards): the card and the CPU give identical results, counters,
    ``mesh_stats()`` (the shards' device names aside), backend stats and
    clocks; the exchange of ``validate_mesh_plane`` places every row."""
    import graftdb_torch
    from repro_torch.relational import queries

    db = _small_db()
    rng = np.random.default_rng(123)
    qs = [queries.sample_query(db, rng, arrival=i * 0.001) for i in range(6)]
    runs = []
    for dev in ("cuda", "cpu"):
        session = graftdb_torch.connect(db, graftdb_torch.EngineConfig(
            mode="graft", morsel_size=4096, device=dev, mesh=2))
        futs = session.submit_all([
            dataclasses.replace(queries.make_query(db, q.template, q.params, arrival=q.arrival),
                                qid=40_000 + i) for i, q in enumerate(qs)])
        session.run()
        stats = session.mesh_stats()
        devices = stats.pop("devices")
        assert len(devices) == 2 and all(x.startswith(dev) for x in devices)
        runs.append((session, futs, stats, session.validate_mesh_plane(4096)))
    (s_gpu, f_gpu, m_gpu, v_gpu), (s_cpu, f_cpu, m_cpu, v_cpu) = runs
    for a, b in zip(f_gpu, f_cpu):
        for k, v in a.result().items():
            np.testing.assert_array_equal(v, b.result()[k])
    assert dict(s_gpu.counters) == dict(s_cpu.counters)
    assert m_gpu == m_cpu and m_gpu["mesh_exchange_rows"] > 0
    assert v_gpu == v_cpu and v_gpu["rows_lost"] == 0
    assert s_gpu.backend.stats() == s_cpu.backend.stats()
    assert s_gpu.now == s_cpu.now
    for s in (s_gpu, s_cpu):
        s.close()


# ---------------------------------------------------------------------------
# the LM serving path: the kernel-ops kernels against the model layers, and
# the model zoo on the card against the CPU
# ---------------------------------------------------------------------------


def test_cuda_linrec_matches_port_rglru_layer(cuda):
    """B8's kernel on the port's RG-LRU gates gives the layer's output (the
    reference's ``test_linrec_matches_rglru_semantics`` limits)."""
    from _torch_lm import rglru_inputs
    from repro_torch.kernels import ops
    from repro_torch.models.recurrent import _rg_lru_gates, rg_lru

    p, x = rglru_inputs(cuda)
    a, b = _rg_lru_gates(p, x)
    before = _build.launch_counts().get("linrec", 0)
    got = ops.linear_recurrence(a, b, device="cuda")
    assert _build.launch_counts()["linrec"] == before + 1
    torch.testing.assert_close(got, rg_lru(p, x), rtol=2e-4, atol=2e-4)


def test_cuda_attention_matches_port_attention_layer(cuda):
    """B9's float32 kernel on one head group of recurrentgemma-9b at its
    window (2,048 of 4,096 positions) gives the port's
    ``layers.attention``, within the kernel-ops phase's float32 limits."""
    from _torch_lm import head_group
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    cfg, p, x, q, k, v = head_group(4096, cuda)
    assert cfg.attn_window == 2048
    want = layers.attention(p, x, cfg, window=cfg.attn_window)[0]
    before = _build.launch_counts().get("flash_attention", 0)
    got = ops.attention(q, k, v, window=cfg.attn_window, device="cuda")
    assert _build.launch_counts()["flash_attention"] == before + 1
    torch.testing.assert_close(got.transpose(0, 1).reshape(want.shape), want,
                               rtol=1e-5, atol=1e-4)


#: the archs whose decode the reference's parity test holds against forward
DECODE_ARCHS = ("h2o-danube-3-4b", "rwkv6-7b", "recurrentgemma-9b", "chatglm3-6b",
                "stablelm-3b", "seamless-m4t-large-v2")


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "llama4-maverick-400b-a17b",
                                  "dbrx-132b", "h2o-danube-3-4b", "stablelm-3b",
                                  "starcoder2-7b", "chatglm3-6b", "rwkv6-7b", "pixtral-12b",
                                  "seamless-m4t-large-v2"])
def test_cuda_model_matches_cpu(cuda, arch):
    """Each arch's reduced config on the card against the CPU, with the
    same parameters: the final hidden states, and (for the archs of the
    reference's decode parity test) 16 decode steps' logits, within 1e-4
    of the largest |CPU| value."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M

    cfg = smoke_config(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))}
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = torch.from_numpy(
            rng.normal(size=(2, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32) * 0.1)
    if cfg.n_encoder_layers:
        batch["src_embeds"] = torch.from_numpy(
            rng.normal(size=(2, 4, cfg.d_model)).astype(np.float32) * 0.1)

    def on(dev):
        p = M.tree_map(lambda t: t.to(dev), params, lambda x: isinstance(x, torch.Tensor))
        b = {k: v.to(dev) for k, v in batch.items()}
        hidden = M.forward_train(cfg, p, b)
        if arch not in DECODE_ARCHS:
            return hidden, None
        cache = M.init_cache(cfg, 2, 16, dtype=torch.float32, device=dev)
        if cfg.n_encoder_layers:
            memory = M.encode(cfg, p, b["src_embeds"])
            for gp, gc in zip(p["groups"], cache):
                gc["attn0"]["ck"].copy_(torch.einsum("bsd,ndgk->nbsgk", memory,
                                                     gp["attn0"]["cwk"]))
                gc["attn0"]["cv"].copy_(torch.einsum("bsd,ndgk->nbsgk", memory,
                                                     gp["attn0"]["cwv"]))
        logits = [M.decode_step(cfg, p, cache, b["tokens"][:, t : t + 1], t)[0]
                  for t in range(16)]
        return hidden, torch.cat(logits, dim=1)

    assert not torch.backends.cuda.matmul.allow_tf32
    (h_gpu, l_gpu), (h_cpu, l_cpu) = on(cuda), on("cpu")
    for got, want in ((h_gpu, h_cpu), (l_gpu, l_cpu)):
        if want is None:
            continue
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        assert err < 1e-4, f"{arch}: card against CPU {err:.3g} of max |CPU|"
