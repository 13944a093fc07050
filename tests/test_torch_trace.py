"""The port's in-program tracer (``repro_torch.core.trace``) on the CPU.

A traced closed loop gives the same results, counters, backend stats and
virtual clock as an untraced one, and both equal the port's reference
executor. Its spans nest, count what the engine's counters count, and its
copy counters equal hand counts of each backend call. With no trace
running, no site records anything or reads the clock. Sizes: TPC-H SF
0.01, 8 clients x 3 queries, ``device="cpu"``.
"""

import numpy as np
import pytest
import torch

import graftdb_torch
from repro_torch.api.backends import TorchBackend
from repro_torch.core import trace
from repro_torch.core.runtime import Pipeline
from repro_torch.core.state import SharedHashBuildState
from repro_torch.kernels.fused_chain import output_sizes
from repro_torch.launch import workload
from repro_torch.relational import queries, refexec

torch.set_num_threads(2)

SF = 0.01
CLIENTS, PER = 8, 3
SEED = 3


@pytest.fixture(autouse=True)
def _no_trace_left():
    """A test that fails mid-trace leaves none running for the next."""
    yield
    if trace.active is not None:
        trace.stop()


@pytest.fixture(scope="module")
def tdb():
    return workload.get_db(SF)


@pytest.fixture(scope="module")
def seqs(tdb):
    return workload.client_sequences(tdb, CLIENTS, PER, seed=SEED)


def closed_loop(tdb, seqs, traced: bool):
    """The closed loop of ``workload.run_closed_loop`` (graft, work clock)
    with the trace started after the first queries are in and stopped
    after the run; returns what the tests compare."""
    session = workload.open_session(tdb, "graft", device="cpu")
    idx, slot = {}, {}
    for c, seq in enumerate(seqs):
        q = queries.make_query(tdb, *seq[0], arrival=0.0)
        idx[c], slot[q.qid] = 1, (c, 0)
        session.submit(q)

    def on_complete(fut):
        c = slot[fut.qid][0]
        if idx[c] >= len(seqs[c]):
            return None
        q = queries.make_query(tdb, *seqs[c][idx[c]], arrival=session.now)
        slot[q.qid] = (c, idx[c])
        idx[c] += 1
        return q

    calls = [0]
    orig = Pipeline.process

    def process(self, *a, **kw):
        calls[0] += trace.active is not None
        return orig(self, *a, **kw)

    before = (dict(session.counters), session.backend.stats())
    Pipeline.process = process
    try:
        if traced:
            session.start_trace()
        done = session.run(on_complete=on_complete)
        tr = session.stop_trace() if traced else None
    finally:
        Pipeline.process = orig
    out = {
        "results": {slot[f.qid]: f.result() for f in done},
        "plans": {slot[f.qid]: f.query.plan for f in done},
        "counters": dict(session.counters),
        "backend": session.backend.stats(),
        "now": session.now,
        "before": before,
        "process_calls": calls[0],
        "trace": tr,
    }
    session.close()
    return out


@pytest.fixture(scope="module")
def runs(tdb, seqs):
    return closed_loop(tdb, seqs, False), closed_loop(tdb, seqs, True)


def test_traced_loop_equals_untraced_and_the_reference(tdb, runs):
    off, on = runs
    assert trace.active is None
    assert len(on["results"]) == CLIENTS * PER
    assert set(on["results"]) == set(off["results"])
    for key, got in on["results"].items():
        want = off["results"][key]
        assert set(got) == set(want)
        for col in got:
            np.testing.assert_array_equal(got[col], want[col])
        ref = refexec.execute(tdb, on["plans"][key])
        assert set(ref) == set(got)
        for col in got:
            np.testing.assert_allclose(np.asarray(got[col], np.float64),
                                       np.asarray(ref[col], np.float64), rtol=1e-9)
    assert on["counters"] == off["counters"]
    assert on["backend"] == off["backend"]
    assert on["now"] == off["now"]


def test_spans_nest_and_count_what_the_engine_counts(runs):
    _, on = runs
    tr = on["trace"]
    assert len(tr) > 0
    has = tr.parent >= 0
    p = tr.parent[has]
    assert (tr.end >= tr.start).all()
    assert (tr.start[p] <= tr.start[has]).all() and (tr.end[has] <= tr.end[p]).all()
    assert (tr.self_time >= 0).all()
    assert all(v >= 0 for v in tr.self_s.values())
    for name, total in tr.total_s.items():
        assert tr.self_s[name] <= total
    # the trace ran from after the first submissions to after the run
    c0, b0 = on["before"]
    assert tr.calls["morsel"] == on["process_calls"] > 0
    assert tr.calls["engine.submit"] == on["counters"]["submitted"] - c0.get("submitted", 0) > 0
    assert tr.calls["engine.complete"] == on["counters"]["completed"] - c0.get("completed", 0)
    assert tr.calls["engine.complete"] == CLIENTS * PER
    assert tr.calls.get("backend.fallback", 0) == (on["backend"]["fallback_probes"]
                                                   - b0["fallback_probes"])
    assert tr.calls["client.callback"] == CLIENTS * PER
    names = set(tr.calls)
    assert {"scheduler.step", "scan.advance", "morsel.filter", "morsel.probe", "morsel.sink",
            "backend.probe_chain", "backend.table", "backend.wait"} <= names
    # each phase of a morsel and each backend call lies inside its layer
    parent_name = {i: tr.name[j] for i, j in enumerate(tr.parent.tolist()) if j >= 0}
    for i, m in enumerate(tr.name):
        if m.startswith("morsel."):
            assert parent_name[i] == "morsel"
        elif m == "morsel":
            assert parent_name[i] == "scan.advance"
        elif m in ("backend.table", "backend.fallback", "backend.wait"):
            assert parent_name[i].startswith("backend.")
        elif m.startswith("backend."):
            assert parent_name[i].startswith("morsel.")
    assert tr.counters["h2d_copies"] > 0 and tr.counters["d2h_copies"] > 0
    assert tr.counters["d2h_bytes"] > 0 and tr.counters["h2d_bytes"] > 0


def _state(n=100, qid=7, seed=0):
    """A unique-key build state of ``n`` entries, all visible to ``qid``."""
    rng = np.random.default_rng(seed)
    state = SharedHashBuildState(1, None, ("k",), ("v",))
    state.attach(qid)
    keys = rng.choice(1 << 20, n, replace=False).astype(np.int64)
    bit = np.full(n, state.slots.mask(qid), dtype=np.uint64)
    state.insert_or_mark(np.arange(n), keys, {"k": keys.astype(np.float64),
                                              "v": rng.random(n)}, bit, bit)
    return state, keys


def _copies(fn):
    """The copy counters of one call, traced alone."""
    trace.start()
    try:
        out = fn()
    finally:
        tr = trace.stop()
    c = tr.counters
    return out, (c["h2d_copies"], c["h2d_bytes"], c["d2h_copies"], c["d2h_bytes"])


@pytest.mark.parametrize("call", ["table", "probe", "probe_visible", "probe_visible_multi",
                                  "probe_chain", "segment_sum", "fallback"])
def test_copy_counters_equal_hand_counts(call):
    """Each call on a 100-entry state, with its table and mirrors already
    on the device; the table's first upload alone: 256 slots (the power of
    two at twice the entries), keys and slot -> entry, int32; and a probe
    the table declines, served on the host with no copy."""
    n_probe = 37
    backend = TorchBackend(device="cpu", use_agg_kernel=True)
    state, keys = _state()
    probe = np.concatenate([keys[:30], np.arange(7) + (1 << 21)])
    assert len(probe) == n_probe
    if call == "table":
        _, got = _copies(lambda: backend._table_for(state))
        assert got == (2, 2 * 256 * 4, 0, 0)
        return
    if call == "fallback":
        # a key entered twice: the table is refused and the host serves
        dup = keys[:1]
        bit = np.full(len(dup), state.slots.mask(7), dtype=np.uint64)
        state.insert_or_mark(np.arange(100, 100 + len(dup)), dup,
                             {"k": dup.astype(np.float64), "v": np.zeros(len(dup))}, bit, bit)
        trace.start()
        pi, _ = backend.probe(state, probe)
        tr = trace.stop()
        assert len(pi) == 31  # keys[0] matches both of its entries
        assert tr.calls["backend.fallback"] == backend.stats()["fallback_probes"] == 1
        assert tr.parent[tr.name.index("backend.fallback")] == tr.name.index("backend.probe")
        assert tr.counters == dict.fromkeys(trace.COUNTERS, 0)
        return
    backend._table_for(state)
    backend._sync_mirrors(backend._tables[state], state)
    if call == "probe":
        (pi, _), got = _copies(lambda: backend.probe(state, probe))
        assert len(pi) == 30
        assert got == (1, 4 * n_probe, 1, 4 * n_probe)
    elif call == "probe_visible":
        (pi, _), got = _copies(lambda: backend.probe_visible(state, probe, 7))
        assert len(pi) == 30
        assert got == (1, 4 * n_probe, 1, 4 * n_probe)
    elif call == "probe_visible_multi":
        (pi, _, _), got = _copies(lambda: backend.probe_visible_multi(state, probe))
        assert len(pi) == 30
        assert got == (1, 4 * n_probe, 1, 3 * 4 * n_probe)  # found, lo, hi words
    elif call == "probe_chain":
        # one stage, host keys, no grants, filter or sink
        cplan = {"stages": [{"state": state, "tables": np.zeros((8, 256), np.uint64),
                             "key": ("host",), "grants": (), "n_grant_members": 0,
                             "use_post": False, "filter": None}],
                 "sink": None, "n_members": 1, "_dev": {}}
        bits = np.ones(n_probe, np.uint64)

        def chain():
            return backend.probe_chain(cplan, {}, bits, {0: probe})

        npad = 64  # the power of two at or above the rows, at least 8
        out_words = 2 * npad + npad + 3 + 64  # bits lo/hi, entries, stats, slots
        assert sum(output_sizes(((None,), False), npad)) == out_words
        res, got = _copies(chain)
        assert res is not None
        # the first call uploads the stage's lens tables (lo, hi halves)
        assert got == (3, 4 * 3 * npad + 2 * 4 * 8 * 256, 1, 4 * out_words)
        _, got = _copies(chain)
        assert got == (1, 4 * 3 * npad, 1, 4 * out_words)  # ownership halves, keys
    else:
        gids = np.arange(50) % 6
        vals = np.arange(50, dtype=np.float64)
        out, got = _copies(lambda: backend.segment_sum(gids, vals, 6))
        np.testing.assert_allclose(out, np.bincount(gids, vals, 6))
        assert got == (2, 4 * 50 + 4 * 50, 1, 4 * 6)  # int32 codes, float32 values


def _small_session(tdb):
    session = graftdb_torch.connect(tdb, graftdb_torch.EngineConfig(
        device="cpu", mode="graft", morsel_size=16384))
    rng = np.random.default_rng(5)
    session.submit_all([queries.sample_query(tdb, rng, arrival=0.0) for _ in range(3)])
    return session


def test_no_site_records_or_reads_the_clock_without_a_trace(tdb, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a site reached the tracer with no trace running")

    monkeypatch.setattr(trace, "_clock", refuse)
    for name in ("open", "close", "tag", "h2d", "d2h"):
        monkeypatch.setattr(trace.Tracer, name, refuse)
    assert trace.active is None
    session = _small_session(tdb)
    assert len(session.run()) == 3
    assert trace.active is None


def test_misuse_raises_and_open_spans_are_left_out(tdb):
    session = _small_session(tdb)
    with pytest.raises(RuntimeError, match="no trace"):
        session.stop_trace()
    session.start_trace()
    with pytest.raises(RuntimeError, match="already"):
        session.start_trace()
    with pytest.raises(RuntimeError, match="already"):
        trace.start()
    stopped = []

    def on_complete(fut):
        if not stopped:  # inside a scheduler step and this callback
            stopped.append(session.stop_trace())
        return None

    session.run(on_complete=on_complete)
    assert trace.active is None
    tr = stopped[0]
    assert "client.callback" not in tr.calls  # open at the stop
    assert tr.calls["engine.complete"] >= 1
    # the step that completed the query was open at the stop: its children
    # lost their parent
    last = max(i for i, m in enumerate(tr.name) if m == "engine.complete")
    assert tr.parent[last] == -1
    assert ((tr.parent >= -1) & (tr.parent < len(tr))).all()

    # by hand: a span open at the stop is left out, its closed child kept
    trace.start()
    outer = trace.active.open("outer", 1)
    inner = trace.active.open("inner", 2)
    trace.active.close(inner)
    tr = trace.stop()
    assert tr.name == ["inner"] and tr.parent.tolist() == [-1] and tr.tag.tolist() == [2]
    assert outer == 0
    # a span opened before the start has no parent in the trace; closing a
    # span closes the ones an exception left open inside it
    trace.start()
    a = trace.active.open("a")
    trace.active.open("leaked")
    trace.active.close(a)
    b = trace.active.open("b")
    trace.active.close(b)
    tr = trace.stop()
    assert tr.name == ["a", "b"] and tr.parent.tolist() == [-1, -1]
