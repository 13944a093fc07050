"""The torch backend's opt-in kernel configuration against the reference's.

``TorchBackend(use_insert_kernel=True, use_agg_kernel=True)`` rebuilds
probe tables with the batch-insert kernel and takes aggregate sums of at
most ``max_kernel_groups`` groups through the segmented-aggregate kernel,
as ``PallasBackend`` does with the same flags. Here the port runs on the
CPU (the kernels' plain versions) and the reference in Pallas interpret
mode. The aggregate kernel returns float32 sums in both packages, added in
different orders, so results agree at rtol 1e-5 (the reference's own
tolerance for this kernel against the float64 path); every counter, the
backend's stats, the virtual clock and EXPLAIN GRAFT are integers or
float64 computed from row counts, and must be identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

import graftdb
import graftdb_torch
from repro.api.backends import PallasBackend
from repro.core.descriptors import StateSignature as RefSignature
from repro.core.state import SharedHashBuildState as RefState
from repro.relational import queries as ref_queries
from repro.relational import tpch as ref_tpch
from repro_torch.api.backends import ReferenceBackend, TorchBackend
from repro_torch.core.descriptors import StateSignature
from repro_torch.core.state import SharedHashBuildState
from repro_torch.relational import queries, refexec
from repro_torch.relational.table import database_from_numpy

torch.set_num_threads(2)

RTOL = 1e-5


def _optin():
    return TorchBackend(device="cpu", use_insert_kernel=True, use_agg_kernel=True)


# ---------------------------------------------------------------------------
# segment_sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [True, False])
def test_agg_kernel_matches_float64_path(weighted):
    rng = np.random.default_rng(0)
    gids = rng.integers(0, 37, 500).astype(np.int64)
    vals = rng.normal(size=500) if weighted else None
    got = TorchBackend(device="cpu", use_agg_kernel=True).segment_sum(gids, vals, 37)
    want = ReferenceBackend().segment_sum(gids, vals, 37)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL)
    if not weighted:  # counts are exact in float32
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# batch-insert rebuilds
# ---------------------------------------------------------------------------


def _states(kc):
    """The same hash-build state in both packages, keyed by ``kc``."""
    out = []
    for sig_cls, state_cls in ((RefSignature, RefState), (StateSignature, SharedHashBuildState)):
        state = state_cls(1, sig_cls("hash_build", ("t", ("k",), ("x",))), ("k",), ("x",))
        out.append(state)
    _grow(out, kc, 0)
    return out


def _grow(states, kc, start):
    dids = np.arange(start, start + len(kc), dtype=np.int64)
    for state in states:
        state.insert_or_mark(
            dids, kc, {"k": kc.astype(float), "x": kc.astype(float)},
            np.full(len(kc), np.uint64(1)), np.zeros(len(kc), np.uint64),
        )


def test_insert_kernel_in_batch_duplicate_falls_back():
    """Duplicate keycodes in one rebuild batch clear the kernel's ``ok``:
    the table is marked bad and the state probes through the reference
    path, in both packages alike."""
    ref_state, state = _states(np.array([7, 7, 9], dtype=np.int64))
    pal, port = PallasBackend(use_insert_kernel=True), _optin()
    probe = np.array([7, 9, 11], dtype=np.int64)
    want = pal.probe(ref_state, probe)
    got = port.probe(state, probe)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert port.fallback_probes == pal.fallback_probes == 1
    assert port.stats() == pal.stats()
    assert port.fallback_reasons["capacity"] == 1


def test_insert_kernel_rebuild_then_host_insert():
    """A table the kernel rebuilt grows by the host winner election until
    it must double again; every probe resolves every key, and the table
    equals the reference's batch-order layout where the reference rebuilt
    it."""
    rng = np.random.default_rng(5)
    keys = rng.choice(1 << 20, 40, replace=False).astype(np.int64)
    ref_state, state = _states(keys[:20])
    pal, port = PallasBackend(use_insert_kernel=True), _optin()
    pal._table_for(ref_state)
    port._table_for(state)
    ref_ent, ent = pal._tables[ref_state], port._tables[state]
    np.testing.assert_array_equal(ent.tkeys, np.asarray(ref_ent.tkeys))
    np.testing.assert_array_equal(ent.slot_entry, ref_ent.slot_entry)
    for stop in (24, 32, 40):  # 24 and 32 fit the 64 slots; 40 doubles
        _grow([state], keys[ent.n : stop], ent.n)
        found = port.probe(state, keys[:stop])
        np.testing.assert_array_equal(found[0], np.arange(stop))
        np.testing.assert_array_equal(found[1], np.arange(stop))
        assert len(ent.tkeys) == (64 if stop < 40 else 128)
    np.testing.assert_array_equal(port._tables[state].jkeys.numpy(), ent.tkeys)
    assert port.fallback_probes == 0


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_db():
    return ref_tpch.get_database(0.002, seed=7)


def _workload(db, seed):
    rng = np.random.default_rng(seed)
    qs, t = [], 0.0
    for _ in range(5):
        t += float(rng.choice([0.0, 0.002, 0.02, 0.08]))
        qs.append(ref_queries.sample_query(db, rng, arrival=t))
    return qs


def _same_qids(qs):
    return [dataclasses.replace(q, qid=10_000 + i) for i, q in enumerate(qs)]


@pytest.mark.parametrize("mode", ["graft", "isolated"])
def test_optin_session_matches_reference(small_db, mode, monkeypatch):
    import repro_torch.api.backends as backends

    calls = {"hash_build_insert": 0, "seg_aggregate": 0}

    def counted(name):
        fn = getattr(backends, name)

        def call(*args):
            calls[name] += 1
            return fn(*args)

        return call

    for name in calls:
        monkeypatch.setattr(backends, name, counted(name))
    tdb = database_from_numpy(small_db.tables, small_db.scale_factor)
    qs = _workload(small_db, 42_000)
    cfg = dict(mode=mode, morsel_size=2048, capture_explain=True)
    s_ref = graftdb.connect(small_db, graftdb.EngineConfig(
        backend=PallasBackend(interpret=True, use_insert_kernel=True, use_agg_kernel=True),
        **cfg))
    f_ref = s_ref.submit_all(_same_qids(
        [ref_queries.make_query(small_db, q.template, q.params, arrival=q.arrival) for q in qs]))
    s_ref.run()
    s_port = graftdb_torch.connect(tdb, graftdb_torch.EngineConfig(backend=_optin(), **cfg))
    f_port = s_port.submit_all(_same_qids(
        [queries.make_query(tdb, q.template, q.params, arrival=q.arrival) for q in qs]))
    s_port.run()

    for a, b in zip(f_ref, f_port):
        ra, rb, want = a.result(), b.result(), refexec.execute(tdb, b.query.plan)
        assert set(ra) == set(rb) == set(want)
        for k in ra:
            np.testing.assert_allclose(rb[k], ra[k], rtol=RTOL, err_msg=f"q{a.qid}/{k}")
            np.testing.assert_allclose(
                np.asarray(rb[k], np.float64), np.asarray(want[k], np.float64), rtol=RTOL
            )
        assert b.stats() == a.stats()
        assert b.explain().render() == a.explain().render()
    assert dict(s_port.counters) == dict(s_ref.counters)
    assert s_port.now == s_ref.now
    assert s_port.backend.stats() == s_ref.backend.stats()
    assert s_port.backend.kernel_probes > 0
    assert calls["hash_build_insert"] > 0 and calls["seg_aggregate"] > 0
