"""The port's reuse plane (DESIGN.md §12), cost model and DAG snapshot
against the reference.

Two kinds of tests. Ports of ``tests/test_reuse.py``'s store and engine
tests run the port alone (``graftdb_torch``, ``device="cpu"``: every kernel
runs its plain PyTorch version): artifact store tiers and budgets, spill ->
rehydrate -> attach against a never-evicted oracle, fingerprint near
misses, the three-way cost decision, EXPLAIN ``served_from_cache``
accounting and ``Session.close``. Parity tests run one trace through
``graftdb`` (``backend="pallas"``) and through ``graftdb_torch`` and compare
results (bit for bit: the default aggregation is float64-exact; rtol 1e-5
with the float32 aggregate kernel), row, cache and backend counters,
virtual clocks, per-query stats, EXPLAIN GRAFT, and the spilled artifacts'
arrays fingerprint by fingerprint. The serving-plane prefix tests wait for
the port's serving plane.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import graftdb
import graftdb_torch
from _port_counters import assert_counters_match, assert_stats_match
from graftdb_torch import EngineConfig
from repro.relational import queries as ref_queries
from repro_torch.api.backends import TorchBackend
from repro_torch.core.reuse import (
    ArtifactStore,
    ReusePlane,
    StateArtifact,
    hash_state_fingerprint,
    rehydrate_wins,
    reuse_scores,
)
from repro_torch.relational import queries, refexec
from repro_torch.relational.table import database_from_numpy, days

torch.set_num_threads(2)

ALL_MODES = ["isolated", "scan_sharing", "qpipe_osp", "residual", "graft"]

# epoch retention with a zero budget: every retirement immediately evicts,
# so with a cache every retirement immediately spills
EVICT_ALL = dict(retention="epoch", memory_budget=0)
CACHE = dict(EVICT_ALL, reuse_cache_budget=64_000_000)
# a memory tier too small for most artifacts: they demote to the disk tier
DISK = dict(EVICT_ALL, reuse_cache_budget=20_000, reuse_disk_budget=64_000_000)

REPEAT_SEQ = [
    ("q3", {"segment": 1.0, "date": 750.0}),
    ("q6", {"date": 400.0, "discount": 0.05, "quantity": 25.0}),
    ("q3", {"segment": 1.0, "date": 750.0}),  # exact repeat: fingerprint hit
    ("q3", {"segment": 1.0, "date": 800.0}),  # near miss: same keys, new date
    ("q3", {"segment": 1.0, "date": 750.0}),
]


@pytest.fixture(scope="module")
def tdb(db):
    return database_from_numpy(db.tables, db.scale_factor)


def _q3(db, date, seg=1.0, arrival=0.0):
    return queries.make_query(db, "q3", {"segment": seg, "date": float(days(date))}, arrival)


def _art(fp, nbytes, kind="hash_build", sig=None, meta=None):
    return StateArtifact(
        fp, kind, sig, nbytes, meta or {}, {"x": np.zeros(max(1, nbytes // 8))}
    )


def _connect(tdb, mode="graft", **kw):
    return graftdb_torch.connect(tdb, EngineConfig(mode=mode, device="cpu", **kw))


def _run_sequence(tdb, mode, config_extra, arrivals):
    """Run (template, params) repeats serially-by-arrival on one port
    session; returns (results in submit order, session)."""
    session = _connect(tdb, mode, **config_extra)
    futs = []
    for i, (t, p) in enumerate(arrivals):
        futs.append(session.submit(queries.make_query(tdb, t, p, arrival=float(i))))
    session.run()
    return [f.result() for f in futs], session


def _assert_same_results(got, want, rtol=1e-9):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_allclose(
                np.asarray(g[k], dtype=np.float64),
                np.asarray(w[k], dtype=np.float64),
                rtol=rtol,
            )


# ---------------------------------------------------------------------------
# ArtifactStore: tiers, budgets, eviction order
# ---------------------------------------------------------------------------


def test_store_budget_evicts_oldest_first():
    c = {}
    store = ArtifactStore(budget=1000, counters=c)
    for i in range(3):
        assert store.put(_art(("hash_build", ("k", i), ()), 400))
    assert len(store) == 2
    assert store.get(("hash_build", ("k", 0), ())) is None
    assert store.get(("hash_build", ("k", 2), ())) is not None
    assert c["cache_evictions"] == 1 and c["cache_spills"] == 3
    assert store.mem_bytes == 800 <= store.budget
    assert c["cache_high_water_bytes"] <= store.budget


def test_store_rejects_oversized_artifact():
    store = ArtifactStore(budget=100, counters={})
    assert not store.put(_art(("hash_build", ("big",), ()), 4096))
    assert len(store) == 0 and store.mem_bytes == 0


def test_store_disk_tier_demotes_and_reloads():
    c = {}
    store = ArtifactStore(budget=500, disk_budget=10_000, counters=c)
    a0 = _art(("hash_build", ("d", 0), ()), 400)
    payload = a0.arrays["x"].copy()
    store.put(a0)
    store.put(_art(("hash_build", ("d", 1), ()), 400))  # evicts a0 -> disk
    assert store.disk_bytes == 400 and store.mem_bytes == 400
    assert os.path.basename(store._dir).startswith("graftdb-torch-reuse-")
    back = store.get(("hash_build", ("d", 0), ()))
    assert back is not None and back.arrays is not None
    np.testing.assert_array_equal(back.arrays["x"], payload)
    assert store.put(_art(("hash_build", ("d", 2), ()), 900))
    assert store.get(("hash_build", ("d", 2), ())) is not None
    assert c["cache_disk_high_water_bytes"] <= 10_000
    store.close()


def test_store_take_consumes_and_flush_resets():
    store = ArtifactStore(budget=1000, disk_budget=1000)
    fp = ("hash_build", ("t",), ())
    store.put(_art(fp, 100))
    assert store.take(fp) is not None
    assert store.get(fp) is None and len(store) == 0
    store.put(_art(fp, 100))
    store.flush()
    assert len(store) == 0 and store.mem_bytes == 0 and store.disk_bytes == 0
    store.close()
    assert not store.put(_art(fp, 100))  # closed: refuses spills


def test_by_sig_groups_fingerprints_and_orders_by_spill():
    store = ArtifactStore(budget=10_000)
    sig_key = ("q3-build",)
    store.put(_art(("hash_build", sig_key, ("e1",)), 100))
    store.put(_art(("hash_build", sig_key, ("e2",)), 100))
    store.put(_art(("hash_build", ("other",), ()), 100))
    arts = store.by_sig("hash_build", sig_key)
    assert [a.fingerprint[2] for a in arts] == [("e1",), ("e2",)]


# ---------------------------------------------------------------------------
# Fingerprints + cost scoring
# ---------------------------------------------------------------------------


def _plan_fingerprints(q, pkg):
    out = []
    for j in pkg.grafting.all_boundaries(q.plan):
        sig = pkg.descriptors.hash_build_signature(j)
        conj = pkg.predicates.Conjunction.from_pred(pkg.plans.collect_subtree_pred(j.build))
        out.append(pkg.reuse.hash_state_fingerprint(sig, [(conj, True)]))
    return out


def _core(name):
    import importlib

    mods = ("grafting", "descriptors", "predicates", "plans", "reuse")
    return type(name, (), {m: importlib.import_module(f"{name}.core.{m}") for m in mods})


def test_fingerprint_distinguishes_predicate_intervals(db, tdb):
    """Near-miss negatives: same structural signature, different delivered
    intervals -> distinct fingerprints; identical intervals -> identical
    fingerprints. The port's fingerprints equal the reference's."""
    port = _core("repro_torch")
    fa = _plan_fingerprints(_q3(tdb, "1995-03-15"), port)
    fb = _plan_fingerprints(_q3(tdb, "1995-06-15"), port)
    fc = _plan_fingerprints(_q3(tdb, "1995-03-15"), port)
    assert fa != fb
    assert fa == fc
    assert [f[:2] for f in fa] == [f[:2] for f in fb]
    ref_q = ref_queries.make_query(
        db, "q3", {"segment": 1.0, "date": float(days("1995-03-15"))}
    )
    assert _plan_fingerprints(ref_q, _core("repro")) == fa


def test_reuse_scores_three_way():
    cm = {"scan": 1e-9, "filter": 1e-9, "insert": 1e-9, "rehydrate": 60e-9}
    s = reuse_scores(cm, demand_rows=1000, covered_rows=800, artifact_entries=10)
    assert s["recompute_s"] == pytest.approx(3e-6)
    assert s["saved_s"] == pytest.approx(2.4e-6)
    assert s["rehydrate_s"] == pytest.approx(600e-9)
    assert rehydrate_wins(cm, 1000, 800, 10)
    assert not rehydrate_wins(cm, 1000, 0, 10)
    assert not rehydrate_wins(cm, 1000, 10, 100_000)


def test_costmodel_matches_reference():
    """``scaled_default`` and ``calibrate``'s keys equal the reference's;
    calibration times the host's NumPy passes in both packages."""
    from repro.core import costmodel as ref_cm
    from repro_torch.core import costmodel

    assert costmodel.scaled_default(250.0) == ref_cm.scaled_default(250.0)
    cal = costmodel.calibrate(n=1 << 12)
    assert set(cal) == set(ref_cm.calibrate(n=1 << 12))
    assert all(v > 0 for v in cal.values())


# ---------------------------------------------------------------------------
# Spill -> rehydrate -> attach (oracle: never evicted)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ALL_MODES)
def test_spill_rehydrate_attach_parity(tdb, mode):
    """A run whose every retirement spills and whose repeats rehydrate
    returns the never-evicted oracle's results, in every sharing mode."""
    oracle, s0 = _run_sequence(tdb, mode, dict(retention="epoch"), REPEAT_SEQ)
    cached, s1 = _run_sequence(tdb, mode, CACHE, REPEAT_SEQ)
    _assert_same_results(cached, oracle)
    if mode == "graft":
        assert s1.counters["cache_spills"] > 0
        assert s1.counters["cache_hits"] > 0
        assert s1.counters["rehydrate_bytes"] > 0
    s0.close()
    s1.close()


def test_rehydrated_state_matches_reference_executor(tdb):
    _, session = _run_sequence(tdb, "graft", CACHE, REPEAT_SEQ[:3])
    assert session.counters["cache_hits"] > 0
    fut = session.submit(
        queries.make_query(tdb, "q3", {"segment": 1.0, "date": 750.0}, arrival=99.0)
    )
    _assert_same_results([fut.result()], [refexec.execute(tdb, fut.query.plan)])
    session.close()


def test_near_miss_is_not_served_as_identity(tdb):
    seq = [
        ("q3", {"segment": 1.0, "date": 750.0}),
        ("q3", {"segment": 1.0, "date": 800.0}),
    ]
    oracle, s0 = _run_sequence(tdb, "graft", dict(retention="epoch"), seq)
    cached, s1 = _run_sequence(tdb, "graft", CACHE, seq)
    _assert_same_results(cached, oracle)
    s0.close()
    s1.close()


def test_agg_identity_cache_hit_skips_recompute(tdb):
    session = _connect(tdb, **CACHE)
    f0 = session.submit(_q3(tdb, "1995-03-15", arrival=0.0))
    session.run()
    f1 = session.submit(_q3(tdb, "1995-03-15", arrival=1.0))
    session.run()
    _assert_same_results([f1.result()], [f0.result()])
    st = f1.stats()
    assert st["served_from_cache"] and st["cache_hits"] >= 1
    assert not f0.stats()["served_from_cache"]
    session.close()


def test_disk_tier_round_trip_through_engine(tdb):
    oracle, s0 = _run_sequence(tdb, "graft", dict(retention="epoch"), REPEAT_SEQ)
    cached, s1 = _run_sequence(tdb, "graft", DISK, REPEAT_SEQ)
    _assert_same_results(cached, oracle)
    assert s1.counters["cache_high_water_bytes"] <= 20_000
    assert s1.counters["cache_disk_high_water_bytes"] > 0
    s0.close()
    s1.close()


@pytest.mark.parametrize("insert_kernel", [False, True])
def test_rehydrated_probe_matches_never_evicted(tdb, insert_kernel):
    """A never-evicted state's probe table grew morsel by morsel; its
    rehydrated copy's table is built in one rebuild (the host election, or
    the batch-insert kernel). Slots may differ; the entries every probe
    returns, and their visibility words, must not."""
    backend = TorchBackend(device="cpu", use_insert_kernel=insert_kernel)
    session = graftdb_torch.connect(
        tdb, EngineConfig(mode="graft", morsel_size=256, retention="epoch", backend=backend)
    )
    session.submit_all([_q3(tdb, "1995-03-15"), _q3(tdb, "1995-06-15", arrival=0.01)])
    session.run()
    eng = session.engine
    states = [s for lst in eng.state_index.values() for s in lst if s.keycode.n > 1024]
    assert states, "no state grew over several morsels"
    plane = ReusePlane(eng.cost_model, 1 << 30)
    rng = np.random.default_rng(5)
    for st in states:
        assert backend._tables[st].n == st.keycode.n  # grown while the queries ran
        assert plane.spill(st)
        extents = [st.extents[eid] for eid in sorted(st.extents)]
        art = plane.store.take(hash_state_fingerprint(st.sig, extents))
        twin = plane._build_hash(10_000 + st.state_id, art, eng.n_partitions, None)
        keys = np.concatenate([
            st.keycode.data[: st.keycode.n],
            rng.integers(0, int(st.keycode.data.max()) + 1000, 4096),
        ])
        rng.shuffle(keys)
        for a, b in zip(backend.probe(st, keys), backend.probe(twin, keys)):
            np.testing.assert_array_equal(a, b)
        multi_a = backend.probe_visible_multi(st, keys)
        multi_b = backend.probe_visible_multi(twin, keys)
        for a, b in zip(multi_a, multi_b):
            np.testing.assert_array_equal(a, b)
    session.close()


@pytest.mark.parametrize("cache", [False, True], ids=["live", "cache"])
def test_evicted_states_release_their_tables(tdb, cache):
    """Completed queries keep their evicted states alive; the backend drops
    such a state's probe table before it makes the next table, and never
    drops the table of a state that is not evicted."""
    import weakref

    session = _connect(tdb, **(CACHE if cache else EVICT_ALL))
    for i, (t, p) in enumerate(REPEAT_SEQ):
        session.submit(queries.make_query(tdb, t, p, arrival=float(i)))
    session.run()
    tables = session.backend._tables
    gone = [weakref.ref(st) for st in tables.keys() if st.evicted]
    assert gone and session.counters["evictions"] > len(tables)
    session.submit(queries.make_query(tdb, "q10", {"date": 500.0}, arrival=10.0))
    session.run()
    assert not any(r() is not None and r() in tables for r in gone)
    session.close()
    kept = _connect(tdb, retention="epoch")
    for i, (t, p) in enumerate(REPEAT_SEQ):
        kept.submit(queries.make_query(tdb, t, p, arrival=float(i)))
    kept.run()
    live = [s for lst in kept.engine.state_index.values() for s in lst if s.keycode.n]
    assert live and all(st in kept.backend._tables for st in live)
    kept.close()


# ---------------------------------------------------------------------------
# EXPLAIN GRAFT: served_from_cache + exact accounting
# ---------------------------------------------------------------------------


def _accounting_exact(ex):
    for b in ex._all():
        assert b.represented_rows + b.residual_rows + b.unattached_rows == b.demand_rows
        if b.part_demand_rows:
            assert sum(b.part_demand_rows) == b.demand_rows
            assert sum(b.part_represented_rows) == b.represented_rows
            assert sum(b.part_residual_rows) == b.residual_rows
            assert sum(b.part_unattached_rows) == b.unattached_rows


@pytest.mark.parametrize("partitions", [1, 4])
def test_explain_served_from_cache_accounting(tdb, partitions):
    session = _connect(tdb, partitions=partitions, **CACHE)
    session.submit(_q3(tdb, "1995-03-15"))
    session.run()
    ex = session.explain_graft(_q3(tdb, "1995-03-15"))
    assert [b for b in ex._all() if b.served_from_cache]
    _accounting_exact(ex)
    assert any(b["served_from_cache"] for b in ex.to_dict()["boundaries"])
    assert "(cache)" in ex.render()
    _accounting_exact(session.explain_graft(_q3(tdb, "1995-06-15")))
    assert session.stats()["cached_artifacts"] > 0  # EXPLAIN consumed nothing
    session.close()


def test_explain_without_cache_unchanged(tdb):
    session = _connect(tdb, retention="epoch")
    session.submit(_q3(tdb, "1995-03-15"))
    session.run()
    ex = session.explain_graft(_q3(tdb, "1995-03-15"))
    assert not any(b.served_from_cache for b in ex._all())
    _accounting_exact(ex)
    session.close()


# ---------------------------------------------------------------------------
# Admission: the three-way decision
# ---------------------------------------------------------------------------


def test_admission_reports_cache_reason(tdb):
    from repro_torch.core.reuse import reuse_potential
    from repro_torch.core.scheduler import AdmissionController

    session = _connect(tdb, **CACHE)
    session.submit(_q3(tdb, "1995-03-15"))
    session.run()
    q = _q3(tdb, "1995-03-15", arrival=5.0)
    assert reuse_potential(session.engine, q) > 0.0
    ac = AdmissionController(max_inflight=1, share_threshold=0.4)
    assert ac.decide(session.engine, q) == ("admit", "cache")
    fresh = queries.make_query(tdb, "q6", {"date": 100.0, "discount": 0.02, "quantity": 24.0})
    assert ac.decide(session.engine, fresh) == ("admit", "fresh")
    session.close()


def test_score_arrival_three_way(tdb):
    from repro_torch.core.costmodel import score_arrival

    session = _connect(tdb, **CACHE)
    session.submit(_q3(tdb, "1995-03-15"))
    session.run()
    s = score_arrival(session.engine, _q3(tdb, "1995-03-15"))
    assert set(s) >= {"recompute_s", "graft_s", "cache_s", "choice"}
    assert s["choice"] == "cache"
    session.close()


# ---------------------------------------------------------------------------
# Config validation + Session lifecycle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [
        {"reuse_cache_budget": -1},
        {"reuse_cache_budget": 1 << 20},  # requires retention='epoch'
        {"retention": "epoch", "reuse_disk_budget": 1 << 20},  # needs cache
    ],
)
def test_config_rejects_bad_reuse_values(kw):
    with pytest.raises((ValueError, TypeError)):
        EngineConfig(**kw)


def test_config_builds_a_session_with_every_ported_plane(tdb):
    session = graftdb_torch.connect(tdb, EngineConfig(
        device="cpu", retention="epoch", reuse_cache_budget=1 << 20,
        reuse_disk_budget=1 << 20, faults=graftdb_torch.FaultPlan(seed=1),
    ))
    assert session.engine.reuse is not None and session.engine.faults is not None
    session.close()


def test_session_close_releases_everything(tdb):
    session = _connect(tdb, **CACHE)
    session.submit(_q3(tdb, "1995-03-15"))
    session.run()
    assert session.stats()["cached_artifacts"] > 0
    session.close()
    assert session.stats()["cached_artifacts"] == 0
    assert session.stats()["retained_bytes"] == 0
    session.close()  # idempotent
    with pytest.raises(RuntimeError):
        session.submit(_q3(tdb, "1995-06-15"))


def test_session_context_manager(tdb):
    with _connect(tdb, **CACHE) as session:
        session.submit(_q3(tdb, "1995-03-15"))
        session.run()
    with pytest.raises(RuntimeError):
        session.explain_graft(_q3(tdb, "1995-03-15"))


def test_stats_surface_cache_counters(tdb):
    session = _connect(tdb, **CACHE)
    fut = session.submit(_q3(tdb, "1995-03-15"))
    session.run()
    st = session.stats()
    assert st["reuse_cache_budget"] == CACHE["reuse_cache_budget"]
    for k in ("cache_hits", "cache_spills", "cache_evictions", "rehydrate_bytes"):
        assert k in fut.stats()["counters"]
    assert st["cache_high_water_bytes"] <= CACHE["reuse_cache_budget"]
    session.close()


# ---------------------------------------------------------------------------
# Parity with the reference (graftdb, backend="pallas")
# ---------------------------------------------------------------------------


def _same_qids(qs):
    return [dataclasses.replace(q, qid=20_000 + i) for i, q in enumerate(qs)]


def _pair(db, tdb, seq, backends=None, **cfg):
    """The same (template, params) sequence, one arrival a second, through
    the reference and the port; returns both sessions and futures."""
    ref_backend, port_backend = backends or ("pallas", None)
    s_ref = graftdb.connect(db, graftdb.EngineConfig(
        backend=ref_backend, capture_explain=True, **cfg))
    f_ref = s_ref.submit_all(_same_qids([
        ref_queries.make_query(db, t, p, arrival=float(i)) for i, (t, p) in enumerate(seq)
    ]))
    s_ref.run()
    port = dict(backend=port_backend) if port_backend is not None else dict(device="cpu")
    s_port = graftdb_torch.connect(tdb, EngineConfig(capture_explain=True, **port, **cfg))
    f_port = s_port.submit_all(_same_qids([
        queries.make_query(tdb, t, p, arrival=float(i)) for i, (t, p) in enumerate(seq)
    ]))
    s_port.run()
    return s_ref, f_ref, s_port, f_port


def _assert_same_runs(s_ref, f_ref, s_port, f_port, rtol=None):
    for a, b in zip(f_ref, f_port):
        ra, rb = a.result(), b.result()
        assert set(ra) == set(rb)
        for k in ra:
            if rtol is None:
                np.testing.assert_array_equal(rb[k], ra[k], err_msg=f"q{a.qid}/{k}")
            else:
                np.testing.assert_allclose(rb[k], ra[k], rtol=rtol, err_msg=f"q{a.qid}/{k}")
        assert_stats_match(b.stats(), a.stats())
        assert b.explain().render() == a.explain().render()
    assert_counters_match(s_port.counters, s_ref.counters)
    assert s_port.now == s_ref.now
    assert s_port.backend.stats() == s_ref.backend.stats()


def _artifacts(store):
    """Every artifact of a store, both tiers: fingerprint -> arrays (the
    disk tier's read back from its ``.npz`` file)."""
    out = {}
    for art in store.iter_kind("hash_build") + store.iter_kind("aggregate"):
        if art.arrays is not None:
            out[art.fingerprint] = art.arrays
        else:
            with np.load(store._paths[art.fingerprint]) as z:
                out[art.fingerprint] = {k: z[k] for k in z.files}
    return out


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("tier", ["memory", "disk"])
def test_repeat_trace_matches_reference(db, tdb, tier, workers):
    """The repeat sequence with every retirement spilling: results, stats
    (``served_from_cache`` among them), counters, clocks, backend counters
    and EXPLAIN GRAFT equal the reference's, and so do the artifacts the
    two stores hold, array by array, fingerprint by fingerprint."""
    cfg = dict(CACHE if tier == "memory" else DISK, mode="graft", workers=workers,
               partitions=workers)
    s_ref, f_ref, s_port, f_port = _pair(db, tdb, REPEAT_SEQ, **cfg)
    _assert_same_runs(s_ref, f_ref, s_port, f_port)
    assert s_port.counters["cache_hits"] > 0
    assert any(f.stats()["served_from_cache"] for f in f_port)
    arts_ref = _artifacts(s_ref.engine.reuse.store)
    arts_port = _artifacts(s_port.engine.reuse.store)
    assert arts_port and list(arts_port) == list(arts_ref)
    for fp, arrays in arts_ref.items():
        assert set(arts_port[fp]) == set(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(arts_port[fp][k], v, err_msg=f"{fp}/{k}")
    if tier == "disk":
        assert s_port.engine.reuse.store._disk
    for q in REPEAT_SEQ[2:4]:  # pre-flight EXPLAIN GRAFT, cache consulted
        qr = dataclasses.replace(ref_queries.make_query(db, *q, arrival=s_ref.now), qid=1)
        qt = dataclasses.replace(queries.make_query(tdb, *q, arrival=s_port.now), qid=1)
        ex_ref, ex_port = s_ref.explain_graft(qr), s_port.explain_graft(qt)
        assert ex_port.render() == ex_ref.render()
        assert ex_port.to_dict() == ex_ref.to_dict()
        _accounting_exact(ex_port)
    s_ref.close()
    s_port.close()


def test_repeat_trace_matches_reference_with_agg_kernel(db, tdb):
    """The float32 aggregate kernel on both sides: results within rtol
    1e-5 of each other, everything else identical."""
    from repro.api.backends import PallasBackend

    s_ref, f_ref, s_port, f_port = _pair(
        db, tdb, REPEAT_SEQ,
        backends=(PallasBackend(interpret=True, use_agg_kernel=True),
                  TorchBackend(device="cpu", use_agg_kernel=True)),
        mode="graft", **CACHE,
    )
    _assert_same_runs(s_ref, f_ref, s_port, f_port, rtol=1e-5)
    assert s_port.counters["cache_hits"] > 0
    s_ref.close()
    s_port.close()


@pytest.mark.parametrize("steps", [5, 40])
def test_dag_snapshot_matches_reference(db, tdb, steps):
    """The read-only DAG snapshot (``core/dag.py``) mid-run: nodes, data
    edges and state-ref edges with their gates and partition frontiers
    equal the reference's, and the §5.4 invariants hold."""
    from repro.core import dag as ref_dag
    from repro_torch.core import dag

    seq = [("q3", {"segment": 1.0, "date": 750.0}), ("q10", {"date": 500.0}),
           ("q3", {"segment": 1.0, "date": 800.0})]
    snaps = []
    for pkg, mod, d, dg, kw in ((graftdb, ref_queries, db, ref_dag, dict(backend="pallas")),
                                (graftdb_torch, queries, tdb, dag, dict(device="cpu"))):
        s = pkg.connect(d, pkg.EngineConfig(mode="graft", morsel_size=256, **kw))
        s.submit_all([dataclasses.replace(mod.make_query(d, t, p), qid=50 + i)
                      for i, (t, p) in enumerate(seq)])
        with pytest.raises(RuntimeError, match="max_steps"):
            s._runner.run((), max_steps=steps)
        snaps.append((dg.snapshot(s.engine), dg.check_invariants(s.engine)))
        s.close()
    (snap_ref, err_ref), (snap, err) = snaps
    assert snap.state_ref_edges and not err and not err_ref
    assert repr(snap) == repr(snap_ref)
