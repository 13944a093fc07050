"""The port's fault plane (DESIGN.md §16) against the reference.

Ports of ``tests/test_chaos_fuzz.py``'s tests run the port alone
(``graftdb_torch``, ``device="cpu"``: every kernel runs its plain PyTorch
version): seeded deterministic injection, the empty-schedule identity,
cancel and deadline, quarantine and unfold, the fault storm, the chaos
differential fuzz against the port's reference executor, checksum-verified
disk artifacts and the reuse temp-dir sweep. Parity tests run one workload
under one ``FaultPlan`` through ``graftdb`` (``backend="pallas"``) and
``graftdb_torch`` and compare statuses, results (bit for bit), counters
(fault counters among them), backend counters, per-query stats and clocks.

The mesh plane's ``exchange`` site is drawn by no port session until the
port has the mesh plane (ROADMAP A3): every shared morsel advance draws
``morsel``.
"""

import dataclasses
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

import graftdb
import graftdb_torch
from graftdb_torch import EngineConfig, FaultPlan, QueryCancelled
from repro.relational import queries as ref_queries
from repro_torch.core.faults import SITES, FaultPlane
from repro_torch.core.reuse import ArtifactStore, StateArtifact
from repro_torch.relational import queries, refexec
from repro_torch.relational.table import database_from_numpy

torch.set_num_threads(2)

ALL_MODES = ["isolated", "scan_sharing", "qpipe_osp", "residual", "graft"]

#: chaos workload seeds (base 31_000); each seed runs a mode x fault-mix
#: sub-matrix, so the sweep covers every mode and every fault site
CHAOS_SEEDS = range(6)

#: same-plan pair under batch planning: the only admission shape where a
#: query pends on a FOREIGN producer (§15 cohorts), i.e. where cancelling
#: the producer exercises producer handoff rather than sealing
BATCHED = dict(mode="graft", morsel_size=2048, batch_planning=True, batch_window=0.001)

FAULT_MIXES = (
    ("morsel-light", {"morsel": 0.01}),
    ("morsel-stall", {"morsel": 0.02, "stall": 0.05}),
    ("rehydrate", {"rehydrate": 0.3, "morsel": 0.01}),
)


@pytest.fixture(scope="module")
def tdb(db):
    return database_from_numpy(db.tables, db.scale_factor)


def _connect(tdb, **kw):
    return graftdb_torch.connect(tdb, EngineConfig(device="cpu", **kw))


def _canon(res):
    keys = sorted(res)
    order = np.lexsort([np.asarray(res[k]) for k in keys])
    return {k: np.asarray(res[k])[order] for k in keys}


def _assert_parity(engine_res, ref_res, ctx):
    ca, cb = _canon(engine_res), _canon(ref_res)
    assert set(ca) == set(cb), ctx
    for k in ca:
        assert ca[k].shape == cb[k].shape, (ctx, k)
        np.testing.assert_allclose(
            ca[k], cb[k], rtol=1e-12, atol=1e-12, err_msg=f"{ctx}/{k}"
        )


def _workload(db, rng, n_lo=3, n_hi=6, module=queries):
    n = int(rng.integers(n_lo, n_hi))
    qs, t = [], 0.0
    for _ in range(n):
        t += float(rng.choice([0.0, 0.002, 0.02]))
        qs.append(module.sample_query(db, rng, arrival=t))
    return qs


def _rebuild(db, qs, module=queries):
    return [
        module.make_query(db, q.template, q.params, arrival=q.arrival) for q in qs
    ]


# ---------------------------------------------------------------------------
# FaultPlane: seeded deterministic injection
# ---------------------------------------------------------------------------


class _TickClock:
    def __init__(self):
        self.now = 0.0

    def tick(self, dt):
        self.now += dt


def test_fault_plane_is_deterministic_per_site():
    plan = FaultPlan(seed=7, schedule={s: 0.3 for s in SITES})
    seqs = []
    for _ in range(2):
        fp = FaultPlane(plan, counters={})
        seqs.append([(s, fp.fire(s)) for _ in range(50) for s in SITES])
    assert seqs[0] == seqs[1]
    other = FaultPlane(FaultPlan(seed=8, schedule={s: 0.3 for s in SITES}), counters={})
    assert seqs[0] != [(s, other.fire(s)) for _ in range(50) for s in SITES]


def test_fault_plane_draws_equal_the_reference():
    """The same plan fires at the same occurrence indexes in both packages."""
    from repro.core.faults import FaultPlan as RefPlan
    from repro.core.faults import FaultPlane as RefPlane

    sched = {"morsel": 0.2, "rehydrate": (1, 4, 9), "stall": 0.5}
    port = FaultPlane(FaultPlan(seed=11, schedule=sched, max_injections=40), {})
    ref = RefPlane(RefPlan(seed=11, schedule=sched, max_injections=40), {})
    for _ in range(60):
        for s in SITES:
            assert port.fire(s) == ref.fire(s)
    assert port.counters == ref.counters


def test_fault_plane_schedule_forms_and_caps():
    c = {}
    fp = FaultPlane(FaultPlan(seed=1, schedule={"morsel": {0, 2}}), counters=c)
    assert [fp.fire("morsel") for _ in range(4)] == [True, False, True, False]
    assert all(not fp.fire("exchange") for _ in range(10))  # unscheduled site
    assert c["faults_injected"] == 2
    capped = FaultPlane(
        FaultPlan(seed=1, schedule={"morsel": 1.0}, max_injections=3), counters={}
    )
    assert sum(capped.fire("morsel") for _ in range(10)) == 3
    assert not FaultPlane(FaultPlan(seed=1, schedule={"morsel": 0.0}), {}).fire("morsel")


def test_fault_plan_validates():
    with pytest.raises(ValueError):
        FaultPlan(schedule={"warp_drive": 0.5})
    with pytest.raises(ValueError):
        FaultPlan(schedule={"morsel": 1.5})
    with pytest.raises(ValueError):
        FaultPlan(schedule={"morsel": 0.1}, retry_limit=-1)
    with pytest.raises(ValueError):
        EngineConfig(faults="chaos")  # must be a FaultPlan


def test_attempt_retries_charge_virtual_clock():
    clock = _TickClock()
    c = {}
    fp = FaultPlane(
        FaultPlan(seed=3, schedule={"morsel": 1.0}, retry_limit=2, backoff_s=1e-4),
        counters=c,
    )
    assert not fp.attempt("morsel", clock)
    assert c["faults_injected"] == 3
    assert c["fault_retries"] == 2
    assert clock.now == pytest.approx(1e-4 * (1 + 2))
    ok_clock = _TickClock()
    ok = FaultPlane(FaultPlan(seed=3, schedule={"morsel": 0.0}, retry_limit=2), {})
    assert ok.attempt("morsel", ok_clock) and ok_clock.now == 0.0


# ---------------------------------------------------------------------------
# Zero-perturbation identity
# ---------------------------------------------------------------------------


def test_empty_schedule_bit_identical_to_no_faults(tdb):
    rng = np.random.default_rng(31_000)
    qs = _workload(tdb, rng)
    outs = []
    for faults in (None, FaultPlan(seed=123, schedule={})):
        session = _connect(tdb, mode="graft", morsel_size=4096, faults=faults)
        futs = session.submit_all(_rebuild(tdb, qs))
        session.run()
        outs.append((
            [{k: np.asarray(v) for k, v in f.result().items()} for f in futs],
            session.now,
            dict(session._engine.counters),
            session.backend.stats(),
        ))
        session.close()
    (res_a, now_a, c_a, b_a), (res_b, now_b, c_b, b_b) = outs
    assert now_a == now_b
    for ra, rb in zip(res_a, res_b):
        assert set(ra) == set(rb)
        for k in ra:
            np.testing.assert_array_equal(ra[k], rb[k])
    assert c_b["faults_injected"] == 0 and c_b["fault_retries"] == 0
    assert c_a == c_b and b_a == b_b


# ---------------------------------------------------------------------------
# Per-query lifecycle: cancel, deadline, QueryCancelled
# ---------------------------------------------------------------------------


def test_cancel_and_deadline_lifecycle(tdb):
    rng = np.random.default_rng(31_100)
    q0, q1, q2 = (queries.sample_query(tdb, rng, arrival=0.0) for _ in range(3))
    session = _connect(tdb, mode="graft", morsel_size=2048)
    f0 = session.submit(q0)
    f1 = session.submit(q1, deadline=1e-7)
    f2 = session.submit(q2, deadline=1e9)
    assert f0.status in ("queued", "active")
    assert f0.cancel() is True
    assert f0.status == "cancelled" and f0.cancelled
    session.run()
    assert f1.status == "deadline" and f1.cancelled
    assert f2.status == "done" and not f2.cancelled
    _assert_parity(f2.result(), refexec.execute(tdb, q2.plan), "deadline-met")
    for f, status in ((f0, "cancelled"), (f1, "deadline")):
        with pytest.raises(QueryCancelled) as ei:
            f.result()
        assert ei.value.status == status
        assert f.stats()["status"] == status
        assert f.cancel() is False
    assert f2.cancel() is False
    stats = f2.stats()
    assert stats["faults"]["cancelled"] >= 2
    assert stats["faults"]["deadline_cancellations"] == 1
    session.close()


def test_submit_deadline_validation(tdb):
    rng = np.random.default_rng(31_101)
    session = _connect(tdb, mode="graft")
    for bad in (float("nan"), float("inf"), "soon", True):
        with pytest.raises((TypeError, ValueError)):
            session.submit(queries.sample_query(tdb, rng), deadline=bad)
    session.close()


# ---------------------------------------------------------------------------
# Quarantine + unfold
# ---------------------------------------------------------------------------


def test_producer_handoff_preserves_survivor_results(tdb):
    """Batched same-plan pairs where the producing query hits its deadline
    mid-delivery: surviving beneficiaries adopt the residual extents and
    finish bit-identical to the fault-free oracle. The machinery assertion
    (handoffs > 0) keeps the scenario honest."""
    handoffs = 0
    deep = {"q3", "q4", "q5", "q7", "q9", "q10"}  # multi-join: several producers
    for trial in range(8):
        rng = np.random.default_rng(31_200 + trial)
        q = queries.sample_query(tdb, rng)
        while q.template not in deep:
            q = queries.sample_query(tdb, rng)
        oracle = refexec.execute(tdb, q.plan)
        for deadline in (2e-5, 1e-4):
            session = _connect(tdb, **BATCHED)
            fa = session.submit(
                queries.make_query(tdb, q.template, q.params, arrival=0.0),
                deadline=deadline,
            )
            fb = session.submit(queries.make_query(tdb, q.template, q.params, arrival=0.0))
            session.run()
            eng = session._engine
            handoffs += int(eng.counters["producer_handoffs"])
            assert not eng._lens_leases, "lens leases must drain by idle"
            assert eng.cohort_ctx is None
            assert fb.status == "done", (trial, deadline, fb.status)
            _assert_parity(fb.result(), oracle, f"handoff t{trial} dl={deadline}")
            if fa.status == "done":
                _assert_parity(fa.result(), oracle, f"handoff t{trial} fa")
            else:
                assert fa.status == "deadline"
            session.close()
    assert handoffs > 0, "no producer handoff exercised — scenario went stale"


def test_unfold_marks_degraded_and_stays_correct(tdb):
    rng = np.random.default_rng(31_300)
    qs = [queries.sample_query(tdb, rng, arrival=0.0) for _ in range(2)]
    refs = [refexec.execute(tdb, q.plan) for q in qs]
    session = _connect(
        tdb, mode="graft", morsel_size=4096, capture_explain=True,
        faults=FaultPlan(seed=5, schedule={"morsel": {0}}, retry_limit=0),
    )
    futs = session.submit_all(_rebuild(tdb, qs))
    session.run()
    eng = session._engine
    assert eng.counters["faults_injected"] >= 1
    assert eng.counters["quarantined_states"] >= 1
    assert eng.counters["unfolds"] >= 1
    degraded = 0
    for f, ref in zip(futs, refs):
        assert f.status == "done", f.status
        _assert_parity(f.result(), ref, "unfolded")
        if f.stats()["degraded"]:
            degraded += 1
            assert f.explain().degraded
            assert "DEGRADED" in f.explain().render()
    assert degraded >= 1
    session.close()


def test_quarantined_state_never_spills(tdb):
    """A quarantined state dies through eviction but never enters the
    reuse plane: its fragments are suspect."""
    rng = np.random.default_rng(31_300)
    qs = [queries.sample_query(tdb, rng, arrival=0.0) for _ in range(2)]
    session = _connect(
        tdb, mode="graft", morsel_size=4096, retention="epoch", memory_budget=0,
        reuse_cache_budget=64_000_000,
        faults=FaultPlan(seed=5, schedule={"morsel": {0}}, retry_limit=0),
    )
    spilled = []
    orig = session.engine.reuse.spill
    session.engine.reuse.spill = lambda st: spilled.append(st) or orig(st)
    session.submit_all(_rebuild(tdb, qs))
    session.run()
    assert session.counters["quarantined_states"] >= 1
    assert spilled and not any(st.quarantined for st in spilled)
    session.close()


@pytest.mark.parametrize("trial", range(3))
def test_rate_one_fault_storm_terminates(tdb, trial):
    rng = np.random.default_rng(31_400 + trial)
    qs = [queries.sample_query(tdb, rng, arrival=i * 0.001) for i in range(4)]
    session = _connect(
        tdb, mode="graft", morsel_size=4096,
        faults=FaultPlan(seed=trial, schedule={"morsel": 1.0}, retry_limit=1),
    )
    futs = session.submit_all(_rebuild(tdb, qs))
    session.run()
    for f in futs:
        assert f.status == "failed", (trial, f.status)
        with pytest.raises(QueryCancelled):
            f.result()
    assert not session._engine._lens_leases
    session.close()


# ---------------------------------------------------------------------------
# Chaos differential fuzz
# ---------------------------------------------------------------------------


def _chaos_session(pkg, db, qs, mode, workers, sched, fault_seed, cancel_ix, deadline_ix,
                   module=queries, **backend):
    cfg = dict(
        mode=mode, morsel_size=4096, workers=workers, partitions=workers,
        faults=pkg.FaultPlan(seed=fault_seed, schedule=sched, retry_limit=2), **backend,
    )
    if "rehydrate" in sched:
        cfg.update(retention="epoch", memory_budget=150_000, reuse_cache_budget=400_000)
    session = pkg.connect(db, pkg.EngineConfig(**cfg))
    futs = []
    for i, q in enumerate(_rebuild(db, qs, module)):
        q = dataclasses.replace(q, qid=30_000 + i)
        futs.append(session.submit(q, deadline=(2e-4 if i in deadline_ix else None)))
    for i in cancel_ix:
        futs[i].cancel()
    session.run()
    return session, futs


def _chaos_run(tdb, qs, mode, workers, sched, fault_seed, cancel_ix, deadline_ix):
    session, futs = _chaos_session(graftdb_torch, tdb, qs, mode, workers, sched,
                                   fault_seed, cancel_ix, deadline_ix, device="cpu")
    statuses = [f.status for f in futs]
    results = [f.result() if s == "done" else None for f, s in zip(futs, statuses)]
    counters = {
        k: session._engine.counters.get(k, 0)
        for k in ("faults_injected", "fault_retries", "producer_handoffs",
                  "quarantined_states", "unfolds", "cancelled",
                  "deadline_cancellations", "cache_corrupt")
    }
    assert not session._engine._lens_leases, "lens leases leaked"
    session.close()
    return statuses, results, counters


def _chaos_case(rng, seed, qs):
    mode = ALL_MODES[seed % len(ALL_MODES)]
    mix_name, sched = FAULT_MIXES[seed % len(FAULT_MIXES)]
    cancel_ix = {int(rng.integers(len(qs)))} if seed % 2 else set()
    deadline_ix = {int(rng.integers(len(qs)))} if seed % 3 == 0 else set()
    return mode, mix_name, sched, cancel_ix, deadline_ix


def test_chaos_differential_fuzz(tdb):
    """Seeded fault schedules x all five modes x workers {1, 4} x
    cancellation/deadline mixes. Every surviving query equals the
    fault-free reference executor; every non-survivor is terminal. The
    sweep checks that it injected faults, retried and killed queries."""
    terminal = {"cancelled", "deadline", "failed"}
    injected = retried = survived = killed = 0
    for seed in CHAOS_SEEDS:
        rng = np.random.default_rng(31_000 + seed)
        qs = _workload(tdb, rng)
        refs = [refexec.execute(tdb, q.plan) for q in qs]
        mode, mix_name, sched, cancel_ix, deadline_ix = _chaos_case(rng, seed, qs)
        for workers in (1, 4):
            statuses, results, counters = _chaos_run(
                tdb, qs, mode, workers, sched, 900 + seed, cancel_ix, deadline_ix
            )
            injected += counters["faults_injected"]
            retried += counters["fault_retries"]
            for i, (status, res) in enumerate(zip(statuses, results)):
                ctx = f"seed{seed}/{mode}/{mix_name}/w{workers}/q{i}"
                if status == "done":
                    survived += 1
                    _assert_parity(res, refs[i], ctx)
                else:
                    killed += 1
                    assert status in terminal, ctx
    assert injected > 0, "chaos sweep never injected a fault"
    assert retried > 0, "chaos sweep never exercised a retry"
    assert survived >= 20, f"too few survivors ({survived}) to claim parity coverage"
    assert killed > 0, "no query was ever cancelled/failed — mixes too gentle"


def test_chaos_replay_is_deterministic(tdb):
    rng = np.random.default_rng(31_900)
    qs = _workload(tdb, rng)
    runs = [
        _chaos_run(tdb, qs, "graft", 4, {"morsel": 0.03, "stall": 0.05}, 42,
                   cancel_ix=set(), deadline_ix={0})
        for _ in range(2)
    ]
    (st_a, res_a, c_a), (st_b, res_b, c_b) = runs
    assert st_a == st_b
    assert c_a == c_b
    for ra, rb in zip(res_a, res_b):
        assert (ra is None) == (rb is None)
        if ra is not None:
            for k in ra:
                np.testing.assert_array_equal(np.asarray(ra[k]), np.asarray(rb[k]))


# ---------------------------------------------------------------------------
# Parity with the reference under one FaultPlan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 4])
def test_fault_trace_matches_reference(db, tdb, seed):
    """A chaos case through ``graftdb`` (``backend="pallas"``) and the port
    at workers {1, 4}: statuses, results bit for bit, engine counters (the
    fault counters among them), backend counters, per-query stats and the
    virtual clock are identical."""
    rng = np.random.default_rng(31_000 + seed)
    qs = _workload(db, rng, module=ref_queries)
    mode, _, sched, cancel_ix, deadline_ix = _chaos_case(rng, seed, qs)
    injected = 0
    for workers in (1, 4):
        s_ref, f_ref = _chaos_session(graftdb, db, qs, mode, workers, sched, 900 + seed,
                                      cancel_ix, deadline_ix, ref_queries, backend="pallas")
        s_port, f_port = _chaos_session(graftdb_torch, tdb, qs, mode, workers, sched,
                                        900 + seed, cancel_ix, deadline_ix, device="cpu")
        assert [f.status for f in f_port] == [f.status for f in f_ref]
        for a, b in zip(f_ref, f_port):
            if a.status == "done":
                ra, rb = a.result(), b.result()
                assert set(ra) == set(rb)
                for k in ra:
                    np.testing.assert_array_equal(rb[k], ra[k])
            assert b.stats() == a.stats()
        assert dict(s_port.counters) == dict(s_ref.counters)
        assert s_port.now == s_ref.now
        assert s_port.backend.stats() == s_ref.backend.stats()
        injected += s_port.counters["faults_injected"]
        s_ref.close()
        s_port.close()
    assert injected > 0


def test_quarantine_matches_reference(db, tdb):
    """Retry exhaustion at the first morsel: the quarantine, the unfolds,
    the degraded stats and EXPLAIN GRAFT equal the reference's."""
    rng = np.random.default_rng(31_300)
    qs = [ref_queries.sample_query(db, rng, arrival=0.0) for _ in range(2)]
    plan = dict(seed=5, schedule={"morsel": {0}}, retry_limit=0)
    runs = []
    for pkg, d, mod, backend in ((graftdb, db, ref_queries, dict(backend="pallas")),
                                 (graftdb_torch, tdb, queries, dict(device="cpu"))):
        s = pkg.connect(d, pkg.EngineConfig(mode="graft", morsel_size=4096,
                                            capture_explain=True,
                                            faults=pkg.FaultPlan(**plan), **backend))
        futs = s.submit_all([dataclasses.replace(q, qid=40_000 + i)
                             for i, q in enumerate(_rebuild(d, qs, mod))])
        s.run()
        runs.append((s, futs))
    (s_ref, f_ref), (s_port, f_port) = runs
    assert s_port.counters["quarantined_states"] >= 1
    assert dict(s_port.counters) == dict(s_ref.counters)
    assert s_port.now == s_ref.now
    for a, b in zip(f_ref, f_port):
        assert b.stats() == a.stats()
        assert b.explain().render() == a.explain().render()
        for k, v in a.result().items():
            np.testing.assert_array_equal(b.result()[k], v)


# ---------------------------------------------------------------------------
# Session.close with queued + in-flight arrivals
# ---------------------------------------------------------------------------


def test_session_close_cancels_queued_and_inflight(tdb):
    rng = np.random.default_rng(31_500)
    session = _connect(tdb, mode="graft", morsel_size=2048, admission="adaptive",
                       admission_max_inflight=1)
    futs = [
        session.submit(queries.sample_query(tdb, rng, arrival=i * 0.001))
        for i in range(4)
    ]
    with pytest.raises(RuntimeError):
        session._runner.run((), max_steps=4)
    assert any(f.status == "active" for f in futs)
    assert any(f.status == "queued" for f in futs)
    session.close()
    for f in futs:
        assert f.status in ("cancelled", "done"), f.status
        if f.status == "cancelled":
            with pytest.raises(QueryCancelled):
                f.result()
        assert f.cancel() is False
    assert not session._runner._heap and not session._runner.deadlines
    eng = session._engine
    assert not eng.active_handles and not eng._lens_leases
    assert not any(s.pins for h in eng.handles.values() for s in h.attached_states)


def test_close_is_idempotent_and_post_close_submit_fails(tdb):
    session = _connect(tdb, mode="graft")
    session.close()
    session.close()
    with pytest.raises(RuntimeError):
        session.submit(queries.sample_query(tdb, np.random.default_rng(0)))


# ---------------------------------------------------------------------------
# Artifact integrity + temp-dir hygiene
# ---------------------------------------------------------------------------


def _disk_art(store, key, nbytes=400):
    fp = ("hash_build", (key,), ())
    art = StateArtifact(fp, "hash_build", None, nbytes, {},
                        {"x": np.arange(max(1, nbytes // 8), dtype=np.float64)})
    assert store.put(art)
    return fp


def test_corrupt_artifact_is_a_cache_miss():
    c = {}
    store = ArtifactStore(budget=100, disk_budget=10_000, counters=c)
    fp = _disk_art(store, "flip")
    path = store._paths[fp]
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    assert store.get(fp) is None
    assert c["cache_corrupt"] == 1
    assert store.get(fp) is None
    assert c["cache_corrupt"] == 1
    fp2 = _disk_art(store, "trunc")
    path2 = store._paths[fp2]
    open(path2, "wb").write(open(path2, "rb").read()[:16])
    assert store.get(fp2) is None
    assert c["cache_corrupt"] == 2
    fp3 = _disk_art(store, "gone")
    os.unlink(store._paths[fp3])
    assert store.get(fp3) is None
    assert c["cache_corrupt"] == 3
    fp4 = _disk_art(store, "fresh")
    assert store.get(fp4) is not None
    store.close()


def test_rehydrate_fault_injection_counts_as_corrupt(tdb):
    rng = np.random.default_rng(31_600)
    q0 = queries.sample_query(tdb, rng)
    qs = [queries.make_query(tdb, q0.template, q0.params, arrival=float(i)) for i in range(3)]
    refs = [refexec.execute(tdb, q.plan) for q in qs]
    session = _connect(
        tdb, mode="graft", morsel_size=4096, retention="epoch", memory_budget=0,
        reuse_cache_budget=64_000_000, faults=FaultPlan(seed=9, schedule={"rehydrate": 1.0}),
    )
    futs = session.submit_all(qs)
    session.run()
    assert session._engine.counters["cache_corrupt"] >= 1
    for f, ref in zip(futs, refs):
        assert f.status == "done"
        _assert_parity(f.result(), ref, "rehydrate-fault")
    session.close()


def test_disk_tier_temp_dir_cleanup_and_stale_sweep(tmp_path, monkeypatch):
    # a temp root of the test's own, so no other test's sweep races it
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    store = ArtifactStore(budget=100, disk_budget=10_000)
    _disk_art(store, "a")
    d = store._dir
    assert d is not None and os.path.isdir(d)
    store.close()
    assert not os.path.exists(d)

    root = tempfile.gettempdir()
    dead = tempfile.mkdtemp(prefix="graftdb-torch-reuse-", dir=root)
    with open(os.path.join(dead, "owner.pid"), "w") as f:
        f.write("999999999")  # beyond pid_max: guaranteed dead
    mine = tempfile.mkdtemp(prefix="graftdb-torch-reuse-", dir=root)
    with open(os.path.join(mine, "owner.pid"), "w") as f:
        f.write(str(os.getpid()))
    fresh = tempfile.mkdtemp(prefix="graftdb-torch-reuse-", dir=root)
    try:
        s2 = ArtifactStore(budget=100, disk_budget=10_000)
        assert not os.path.exists(dead), "dead-owner dir survived the sweep"
        assert os.path.isdir(mine), "live-owner dir was swept"
        assert os.path.isdir(fresh), "unmarked fresh dir was raced"
        s2.close()
    finally:
        shutil.rmtree(mine, ignore_errors=True)
        shutil.rmtree(fresh, ignore_errors=True)
        shutil.rmtree(dead, ignore_errors=True)


def test_sweeps_leave_the_other_package_alone(tmp_path, monkeypatch):
    """The port's disk tier has a prefix of its own: each package's sweep
    passes over the other's dead-owner directories."""
    from repro.core.reuse import ArtifactStore as RefStore

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    root = tempfile.gettempdir()
    made = {}
    for prefix in ("graftdb-reuse-", "graftdb-torch-reuse-"):
        made[prefix] = tempfile.mkdtemp(prefix=prefix, dir=root)
        with open(os.path.join(made[prefix], "owner.pid"), "w") as f:
            f.write("999999999")
    try:
        ArtifactStore(budget=100, disk_budget=10_000).close()
        assert os.path.isdir(made["graftdb-reuse-"])
        assert not os.path.exists(made["graftdb-torch-reuse-"])
        os.makedirs(made["graftdb-torch-reuse-"])
        with open(os.path.join(made["graftdb-torch-reuse-"], "owner.pid"), "w") as f:
            f.write("999999999")
        RefStore(budget=100, disk_budget=10_000).close()
        assert os.path.isdir(made["graftdb-torch-reuse-"])
        assert not os.path.exists(made["graftdb-reuse-"])
    finally:
        for d in made.values():
            shutil.rmtree(d, ignore_errors=True)
