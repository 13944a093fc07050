"""The port's graft-aware batch planning (DESIGN.md §15) against the reference.

Ports of ``tests/test_batch_planning.py``'s tests run the port alone
(``graftdb_torch``, ``device="cpu"``: every kernel runs its plain PyTorch
version): coverage dominance, the strict gain on a nested burst, permutation
invariance, same-instant ties, singleton byte-identity with the greedy path,
the flag-off identity, planner purity, EXPLAIN GRAFT COHORT, ``batch_window``
grouping, the future's cohort record and the admission-memo tests. The two
serving tests at the end of that file are in ``test_torch_serving.py``.

Parity tests run one burst trace through ``graftdb`` (``backend="pallas"``)
and ``graftdb_torch`` with batch planning on and compare results (bit for
bit, and against the port's reference executor at rtol 1e-9), every engine
counter (``batch_*`` among them), the admission log with its cohort
records, the ``cohort_log`` plans, per-query stats and EXPLAIN GRAFT, the
backend's counters, the virtual clock and EXPLAIN GRAFT COHORT.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import graftdb
import graftdb_torch
from _torch_traces import burst_trace
from graftdb_torch import EngineConfig, FaultPlan
from repro.relational import queries as ref_queries
from repro_torch.core.batchplan import CohortPlan, plan_cohort, profile_query, snapshot_coverage
from repro_torch.core.scheduler import AdmissionController
from repro_torch.relational import queries, refexec
from repro_torch.relational.table import database_from_numpy, days

torch.set_num_threads(2)

ADMIT = dict(
    mode="graft",
    morsel_size=4096,
    retention="epoch",
    admission="adaptive",
    admission_max_inflight=2,
    admission_share_threshold=0.4,
)


@pytest.fixture(scope="module")
def tdb(db):
    return database_from_numpy(db.tables, db.scale_factor)


def _connect(tdb, **kw):
    return graftdb_torch.connect(tdb, EngineConfig(device="cpu", **kw))


def _q3(db, date, seg=1.0, arrival=0.0):
    return queries.make_query(
        db, "q3", {"segment": seg, "date": float(days(date))}, arrival
    )


def _canon(res):
    keys = sorted(res)
    order = np.lexsort([np.asarray(res[k]) for k in keys])
    return {k: np.asarray(res[k])[order] for k in keys}


def _burst(db, rng, n, arrival=0.0):
    return [queries.sample_query(db, rng, arrival=arrival) for _ in range(n)]


def _spread(db, rng, n, gap=1e6):
    return [queries.sample_query(db, rng, arrival=i * gap) for i in range(n)]


def _rebuild(db, qs, module=queries):
    return [
        module.make_query(db, q.template, q.params, arrival=q.arrival) for q in qs
    ]


def _warm_session(tdb, **overrides):
    """A session with live shared state: one wide q3 executed and retired
    (epoch retention keeps it attachable), so cohort planning scores against
    a non-trivial snapshot."""
    cfg = dict(mode="graft", morsel_size=4096, retention="epoch")
    cfg.update(overrides)
    session = _connect(tdb, **cfg)
    session.submit(_q3(tdb, "1995-03-28"))
    session.run()
    return session


# ---------------------------------------------------------------------------
# (a) coverage dominance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_cohort_coverage_dominates_greedy_snapshot(tdb, seed):
    """Property (a): planned coverage >= per-query greedy snapshot coverage,
    member-wise and in total, on warm and cold snapshots alike."""
    rng = np.random.default_rng(31_000 + seed)
    session = _warm_session(tdb) if seed % 2 else _connect(
        tdb, mode="graft", morsel_size=4096
    )
    qs = _burst(tdb, rng, int(rng.integers(2, 6)))
    plan = plan_cohort(session.engine, qs)
    assert plan.size == len(qs)
    for m in plan.members:
        assert m.planned_rows >= m.snapshot_rows, m
        assert m.planned_rows <= m.demand_rows
    assert plan.planned_rows >= plan.snapshot_rows
    assert plan.gain_rows == plan.planned_rows - plan.snapshot_rows
    for m in plan.members:
        q = next(q for q in qs if q.qid == m.qid)
        assert m.snapshot_rows == snapshot_coverage(
            session.engine, profile_query(session.engine, q)
        )
    session.close()


def test_nested_burst_has_strict_gain(tdb):
    """A narrow-first same-instant q3 burst: greedy snapshot coverage is 0
    on a cold engine, while the planned order lets the narrower dates ride
    the widest member."""
    session = _connect(tdb, mode="graft", morsel_size=4096)
    qs = [_q3(tdb, d) for d in ("1995-03-05", "1995-03-12", "1995-03-25")]
    plan = plan_cohort(session.engine, qs)
    assert plan.order[0] == qs[-1].qid
    assert plan.gain_rows > 0
    assert plan.members[0].provider_weight > max(
        m.provider_weight for m in plan.members[1:]
    )
    session.close()


# ---------------------------------------------------------------------------
# (b) permutation invariance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_plan_invariant_under_input_permutation(tdb, seed):
    rng = np.random.default_rng(32_000 + seed)
    session = _warm_session(tdb)
    qs = _burst(tdb, rng, 4)
    base = plan_cohort(session.engine, qs)
    for perm in itertools.permutations(qs):
        assert plan_cohort(session.engine, list(perm)) == base
    session.close()


def test_same_instant_ties_order_by_qid(tdb):
    """Equal-arrival, equal-weight members break ties on qid."""
    session = _connect(tdb, mode="graft", morsel_size=4096)
    qs = [_q3(tdb, "1995-03-10", seg=float(s)) for s in (0.0, 2.0, 3.0)]
    plan = plan_cohort(session.engine, qs)
    assert plan.order == tuple(q.qid for q in qs)
    assert all(m.provider_weight == 0 for m in plan.members)
    session.close()


# ---------------------------------------------------------------------------
# (c) singleton equivalence: batch path == greedy path, byte for byte
# ---------------------------------------------------------------------------


def _run_trace(tdb, qs, **cfg):
    session = _connect(tdb, **cfg)
    futs = session.submit_all(qs)
    session.run()
    return session, futs


@pytest.mark.parametrize("workers,partitions", [(1, 1), (4, 4)])
def test_singleton_cohorts_byte_identical_to_greedy(tdb, workers, partitions):
    """Property (c): arrivals spread far beyond any batch window form
    cohorts of size 1, and the batched path replays the greedy engine:
    results, counters, admission log and clock."""
    rng = np.random.default_rng(77)
    qs = _spread(tdb, rng, 4)
    cfg = dict(ADMIT, workers=workers, partitions=partitions)
    sg, fg = _run_trace(tdb, _rebuild(tdb, qs), **cfg)
    sb, fb = _run_trace(tdb, _rebuild(tdb, qs), **dict(cfg, batch_planning=True))
    for a, b in zip(fg, fb):
        ra, rb = a.result(), b.result()
        assert set(ra) == set(rb)
        for k in ra:
            np.testing.assert_array_equal(np.asarray(ra[k]), np.asarray(rb[k]), err_msg=k)
    assert sb.counters == sg.counters
    assert sb.counters["batch_cohorts"] == 0
    assert sb.cohort_log() == []
    assert [
        sb._runner.admission_log[b.qid] for b in fb
    ] == [sg._runner.admission_log[g_.qid] for g_ in fg]
    assert sb.now == sg.now
    assert sb.backend.stats() == sg.backend.stats()
    sg.close(), sb.close()


def test_flag_off_is_the_greedy_engine(tdb):
    """batch_planning=False never routes through the batched path."""
    rng = np.random.default_rng(78)
    qs = _burst(tdb, rng, 4)
    sg, fg = _run_trace(tdb, _rebuild(tdb, qs), **dict(ADMIT, workers=1, partitions=1))
    so, fo = _run_trace(
        tdb, _rebuild(tdb, qs), **dict(ADMIT, workers=1, partitions=1, batch_planning=False)
    )
    for a, b in zip(fg, fo):
        ra, rb = a.result(), b.result()
        for k in ra:
            np.testing.assert_array_equal(np.asarray(ra[k]), np.asarray(rb[k]), err_msg=k)
    assert so.counters == sg.counters
    assert so.now == sg.now
    sg.close(), so.close()


# ---------------------------------------------------------------------------
# (d) purity
# ---------------------------------------------------------------------------


def test_planner_is_pure_function_of_snapshot(tdb):
    session = _warm_session(tdb)
    eng = session.engine
    rng = np.random.default_rng(5)
    qs = _burst(tdb, rng, 4)
    gen0 = eng.state_gen
    counters0 = dict(eng.counters)
    states0 = {sig: list(lst) for sig, lst in eng.state_index.items()}
    aggs0 = dict(eng.agg_index)
    stats0 = session.backend.stats()
    p1 = plan_cohort(eng, qs)
    p2 = plan_cohort(eng, qs)
    assert p1 == p2
    assert isinstance(p1, CohortPlan)
    assert eng.state_gen == gen0
    assert dict(eng.counters) == counters0
    assert {sig: list(lst) for sig, lst in eng.state_index.items()} == states0
    assert dict(eng.agg_index) == aggs0
    assert session.backend.stats() == stats0  # planning never touches the backend
    session.close()


def test_explain_cohort_read_only_and_consistent(tdb):
    session = _warm_session(tdb)
    qs = [_q3(tdb, d, arrival=session.now) for d in ("1995-03-05", "1995-03-25")]
    gen0 = session.engine.state_gen
    stats0 = session.backend.stats()
    exp = session.explain_cohort(qs)
    assert session.engine.state_gen == gen0
    assert session.backend.stats() == stats0
    assert exp.plan == plan_cohort(session.engine, qs)
    text = exp.render()
    assert "EXPLAIN GRAFT COHORT: 2 queries" in text
    assert "scan group" in text
    assert text.count("EXPLAIN GRAFT q") == 2
    d = exp.to_dict()
    assert set(d) == {"plan", "members"}
    assert d["plan"]["order"] == list(exp.plan.order)
    assert [m["qid"] for m in d["plan"]["members"]] == list(exp.plan.order)
    session.close()


# ---------------------------------------------------------------------------
# cohort formation + accounting through the public surface
# ---------------------------------------------------------------------------


def test_batch_window_groups_cohorts(tdb):
    """Arrivals at (0, 0, far-later) with a tight window form exactly one
    2-cohort; the straggler admits as a singleton (not logged)."""
    session = _connect(
        tdb, mode="graft", morsel_size=4096, batch_planning=True, batch_window=0.1
    )
    qs = [
        _q3(tdb, "1995-03-05", arrival=0.0),
        _q3(tdb, "1995-03-25", arrival=0.0),
        _q3(tdb, "1995-03-15", arrival=1e9),
    ]
    futs = session.submit_all(qs)
    session.run()
    log = session.cohort_log()
    assert len(log) == 1
    assert log[0]["cohort"] == 0
    assert log[0]["plan"].size == 2
    assert set(log[0]["plan"].order) == {qs[0].qid, qs[1].qid}
    assert session.counters["batch_cohorts"] == 1
    assert session.counters["batch_planned_queries"] == 2
    st = session.stats()
    assert st["batch_planning"] is True and st["batch_window"] == 0.1
    for f, q in zip(futs, qs):
        c = _canon(f.result())
        r = _canon(refexec.execute(tdb, q.plan))
        for k in c:
            np.testing.assert_allclose(c[k], r[k], rtol=1e-12, atol=1e-12)
    assert session.engine.cohort_ctx is None
    session.close()


def test_future_stats_expose_cohort_record(tdb):
    session = _connect(tdb, **dict(ADMIT, admission_max_inflight=8, batch_planning=True))
    qs = [_q3(tdb, d) for d in ("1995-03-05", "1995-03-12", "1995-03-25")]
    futs = session.submit_all(qs)
    session.run()
    metas = [f.stats()["admission"].get("cohort") for f in futs]
    metas = [m for m in metas if m is not None]
    assert metas, "no admission record carried cohort metadata"
    assert all(set(m) == {"cohort", "size", "slot"} for m in metas)
    assert sorted(m["slot"] for m in metas) == list(range(len(metas)))
    c = futs[0].stats()["counters"]
    assert c["batch_cohorts"] >= 1
    assert c["batch_planned_queries"] == len(metas)
    assert c["batch_coverage_gain_rows"] > 0
    session.close()


# ---------------------------------------------------------------------------
# §10 admission memo
# ---------------------------------------------------------------------------


def test_admission_potentials_memoized_until_state_changes(tdb):
    session = _connect(tdb, mode="graft", morsel_size=4096)
    eng = session.engine
    ctl = AdmissionController(max_inflight=2)
    q = _q3(tdb, "1995-03-15")
    ctl.potentials(eng, q)
    ctl.potentials(eng, q)
    assert eng.counters["admission_evals"] == 1
    f = session.submit(_q3(tdb, "1995-03-20"))
    session.run()
    f.result()
    ctl.potentials(eng, q)
    assert eng.counters["admission_evals"] == 2
    session.close()


def test_admit_verdict_drops_memo_entry(tdb):
    session = _connect(tdb, mode="graft", morsel_size=4096)
    ctl = AdmissionController(max_inflight=2)
    q = _q3(tdb, "1995-03-15")
    verdict, _ = ctl.decide(session.engine, q)
    assert verdict == "admit"
    assert q.qid not in ctl._pot_memo
    session.close()


def test_deep_queue_no_longer_rescans_every_step(tdb):
    """A deep deferred FIFO queue re-evaluates an arrival's graft potential
    only when the engine's state generation moved."""

    class Counting(AdmissionController):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.decisions = 0

        def decide(self, engine, query, active_count=None):
            self.decisions += 1
            return super().decide(engine, query, active_count=active_count)

    rng = np.random.default_rng(9)
    qs = _burst(tdb, rng, 6)
    session = _connect(
        tdb, mode="graft", morsel_size=4096, retention="epoch",
        admission="adaptive", admission_max_inflight=1,
        admission_share_threshold=0.99,
    )
    ctl = Counting(max_inflight=1, share_threshold=0.99)
    session._runner.admission = ctl
    futs = session.submit_all(qs)
    session.run()
    for f in futs:
        f.result()
    evals = session.counters["admission_evals"]
    assert session.counters["queued_admissions"] > 0
    assert ctl.decisions > len(qs)
    assert evals < ctl.decisions
    assert evals <= len(qs) * (session.engine.state_gen + 1)
    session.close()


# ---------------------------------------------------------------------------
# cohort_ctx never outlives its cohort
# ---------------------------------------------------------------------------


def test_cohort_ctx_cleared_when_admission_raises(tdb):
    """An exception out of a cohort member's admission leaves ``cohort_ctx``
    cleared: later greedy admissions never see the cohort's extents."""
    session = _connect(tdb, mode="graft", morsel_size=4096, batch_planning=True)
    runner = session._runner
    seen = []
    submit_now = runner.submit_now

    def failing(q):
        seen.append(session.engine.cohort_ctx)
        if len(seen) == 2:
            raise RuntimeError("admission failed")
        return submit_now(q)

    runner.submit_now = failing
    session.submit_all([_q3(tdb, d) for d in ("1995-03-05", "1995-03-12", "1995-03-25")])
    with pytest.raises(RuntimeError, match="admission failed"):
        session.run()
    assert seen[0] is not None and seen[1] is not None
    assert session.engine.cohort_ctx is None


@pytest.mark.parametrize("fault_seed", [3, 11])
def test_planned_trace_under_fault_plan(tdb, fault_seed):
    """Cohorts admitted under chaos injection: every completed query equals
    the reference executor, cohorts formed, and the context is cleared."""
    plan = FaultPlan(seed=fault_seed, schedule={"morsel": 0.02, "stall": 0.05})
    session = _connect(
        tdb, mode="graft", morsel_size=2048, batch_planning=True, faults=plan
    )
    futs = session.submit_all(burst_trace(tdb, 3, 3))
    session.run()
    assert session.counters["batch_cohorts"] == 3
    assert session.counters["faults_injected"] > 0
    assert session.engine.cohort_ctx is None
    for f in futs:
        assert f.status == "done", f.status
        c, r = _canon(f.result()), _canon(refexec.execute(tdb, f.query.plan))
        for k in c:
            np.testing.assert_allclose(c[k], r[k], rtol=1e-9)
    session.close()


# ---------------------------------------------------------------------------
# parity with the reference (graftdb, backend="pallas")
# ---------------------------------------------------------------------------


def _same_qids(qs):
    """Pin query ids (each package numbers its queries on its own), so
    plans, admission logs and EXPLAIN renders compare equal."""
    return [dataclasses.replace(q, qid=20_000 + i) for i, q in enumerate(qs)]


def _cohorts(session):
    return [
        {"cohort": e["cohort"], "t": e["t"], "plan": e["plan"].to_dict()}
        for e in session.cohort_log()
    ]


def _parity_run(db, tdb, qs, **cfg):
    s_ref = graftdb.connect(
        db, graftdb.EngineConfig(backend="pallas", capture_explain=True, **cfg)
    )
    f_ref = s_ref.submit_all(_same_qids(_rebuild(db, qs, ref_queries)))
    s_ref.run()
    s_port = _connect(tdb, capture_explain=True, **cfg)
    f_port = s_port.submit_all(_same_qids(_rebuild(tdb, qs)))
    s_port.run()
    for a, b in zip(f_ref, f_port):
        assert b.status == a.status
        ra, rb = a.result(), b.result()
        assert set(ra) == set(rb)
        for k in ra:
            np.testing.assert_array_equal(rb[k], ra[k], err_msg=f"q{a.qid}/{k}")
        want = refexec.execute(tdb, b.query.plan)
        for k in rb:
            np.testing.assert_allclose(
                np.asarray(rb[k], np.float64), np.asarray(want[k], np.float64), rtol=1e-9
            )
        assert b.stats() == a.stats()
        assert b.explain().render() == a.explain().render()
    assert dict(s_port.counters) == dict(s_ref.counters)
    assert s_port._runner.admission_log == s_ref._runner.admission_log
    assert _cohorts(s_port) == _cohorts(s_ref)
    assert s_port.now == s_ref.now
    assert s_port.backend.stats() == s_ref.backend.stats()
    return s_ref, s_port


@pytest.mark.parametrize(
    "template,cfg",
    [
        ("q3", dict(workers=1, partitions=1)),
        ("q3", dict(workers=4, partitions=4)),
        ("q3", dict(ADMIT, workers=1, partitions=1, batch_window=0.003)),
        ("q5", dict(workers=1, partitions=1, morsel_size=2048)),
    ],
    ids=["w1", "w4", "adaptive-window", "q5-w1"],
)
def test_burst_trace_matches_reference(db, tdb, template, cfg):
    """A burst trace, planned, through both packages. In q5 cohorts the
    members' shifted windows of one width see different rows of one orders
    state, so their probes leave the fused chain for the multi-member lens
    probe."""
    cfg = dict(dict(mode="graft", morsel_size=4096), **cfg)
    trace = burst_trace(tdb, 3, 4, template=template)
    s_ref, s_port = _parity_run(db, tdb, trace, batch_planning=True, **cfg)
    assert s_port.counters["batch_cohorts"] > 0
    assert s_port.counters["batch_coverage_gain_rows"] > 0
    assert s_port.counters["kernel_chain_launches"] > 0
    if template == "q5":
        assert s_port.counters["kernel_multi_lens_probes"] > 0
    assert all(
        "cohort" in s_port._runner.admission_log[qid]
        for e in s_port.cohort_log() for qid in e["plan"].order
    )
    s_ref.close(), s_port.close()


def test_burst_trace_planned_matches_greedy_results(db, tdb):
    """Both legs of the sweep on the port: the planned leg's results equal
    the greedy leg's; its narrow members attach to the widest member's
    build instead of each installing a residual producer, so it builds
    fewer residual rows and finishes earlier on the virtual clock."""
    trace = burst_trace(tdb, 2, 4)
    sg, fg = _run_trace(tdb, _rebuild(tdb, trace), mode="graft", morsel_size=4096)
    sb, fb = _run_trace(
        tdb, _rebuild(tdb, trace), mode="graft", morsel_size=4096, batch_planning=True
    )
    for a, b in zip(fg, fb):
        ca, cb = _canon(a.result()), _canon(b.result())
        for k in ca:
            np.testing.assert_allclose(cb[k], ca[k], rtol=1e-12, atol=1e-12)
    assert sb.counters["batch_cohorts"] == 2
    assert sb.counters["batch_planned_queries"] == 8
    assert sg.counters["batch_cohorts"] == 0
    assert sb.counters["residual_build_rows"] < sg.counters["residual_build_rows"]
    assert sb.now < sg.now
    sg.close(), sb.close()


def test_explain_cohort_matches_reference(db, tdb):
    """EXPLAIN GRAFT COHORT against a warm snapshot: the plan and every
    member's report equal the reference's, as dicts and as renders."""
    warm = [_q3(tdb, "1995-03-28")]
    s_ref, s_port = _parity_run(db, tdb, warm, mode="graft", morsel_size=4096,
                                retention="epoch")
    for seed in (5, 6):
        rng = np.random.default_rng(seed)
        qs = [queries.sample_query(tdb, rng, arrival=s_port.now) for _ in range(3)]
        qs += [_q3(tdb, d, arrival=s_port.now) for d in ("1995-03-05", "1995-04-25")]
        qp = _same_qids(_rebuild(tdb, qs))
        qr = _same_qids(_rebuild(db, qs, ref_queries))
        ep, er = s_port.explain_cohort(qp), s_ref.explain_cohort(qr)
        assert ep.to_dict() == er.to_dict()
        assert ep.render() == er.render()
    s_ref.close(), s_port.close()


@pytest.mark.parametrize(
    "kw",
    [
        dict(batch_planning="yes"),
        dict(batch_planning=1),
        dict(batch_window=-0.5),
        dict(batch_window=True),
        dict(batch_window="0.1"),
    ],
)
def test_config_rejects_bad_batch_values(kw):
    """The port validates the batch knobs as the reference does."""
    with pytest.raises(ValueError):
        graftdb.EngineConfig(**kw)
    with pytest.raises(ValueError):
        EngineConfig(device="cpu", **kw)
