"""The aggregate cohort fold (``Pipeline._agg_fold_cohort``) against the
per-member oracle (``EngineConfig(member_major=False)``), on the CPU.

Each session case runs one workload twice, fused and oracle, and holds the
fused run's results and every aggregate's accumulator layout
(``group_cols``, ``_counts`` and ``_acc`` of each partition) bit-identical
to the oracle's, and the clocks equal. The cases cover each way a member's
groups reach its accumulators: appended by the cohort (its map covers
every group it holds), looked up in its own index (it met groups outside
the cohort first), flushed by a later row-level ``update``, and cohorts
that probe states revived under epoch retention. Sizes: TPC-H SF 0.01,
2,048-row morsels.
"""

import dataclasses

import numpy as np
import pytest
import torch

import graftdb_torch
from repro_torch.core import runtime
from repro_torch.core.plans import AggSpec
from repro_torch.core.state import SharedAggregateState
from repro_torch.relational import queries, tpch

torch.set_num_threads(2)

TEMPLATES = ("q3", "q10", "q1")


@pytest.fixture(scope="module")
def db():
    return tpch.get_database(0.01, seed=7)


def _mix(db, n, seed, gap=0.0, templates=TEMPLATES):
    """``n`` queries, the templates in turn two by two, ``gap`` s apart."""
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(n):
        t = templates[i // 2 % len(templates)]
        qs.append(queries.make_query(db, t, queries._sample_params(t, rng), arrival=gap * i))
    return qs


def _run(db, qs, member_major, **cfg):
    cfg = dict(dict(mode="graft", morsel_size=2048, backend="torch", device="cpu",
                    workers=1), **cfg)
    s = graftdb_torch.connect(db, graftdb_torch.EngineConfig(member_major=member_major, **cfg))
    fs = s.submit_all([dataclasses.replace(q, qid=20_000 + i) for i, q in enumerate(qs)])
    s.run()
    return s, fs


def _assert_same_as_oracle(db, qs, **cfg):
    """Fused and oracle runs of ``qs``: same results, same accumulator
    layouts, same clock. Returns the fused session."""
    sf, ff = _run(db, qs, True, **cfg)
    so, fo = _run(db, qs, False, **cfg)
    for a, b in zip(fo, ff):
        ra, rb = a.result(), b.result()
        assert set(ra) == set(rb)
        for k in ra:
            np.testing.assert_array_equal(rb[k], ra[k], err_msg=f"q{a.qid}/{k}")
        sa = so.engine.handles[a.query.qid].agg_state
        sb = sf.engine.handles[b.query.qid].agg_state
        assert len(sa._parts) == len(sb._parts)
        for pa, pb in zip(sa._parts, sb._parts):
            for x, y in zip(pa.group_cols, pb.group_cols):
                np.testing.assert_array_equal(y.data, x.data)
            np.testing.assert_array_equal(pb._counts.data, pa._counts.data)
            for x, y in zip(pa._acc, pb._acc):
                np.testing.assert_array_equal(y.data, x.data)
    assert sf.now == so.now
    return sf


@pytest.mark.parametrize("members,partitions", [(2, 1), (6, 1), (12, 1), (6, 2), (12, 2)])
def test_mix_matches_oracle(db, members, partitions):
    """q3, q10 and q1 sent together: multi-member cohorts of each shape,
    the large-group ones compacted, q1's dense."""
    s = _assert_same_as_oracle(db, _mix(db, members, seed=members), partitions=partitions)
    c = s.counters
    assert c["agg_fold_appended_groups"] > 0
    assert c["agg_cohort_rows"] > 0


def _log_group_entries(monkeypatch):
    """Record (method, state id, groups) for each way groups enter a state."""
    log = []
    for name in ("map_groups", "append_groups", "update"):
        orig = getattr(SharedAggregateState, name)

        def wrapped(self, key_cols, *a, _orig=orig, _name=name, **kw):
            log.append((_name, self.state_id, len(key_cols[0]) if key_cols else 0))
            return _orig(self, key_cols, *a, **kw)

        monkeypatch.setattr(SharedAggregateState, name, wrapped)
    return log


@pytest.mark.parametrize("template", ["q3", "q10"])
def test_member_that_met_groups_outside_a_cohort_looks_them_up(db, template, monkeypatch):
    """The first query folds alone (a singleton cohort: row-level
    ``update``) until a second one of its template joins its pipeline;
    from then on its unseen groups go through ``map_groups``, while the
    newcomer, whose map covers its empty accumulators, appends."""
    qs = _mix(db, 2, seed=12, gap=0.004, templates=(template,))
    _assert_same_as_oracle(db, qs)
    log = _log_group_entries(monkeypatch)
    s, fs = _run(db, qs, True)
    first, second = (s.engine.handles[f.query.qid].agg_state.state_id for f in fs)
    mine = [e[0] for e in log if e[1] == first]
    assert mine[0] == "update" and "map_groups" in mine and "append_groups" not in mine
    assert mine.index("map_groups") > 0
    theirs = [e[0] for e in log if e[1] == second]
    assert theirs[0] == "append_groups" and "map_groups" not in theirs
    assert s.counters["agg_fold_looked_up_groups"] > 0
    assert s.counters["agg_fold_appended_groups"] > 0


@pytest.mark.parametrize("dtypes", [("int64",), ("float64",), ("int32", "float64")])
@pytest.mark.parametrize("part", [0, 1])
def test_update_after_appends_flushes_the_same_ids(dtypes, part):
    """Groups appended in batches, then a row-level ``update`` that meets
    some of them again and new ones: the deferred inserts enter the index
    first, batch by batch, under the ids the appends gave, exactly as
    ``map_groups`` would have assigned them (layout, index ids and the
    index's doublings alike)."""
    rng = np.random.default_rng(5)
    spec = (AggSpec("sum", None, name="s"), AggSpec("count", None, name="c"))
    keys = ("a", "b")[: len(dtypes)]
    universe = [rng.permutation(400).astype(d) * (1 if d.startswith("int") else 0.5)
                for d in dtypes]
    batches = [[u[lo:hi] for u in universe] for lo, hi in ((0, 50), (50, 130), (130, 300))]
    rows = rng.integers(0, 400, 700)
    upd = [u[rows] for u in universe]
    vals = [rng.random(700), None]
    out = []
    for via in ("append_groups", "map_groups"):
        counters = {"index_rebuilds": 0}
        st = SharedAggregateState(1, None, keys, spec, counters=counters, n_partitions=2)
        got = [getattr(st, via)(b, part=part) for b in batches]
        st.update(upd, vals, len(rows), part=part)
        p = st._parts[part]
        assert not p._pending
        out.append((got, p, counters["index_rebuilds"], p._gidx.lookup_or_insert(universe)[0]))
    (ga, pa, ra, ia), (gm, pm, rm, im) = out
    for x, y in zip(ga, gm):
        np.testing.assert_array_equal(x, y)
    assert pa.n_groups == pm.n_groups > 300
    for x, y in zip(pa.group_cols + pa._acc + [pa._counts], pm.group_cols + pm._acc + [pm._counts]):
        np.testing.assert_array_equal(x.data, y.data)
    np.testing.assert_array_equal(ia, im)
    assert ra == rm > 0


@pytest.mark.parametrize("partitions", [1, 2])
def test_cohort_over_revived_states_matches_oracle(db, partitions):
    """Epoch retention: a second wave, sent after the first completed,
    revives the first wave's retired states and folds in fresh cohorts
    over them."""
    first = _mix(db, 6, seed=21, templates=("q3", "q10"))
    later = [dataclasses.replace(q, arrival=q.arrival + 5.0)
             for q in _mix(db, 6, seed=22, templates=("q3", "q10"))]
    s = _assert_same_as_oracle(db, first + later, retention="epoch", partitions=partitions)
    assert s.counters["state_revivals"] > 0
    assert s.counters["agg_fold_appended_groups"] > 0


@pytest.mark.parametrize("members", [1, 6])
def test_fold_counters(db, members, monkeypatch):
    """One member folds nothing as a cohort: all three counters read 0.
    Several: appends serve first contacts, and a compacted fold reduces at
    most k buckets a (row, member) pair, fewer than the dense gids × k."""
    calls = []
    orig = runtime.Pipeline._agg_fold_cohort

    def watched(self, engine, ck, ms, *a, **kw):
        c = engine.counters
        before = (c["agg_cohort_rows"], c["agg_fold_buckets"])
        orig(self, engine, ck, ms, *a, **kw)
        ci = self._cohort_state.get(ck)
        ng = 1 if ci is None or ci._idx is None else ci._idx.n
        calls.append((len(ms), ng, c["agg_cohort_rows"] - before[0],
                      c["agg_fold_buckets"] - before[1]))

    monkeypatch.setattr(runtime.Pipeline, "_agg_fold_cohort", watched)
    qs = _mix(db, members, seed=31) if members > 1 else _mix(db, 3, seed=31, gap=30.0)
    s, _ = _run(db, qs, True)
    c = s.counters
    if members == 1:
        assert not calls
        for k in ("agg_fold_appended_groups", "agg_fold_looked_up_groups", "agg_fold_buckets"):
            assert c[k] == 0
        return
    assert c["agg_fold_appended_groups"] > 0
    assert c["agg_fold_buckets"] <= members * c["agg_cohort_rows"]
    compacted = [x for x in calls if x[1] * x[0] > x[2] > 0]
    dense = [x for x in calls if 0 < x[1] * x[0] <= x[2]]
    assert compacted and dense
    for k, ng, pairs, buckets in compacted:
        assert buckets <= k * pairs and buckets < ng * k
    for k, ng, pairs, buckets in dense:
        assert buckets == ng * k
