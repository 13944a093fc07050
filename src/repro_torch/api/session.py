"""Session: the one supported entry point to a GraftDB engine.

``graftdb_torch.connect(db, config=EngineConfig(...))`` assembles the engine,
executor, clock, and data-plane backend behind a single facade. Queries are
submitted through the session and observed through ``QueryFuture`` handles;
the grafting decision is surfaced as structured data via
``Session.explain_graft`` (EXPLAIN GRAFT) instead of being buried in engine
internals. ``core/`` remains importable but is internal — call sites should
never hand-assemble ``GraftEngine`` + ``Runner`` pairs.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional

from ..core import trace as _trace
from ..core.engine import GraftEngine
from ..core.plans import Query
from ..core.scheduler import Runner
from ..core.trace import Trace
from ..relational.table import Database
from .config import EngineConfig
from .explain import GraftExplain, analyze_query
from .futures import QueryFuture


class Session:
    """One shared multi-query execution over one database.

    Lifecycle: ``submit()`` admits queries (grafting happens at admission —
    a query whose arrival time is in the future is queued and admitted when
    the clock reaches it), ``run()`` drives the shared executor until all
    admitted and queued work completes, futures expose per-query results.
    """

    def __init__(self, db: Database, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig()
        self.db = db
        self.backend = self.config.make_backend()
        # Mesh execution (DESIGN.md §14): resolve the config's mesh spec to
        # a data mesh (its shards on the backend's device) + replicated
        # MeshPlan; config validation already pinned partitions = workers =
        # data-axis size.
        device = getattr(self.backend, "device", None)
        self.mesh = self.config.make_mesh(None if device is None else str(device))
        self._mesh_plan = None
        if self.mesh is not None:
            from ..core.meshexec import MeshPlan

            self._mesh_plan = MeshPlan(self.mesh)
        self._engine = GraftEngine(
            db,
            mode=self.config.mode,
            morsel_size=self.config.morsel_size,
            cost_model=self.config.cost_model,
            zone_maps=self.config.zone_maps,
            backend=self.backend,
            partitions=self.config.n_partitions,
            retention=self.config.retention,
            memory_budget=self.config.memory_budget,
            member_major=self.config.member_major,
            reuse_cache_budget=self.config.reuse_cache_budget,
            reuse_disk_budget=self.config.reuse_disk_budget,
            faults=self.config.faults,
            mesh_plan=self._mesh_plan,
        )
        if self._mesh_plan is not None and hasattr(self.backend, "probe_chain"):
            # single-shard data mesh: the fused stage chain launches
            # shard-locally on the session mesh (§14); multi-shard routing
            # goes through the bucketed exchange instead
            self.backend.mesh = self.mesh if self._mesh_plan.n_shards == 1 else None
        admission = self.config.make_admission()
        batch_kw = dict(
            batch_planning=self.config.batch_planning,
            batch_window=self.config.batch_window,
        )
        if self.config.workers == 1:
            self._runner = Runner(
                self._engine,
                clock=self.config.make_clock(),
                admission=admission,
                **batch_kw,
            )
        else:
            self._runner = Runner(
                self._engine,
                workers=self.config.workers,
                clock_factory=self.config.clock_factory(),
                admission=admission,
                **batch_kw,
            )
        if self.config.capture_explain:
            self._runner.submit_hook = self._capture_explain
        self._futures: Dict[int, QueryFuture] = {}
        self._explains: Dict[int, GraftExplain] = {}
        self._reported: set = set()  # qids already returned by run()
        self._closed = False

    # -- admission -----------------------------------------------------------
    def submit(self, query: Query, deadline: Optional[float] = None) -> QueryFuture:
        """Admit (or schedule) one query; returns its future.

        Queries with ``arrival <= now`` are grafted onto the shared
        execution immediately; later arrivals are admitted by ``run()``
        when the clock reaches them. ``deadline`` (virtual seconds, §16)
        cancels the query at the first morsel boundary at or past it —
        still-queued arrivals never admit, in-flight ones tear down with
        producer handoff; the future then reports status ``"deadline"``.
        """
        self._check_open()
        if query.qid in self._futures:
            raise ValueError(
                f"duplicate query id q{query.qid}: build a fresh Query per submission"
            )
        if deadline is not None:
            if isinstance(deadline, bool) or not isinstance(deadline, (int, float)) \
                    or not math.isfinite(deadline):
                raise ValueError(
                    f"deadline must be a finite number (virtual seconds) or "
                    f"None, got {deadline!r}"
                )
            self._runner.deadlines[query.qid] = float(deadline)
        fut = QueryFuture(self, query)
        self._futures[query.qid] = fut
        if self.config.batch_planning:
            # batch planning (§15): due submissions gather into the arrival
            # queue so run()'s next decision step can plan them as a cohort
            self._runner.add_arrival(query)
        elif query.arrival <= self.clock.now:
            # due now: still subject to the admission controller — a
            # deferred query is admitted by run() when load drops
            self._runner.submit_arrival(query)
        else:
            self._runner.add_arrival(query)
        return fut

    def submit_all(self, queries: Iterable[Query]) -> List[QueryFuture]:
        return [self.submit(q) for q in queries]

    def cancel(self, query) -> bool:
        """Cancel one query by future, qid, or Query (§16). Queued arrivals
        are removed before they ever admit; in-flight queries tear down at
        the current morsel boundary with producer handoff. False — a
        no-op — for unknown, completed, or already-cancelled queries, and
        always after ``close()``."""
        if self._closed:
            return False
        qid = getattr(query, "qid", query)
        return self._runner.cancel(int(qid))

    def _capture_explain(self, query: Query) -> None:
        self._explains[query.qid] = analyze_query(self._engine, query)

    # -- execution -----------------------------------------------------------
    def run(
        self,
        on_complete: Optional[Callable[[QueryFuture], Optional[Query]]] = None,
    ) -> List[QueryFuture]:
        """Drive the shared executor until all submitted work completes.

        Returns futures for the queries that completed during *this* call
        (a reused session does not re-report earlier rounds).

        ``on_complete(future) -> Optional[Query]`` implements closed-loop
        clients: a returned query is submitted with arrival = its own
        ``arrival`` field (typically the completion time).
        """
        self._check_open()
        cb = None
        if on_complete is not None:

            def cb(handle):
                fut = self._future_for_qid(handle.qid)
                tr = _trace.active
                if tr is None:
                    return on_complete(fut)
                span = tr.open("client.callback", handle.qid)
                try:
                    return on_complete(fut)
                finally:
                    tr.close(span)

        self._runner.run((), on_complete=cb, max_steps=self.config.max_steps)
        fresh = [h for h in self._engine.completed if h.qid not in self._reported]
        self._reported.update(h.qid for h in fresh)
        return [self._future_for_qid(h.qid) for h in fresh]

    drain = run  # alias: drain all outstanding work

    def _future_for_qid(self, qid: int) -> QueryFuture:
        fut = self._futures.get(qid)
        if fut is None:
            # closed-loop queries submitted by the engine callback path
            handle = self._engine.handles[qid]
            fut = QueryFuture(self, handle.query)
            self._futures[qid] = fut
        return fut

    # -- EXPLAIN GRAFT -------------------------------------------------------
    def explain_graft(self, query: Query) -> GraftExplain:
        """Pre-flight EXPLAIN GRAFT: how this query would attach to the
        engine's *current* shared state. Read-only; does not admit."""
        self._check_open()
        return analyze_query(self._engine, query)

    def explain_cohort(self, queries: Iterable[Query]) -> "CohortExplain":
        """Pre-flight EXPLAIN GRAFT COHORT (§15): how this set of queries
        would be jointly planned against the engine's *current* shared
        state. Read-only; does not admit."""
        self._check_open()
        from .explain import analyze_cohort

        return analyze_cohort(self._engine, list(queries))

    def cohort_log(self) -> List[Dict[str, object]]:
        """Cohorts admitted through the batch planner this session, in
        admission order: ``{"cohort": id, "t": time, "plan": CohortPlan}``."""
        return list(self._runner.cohort_log)

    # -- tracing ---------------------------------------------------------------
    def start_trace(self) -> None:
        """Start recording the program's host spans and host<->device copy
        counters (``repro_torch.core.trace``). One trace runs per process:
        a second start raises."""
        self._check_open()
        _trace.start()

    def stop_trace(self) -> Trace:
        """Stop the running trace and return its records, self seconds and
        calls by span name, and copy counters. Raises when none runs."""
        return _trace.stop()

    # -- introspection -------------------------------------------------------
    @property
    def clock(self):
        return self._runner.clock

    @property
    def now(self) -> float:
        return self.clock.now

    @property
    def mode(self) -> str:
        return self._engine.mode.name

    @property
    def counters(self) -> Dict[str, float]:
        return self._engine.counters

    @property
    def engine(self) -> GraftEngine:
        """The underlying engine — internal surface, exposed for mechanism
        tests and diagnostics only."""
        return self._engine

    def worker_stats(self) -> Dict[str, object]:
        """Per-worker utilization of the partition-parallel pool (§9)."""
        return self._runner.worker_stats()

    def stats(self) -> Dict[str, float]:
        out = self._engine.stats()
        out["now_s"] = self.now
        out["mode"] = self.mode
        out["backend"] = self.backend.name
        out["workers"] = self.config.workers
        out["partitions"] = self._engine.n_partitions
        # overload path (§10): admission queue + lifecycle gauges
        out["admission"] = self.config.admission
        out["queued_pending"] = len(self._runner._admit_queue)
        # batch planning (§15)
        out["batch_planning"] = self.config.batch_planning
        out["batch_window"] = self.config.batch_window
        out["memory_budget"] = self.config.memory_budget
        out["reuse_cache_budget"] = self.config.reuse_cache_budget
        backend_stats = getattr(self.backend, "stats", None)
        if backend_stats is not None:
            for k, v in backend_stats().items():
                out[f"backend_{k}"] = v
        return out

    # -- lifecycle -----------------------------------------------------------
    def mesh_stats(self) -> Dict[str, object]:
        """Per-device view of the mesh execution (§14): data-shard count,
        exchange accounting, the first-stage routing histogram, and every
        live state's device layout + per-device extent frontiers. Empty
        dict on mesh-less sessions."""
        if self._mesh_plan is None:
            return {}
        out = self._mesh_plan.stats()
        out["mesh_exchange_rows"] = self._engine.counters["mesh_exchange_rows"]
        out["bucket_overflow_rows"] = self._engine.counters["bucket_overflow_rows"]
        live = [
            st
            for states in self._engine.state_index.values()
            for st in states
        ]
        retired = [
            st
            for st in self._engine.lifecycle.retired.values()
            if hasattr(st, "device_layout")
        ]
        out["states"] = [st.device_layout() for st in live + retired]
        return out

    def validate_mesh_plane(self, sample_rows: int = 4096) -> Dict[str, object]:
        """Run one real bucketed exchange on the session mesh's devices
        and check it against the replicated control plane's routing: every
        row must land on the device that owns its key shard, with zero rows
        lost (overflow is recovered by regrowing, and counted). Uses the
        live states' keycodes when present, a synthetic sample otherwise.
        Folds any recovered overflow into ``bucket_overflow_rows``."""
        self._check_open()
        if self._mesh_plan is None:
            raise RuntimeError("validate_mesh_plane requires a mesh session")
        import numpy as np

        from ..relational.distributed import KEY_LIMIT, exchange_by_key

        keys = []
        for states in self._engine.state_index.values():
            for st in states:
                kc = st.keycode.data
                if len(kc) and abs(int(np.abs(kc).max())) <= KEY_LIMIT:
                    keys.append(np.asarray(kc, np.int64))
        if keys:
            keys = np.concatenate(keys)[:sample_rows]
        else:
            # deterministic synthetic sample (no engine keys in int32 range)
            keys = (np.arange(sample_rows, dtype=np.int64) * 2654435761) % KEY_LIMIT
        dest = self._mesh_plan.route(keys)
        vals = keys.astype(np.float32)[:, None]
        rec = exchange_by_key(self.mesh, keys, vals, dest=dest)
        P = self._mesh_plan.n_shards
        cap = rec["capacity"]
        got_k = rec["keys"].cpu().numpy().reshape(P, P * cap)
        got_ok = rec["valid"].cpu().numpy().reshape(P, P * cap)
        routed_ok = True
        placed = 0
        for p in range(P):
            shard_keys = got_k[p][got_ok[p]]
            placed += len(shard_keys)
            want = np.sort(keys[dest == p])
            if not np.array_equal(np.sort(shard_keys), want):
                routed_ok = False
        self._engine.counters["bucket_overflow_rows"] += rec["bucket_overflow_rows"]
        return {
            "rows": int(len(keys)),
            "rows_placed": int(placed),
            "routing_matches_state_shards": routed_ok,
            "rows_lost": int(len(keys) - placed),
            "bucket_overflow_rows": int(rec["bucket_overflow_rows"]),
            "capacity": int(cap),
            "attempts": int(rec["attempts"]),
            "data_shards": P,
        }

    def close(self) -> None:
        """Release everything the session retains, deterministically.

        Idempotent. Drops external (queued-admission) pins, flushes the
        artifact store — no further spills, disk tier deleted — and, under
        epoch retention, force-evicts every retired state so retained
        bytes drop to zero. Benchmarks sweeping many sessions no longer
        leak engines across sweep points; ``with connect(...) as s:``
        scopes the release."""
        if self._closed:
            return
        self._closed = True
        runner = self._runner
        eng = self._engine
        # queued arrivals resolve as cancelled — they never got a handle
        for entry in list(runner._heap) + list(runner._admit_queue):
            runner.cancelled_qids[entry[1]] = "cancelled"
            eng.counters["cancelled"] += 1
        runner._heap.clear()
        runner.deadlines.clear()
        # external pins first: a pinned state is never evictable
        for qid in list(runner._queued_pins):
            runner._unpin_candidates(qid)
        runner._admit_queue.clear()
        # in-flight queries cancel jointly: the whole active set is doomed
        # at once, so teardown never hands a producer to a dying peer
        active = [h for h in list(eng.active_handles) if h.status == "active"]
        doomed = {h.qid for h in active}
        for h in active:
            eng.cancel_query(h, doomed=doomed)
        if eng.reuse is not None:
            # flush BEFORE the final eviction pass so the force-evicted
            # states are destroyed, not respilled into a store we just
            # emptied
            eng.reuse.close()
        if eng.retention == "epoch":
            eng.enforce_memory_budget(0)

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("session is closed")

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (
            f"<Session mode={self.mode} backend={self.backend.name} "
            f"now={self.now:.4f}s active={len(self._engine.active_handles)}>"
        )


def connect(db: Database, config: Optional[EngineConfig] = None, **kw) -> Session:
    """Open a GraftDB session: ``graftdb_torch.connect(db, EngineConfig(mode="graft"))``.

    Keyword arguments are accepted as EngineConfig field shortcuts when no
    config object is given: ``graftdb_torch.connect(db, mode="isolated")``.
    """
    if config is not None and kw:
        raise TypeError("pass either a config object or field kwargs, not both")
    if config is None:
        config = EngineConfig(**kw)
    return Session(db, config)
