"""QueryFuture: the handle a Session returns for every submitted query.

Replaces raw ``QueryHandle`` polling: consumers ask the future for the
result (driving the session's executor if needed) instead of running the
scheduler themselves and digging completed handles out of engine lists.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.plans import Query


class QueryCancelled(RuntimeError):
    """Raised by ``QueryFuture.result()`` when the query was cancelled —
    explicitly, by a deadline, or by fault escalation (§16). The ``status``
    attribute carries the terminal reason (``"cancelled"`` / ``"deadline"``
    / ``"failed"``)."""

    def __init__(self, message: str, status: str):
        super().__init__(message)
        self.status = status


class QueryFuture:
    """Completion handle for one submitted query.

    * ``result()``  — the query's output columns; drives the session until
      this query completes (or raises ``QueryCancelled`` for a query that
      terminated without one — §16).
    * ``cancel()``  — cancel the query (§16); ``status`` / ``cancelled``
      report the lifecycle outcome.
    * ``latency()`` — arrival -> completion seconds (session clock).
    * ``stats()``   — per-query execution stats (members, rows sunk, states).
    * ``explain()`` — the EXPLAIN GRAFT report captured at admission
      (requires ``EngineConfig(capture_explain=True)``).
    """

    def __init__(self, session, query: Query):
        self._session = session
        self.query = query
        self.qid = query.qid

    # -- state ----------------------------------------------------------------
    @property
    def _handle(self):
        return self._session._engine.handles.get(self.qid)

    @property
    def done(self) -> bool:
        h = self._handle
        return bool(h is not None and h.done)

    @property
    def status(self) -> str:
        """Lifecycle status: ``"queued"`` (not yet admitted), ``"active"``,
        ``"done"``, or a terminal §16 reason — ``"cancelled"`` /
        ``"deadline"`` / ``"failed"``."""
        reason = self._session._runner.cancelled_qids.get(self.qid)
        if reason is not None:
            return reason  # cancelled before admission: no handle exists
        h = self._handle
        if h is None:
            return "queued"
        if h.done:
            return "done"
        return h.status

    @property
    def cancelled(self) -> bool:
        return self.status in ("cancelled", "deadline", "failed")

    def cancel(self) -> bool:
        """Cancel this query at the current morsel boundary (§16). False —
        a no-op — once it completed or already cancelled, and always on a
        closed session."""
        return self._session.cancel(self.qid)

    # -- results --------------------------------------------------------------
    def result(self, wait: bool = True) -> Dict[str, np.ndarray]:
        if self.cancelled:
            raise QueryCancelled(
                f"query q{self.qid} was cancelled ({self.status})", self.status
            )
        if not self.done and wait:
            self._session.run()
        if self.cancelled:
            raise QueryCancelled(
                f"query q{self.qid} was cancelled ({self.status})", self.status
            )
        h = self._handle
        if h is None or not h.done:
            raise RuntimeError(
                f"query q{self.qid} has not completed"
                + ("" if wait else " (wait=False)")
            )
        return h.result

    def latency(self) -> float:
        h = self._handle
        if h is None or not h.done:
            raise RuntimeError(f"query q{self.qid} has not completed")
        return h.t_complete - self.query.arrival

    def stats(self) -> Dict[str, object]:
        h = self._handle
        if h is None:
            return {
                "qid": self.qid,
                "template": self.query.template,
                "submitted": False,
                "status": self.status,
            }
        kinds: Dict[str, int] = {}
        rows_sunk = 0
        for m in h.members:
            kinds[m.kind] = kinds.get(m.kind, 0) + 1
            rows_sunk += m.rows_sunk
        eng_counters = self._session._engine.counters
        admission = self._session._runner.admission_log.get(self.qid)
        return {
            "qid": self.qid,
            "template": self.query.template,
            "submitted": True,
            "done": h.done,
            # per-query lifecycle + degradation (§16)
            "status": self.status,
            "degraded": bool(h.degraded),
            "faults": {
                "faults_injected": int(eng_counters.get("faults_injected", 0)),
                "retries": int(eng_counters.get("fault_retries", 0)),
                "producer_handoffs": int(eng_counters.get("producer_handoffs", 0)),
                "quarantined_states": int(eng_counters.get("quarantined_states", 0)),
                "unfolds": int(eng_counters.get("unfolds", 0)),
                "cancelled": int(eng_counters.get("cancelled", 0)),
                "deadline_cancellations": int(
                    eng_counters.get("deadline_cancellations", 0)
                ),
            },
            "t_submit": h.t_submit,
            "t_complete": h.t_complete,
            "latency_s": (h.t_complete - self.query.arrival) if h.done else None,
            "members": kinds,
            "rows_sunk": rows_sunk,
            "attached_state_ids": [s.state_id for s in h.attached_states],
            # reuse plane (§12): boundaries of THIS query served by
            # rehydrating a cached artifact
            "served_from_cache": bool(h.cache_hits),
            "cache_hits": h.cache_hits,
            # shared-data-plane perf counters (engine-wide: one shared
            # execution serves every query, so the work is not per-query
            # attributable — DESIGN.md §8/§9)
            "counters": {
                k: int(eng_counters.get(k, 0))
                for k in (
                    "index_rebuilds",
                    "kernel_lens_probes",
                    "fused_filter_rows",
                    # member-major fused data plane (§11)
                    "kernel_multi_lens_probes",
                    "fused_vis_rows",
                    "fused_stage_filter_rows",
                    "fused_sink_rows",
                    # device-resident fused chain (§13), with per-reason
                    # kernel-decline attribution
                    "kernel_chain_launches",
                    "fallback_probes_grants",
                    "fallback_probes_slot_limit",
                    "fallback_probes_keyrange",
                    "fallback_probes_capacity",
                    "fallback_probes_predicate",
                    "agg_cohort_rows",
                    # the cohort fold (§11): first contacts served by appending
                    # or by the member index, and the buckets it reduced
                    "agg_fold_appended_groups",
                    "agg_fold_looked_up_groups",
                    "agg_fold_buckets",
                    "overflow_members",
                    "partition_merges",
                    "partition_probe_merges",
                    # lifecycle + admission (engine-wide, §10)
                    "evictions",
                    "evicted_bytes",
                    "state_revivals",
                    "queued_admissions",
                    "forced_admissions",
                    "admission_evals",
                    # batch planning (engine-wide, §15)
                    "batch_cohorts",
                    "batch_planned_queries",
                    "batch_coverage_gain_rows",
                    # reuse plane (engine-wide, §12)
                    "cache_hits",
                    "cache_spills",
                    "cache_evictions",
                    "rehydrate_bytes",
                    "cache_corrupt",
                )
            },
            # per-query admission record (§10): decision ('graft'/'fresh'/
            # 'forced'), whether it queued, and the queue delay. None when
            # the session runs without an admission controller.
            "admission": admission,
            "queue_delay_s": (admission or {}).get("queue_delay_s", 0.0),
            # partition-parallel pool utilization (engine-wide, §9)
            "workers": self._session.worker_stats(),
        }

    def explain(self):
        """EXPLAIN GRAFT captured at this query's admission. A query that
        unfolded after a fault (§16) reports ``degraded=True`` on top of
        its admission-time plan."""
        exp = self._session._explains.get(self.qid)
        if exp is None:
            raise RuntimeError(
                "no explain captured for this query — connect with "
                "EngineConfig(capture_explain=True), or use "
                "Session.explain_graft(query) pre-flight"
            )
        h = self._handle
        if h is not None and h.degraded and not exp.degraded:
            import dataclasses

            exp = dataclasses.replace(exp, degraded=True)
        return exp

    def __repr__(self) -> str:
        state = "done" if self.done else "pending"
        return f"<QueryFuture q{self.qid} [{self.query.template}] {state}>"


class RequestFuture:
    """Completion handle for one serving request (KV-prefix folding).

    The serving analogue of QueryFuture on the shared Session surface:
    ``result()`` drives the serving session's event loop if needed and
    returns the request's timing/extent record.
    """

    def __init__(self, session, request):
        self._session = session
        self.request = request
        self.rid = request.rid

    @property
    def done(self) -> bool:
        return self.request.t_complete is not None

    def result(self, wait: bool = True) -> Dict[str, float]:
        if not self.done and wait:
            self._session.run()
        if not self.done:
            raise RuntimeError(f"request r{self.rid} has not completed")
        r = self.request
        return {
            "rid": r.rid,
            "t_first_token": r.t_first_token,
            "t_complete": r.t_complete,
            "latency_s": r.t_complete - r.arrival,
            "represented_tokens": r.represented_tokens,
            "residual_tokens": r.residual_tokens,
            "ordinary_tokens": r.ordinary_tokens,
        }

    def latency(self) -> float:
        if not self.done:
            raise RuntimeError(f"request r{self.rid} has not completed")
        return self.request.t_complete - self.request.arrival

    def explain(self) -> Dict[str, int]:
        """Extent partition of this request's prompt, captured at admission."""
        exp = self._session._explains.get(self.rid)
        if exp is None:
            raise RuntimeError(f"request r{self.rid} has not been admitted yet")
        return exp

    def __repr__(self) -> str:
        state = "done" if self.done else "pending"
        return f"<RequestFuture r{self.rid} {state}>"
