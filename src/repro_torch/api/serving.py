"""ServingSession: KV-prefix folding on the same Session/future surface.

The LM-serving adaptation (``serve/folding.py``) used to expose its own
incompatible scheduler API for the same folding mechanism. This module puts
it behind the unified facade: ``graftdb_torch.connect_serving(...)`` returns a
``ServingSession`` whose ``submit`` / ``run`` / ``RequestFuture`` mirror the
relational ``Session``, and whose ``explain_fold`` surfaces the admission
partition (represented / residual / ordinary tokens — DESIGN.md §6) exactly
like ``Session.explain_graft`` does for relational queries.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from ..serve.folding import FoldingScheduler, PrefixState, Request, SimExecutor
from .config import ServingConfig
from .futures import RequestFuture


class ServingSession:
    """One shared serving execution over one executor.

    ``submit()`` registers requests; ``run()`` executes one event-loop
    episode over everything submitted since the last run (admission — and
    therefore folding against live prefix states — happens inside the
    episode, in arrival order). Futures resolve after the episode that
    contains their request.
    """

    def __init__(self, executor=None, config: Optional[ServingConfig] = None):
        self.config = config or ServingConfig()
        self.executor = executor or SimExecutor(
            prefill_tok_s=self.config.prefill_tok_s,
            decode_step_s=self.config.decode_step_s,
        )
        self._sched = FoldingScheduler(
            self.executor,
            fold=self.config.fold,
            min_share=self.config.min_share,
            retain_prefixes=self.config.retain_prefixes,
            memory_budget_tokens=self.config.memory_budget_tokens,
            reuse_cache_tokens=self.config.reuse_cache_tokens,
            batch_fold=self.config.batch_fold,
        )
        self._sched.on_admit = self._capture_admit
        self._futures: Dict[int, RequestFuture] = {}
        self._explains: Dict[int, Dict[str, int]] = {}
        self._pending: List[Request] = []
        self._episodes: List[Dict] = []

    # -- admission -----------------------------------------------------------
    def submit(self, request: Request) -> RequestFuture:
        if request.rid in self._futures:
            raise ValueError(f"duplicate request id r{request.rid}")
        fut = RequestFuture(self, request)
        self._futures[request.rid] = fut
        self._pending.append(request)
        return fut

    def submit_all(self, requests: Iterable[Request]) -> List[RequestFuture]:
        return [self.submit(r) for r in requests]

    def _capture_admit(self, req: Request, att: Dict) -> None:
        st: PrefixState = att["state"]
        created = bool(att.get("created"))
        self._explains[req.rid] = {
            "state_sid": st.sid,
            "created_state": created,
            # a fresh state matched nothing pre-existing — keep this
            # consistent with explain_fold()'s pre-flight view
            "matched_tokens": 0 if created else att["matched"],
            "represented_tokens": att["represented"],
            "residual_tokens": att["residual"],
            "ordinary_tokens": len(req.prompt) - att["represented"] - att["residual"],
        }

    # -- execution -----------------------------------------------------------
    def run(self) -> Dict:
        """Execute one episode over all pending requests; returns its
        summary (completed / elapsed / latency / prefill-token metrics).
        Token metrics in the summary are per-episode deltas; cumulative
        totals stay available via ``session.metrics``."""
        batch, self._pending = self._pending, []
        before = dict(self._sched.metrics)
        summary = self._sched.run(batch)  # empty batch: zeroed summary
        summary["prefill_tokens"] = {
            k: v - before.get(k, 0) for k, v in self._sched.metrics.items()
        }
        if batch:
            self._episodes.append(summary)
        return summary

    drain = run

    # -- EXPLAIN (fold) ------------------------------------------------------
    def explain_fold(self, request: Request) -> Dict[str, int]:
        """Pre-flight: how this request's prompt would partition against the
        *current* live prefix states. Read-only; does not admit. Delegates
        to the scheduler's own admission preview, so it can never drift
        from what admit() would decide."""
        att = self._sched.preview(request.prompt)
        return {
            "state_sid": att["state"].sid if att["state"] is not None else None,
            "created_state": att["created"],
            "matched_tokens": att["matched"],
            "represented_tokens": att["represented"],
            "residual_tokens": att["residual"],
            "ordinary_tokens": att["suffix"],
            # reuse plane (§12): a spilled prefix artifact would rehydrate
            # and serve the matched prefix
            "served_from_cache": bool(att.get("served_from_cache")),
        }

    # -- introspection -------------------------------------------------------
    @property
    def metrics(self) -> Dict[str, int]:
        return self._sched.metrics

    @property
    def live_states(self) -> int:
        return len(self._sched.states)

    @property
    def scheduler(self) -> FoldingScheduler:
        """The underlying scheduler — internal surface for mechanism tests."""
        return self._sched

    def stats(self) -> Dict[str, object]:
        return {
            "fold": self.config.fold,
            "episodes": len(self._episodes),
            "live_states": self.live_states,
            "completed": sum(e["completed"] for e in self._episodes),
            "prefill_tokens": dict(self._sched.metrics),
            # prefix-state lifecycle (§10): retention/eviction gauges
            "retain_prefixes": self.config.retain_prefixes,
            "lifecycle": dict(self._sched.lifecycle_metrics),
        }

    def __repr__(self) -> str:
        return (
            f"<ServingSession fold={self.config.fold} live_states={self.live_states} "
            f"pending={len(self._pending)}>"
        )


def connect_serving(
    executor=None, config: Optional[ServingConfig] = None, **kw
) -> ServingSession:
    """Open a serving session: ``graftdb_torch.connect_serving(fold=True)``."""
    if config is not None and kw:
        raise TypeError("pass either a config object or field kwargs, not both")
    if config is None:
        config = ServingConfig(**kw)
    return ServingSession(executor, config)
