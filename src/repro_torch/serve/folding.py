"""Dynamic folding for LM serving: GraftDB's mechanism over KV-prefix state.

Mapping (DESIGN.md §6, beyond-paper):

| GraftDB (paper)                  | serving (here)                         |
|----------------------------------|----------------------------------------|
| shared hash-build state          | KV cache of a token prefix             |
| state signature (exact identity) | (model, weights-version)               |
| coverage metadata                | number of prefix tokens prefilled      |
| derivation-identified occurrence | token position in the prefix           |
| represented extent               | matched prefix already prefilled       |
| residual extent                  | matched portion a RUNNING prefill will |
|                                  | still produce (request waits on gate)  |
| unattached extent                | the request's unique suffix (ordinary  |
|                                  | prefill work)                          |
| per-query state lens             | request may read cache[0:matched_len)  |
| state-readiness gate             | covered_tokens >= matched_len          |
| retention policy                 | release prefix states with no refs, or |
|                                  | retain them under a token budget (§10) |
| retention epoch / evictor        | zero-ref prefixes stamped + reclaimed  |
|                                  | oldest-first past memory_budget_tokens |

The scheduler is executor-agnostic: `SimExecutor` models token costs (used
by tests/benchmarks); a real executor runs models/model.py prefill/decode.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Tuple[int, ...]
    n_decode: int
    arrival: float
    # filled by the scheduler
    t_first_token: Optional[float] = None
    t_complete: Optional[float] = None
    represented_tokens: int = 0
    residual_tokens: int = 0
    ordinary_tokens: int = 0


class PrefixState:
    """A shared KV-prefix state. ``covered`` is the coverage metadata: the
    producer (a running prefill) has materialized cache for [0, covered).

    State ids are scheduler-scoped (allocated by the owning
    FoldingScheduler), so repeated scheduler constructions are isolated —
    ids never leak across instances."""

    def __init__(self, sid: int, tokens: Tuple[int, ...]):
        self.sid = sid
        self.tokens = tokens
        self.covered = 0
        self.refs: set = set()
        # retention epoch stamp (§10): None while any request pins the
        # state; set when retired under retain_prefixes
        self.retired_epoch: Optional[int] = None

    def visible_len(self, request_prefix_len: int) -> int:
        """Per-request state lens: a request observes only its matched
        prefix, and only once covered."""
        return min(self.covered, request_prefix_len)


def _match_len(a: Tuple[int, ...], b: Tuple[int, ...]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class FoldingScheduler:
    """Admission + scheduling of requests over shared prefix states.

    ``fold=False`` gives the isolated baseline (every request prefills its
    whole prompt). Single-server cost model mirroring the paper's
    single-worker evaluation: the executor serves one token-batch at a time.
    """

    def __init__(
        self,
        executor,
        fold: bool = True,
        min_share: int = 16,
        retain_prefixes: bool = False,
        memory_budget_tokens: Optional[int] = None,
        reuse_cache_tokens: Optional[int] = None,
        batch_fold: bool = False,
    ):
        self.ex = executor
        self.fold = fold
        self.min_share = min_share
        # §15 batch planning, serving flavor: when several requests are due
        # at the same decision step, admit the longest prompt first so the
        # fresh prefix state it creates covers every shorter same-prefix
        # prompt in the group (they fold at their full match length instead
        # of only the shortest arrival's).
        self.batch_fold = batch_fold
        # §10 lifecycle: retain zero-ref prefix states (their covered KV
        # cache keeps serving later requests with the same prefix) and
        # evict oldest-epoch-first past the token budget.
        self.retain_prefixes = retain_prefixes
        self.memory_budget_tokens = memory_budget_tokens
        self._epoch = 0
        self.states: List[PrefixState] = []
        self.metrics = {
            "represented": 0,
            "residual": 0,
            "ordinary": 0,
            # §15: same-instant admission groups planned jointly, and the
            # members that folded onto a group-mate's state
            "batch_groups": 0,
            "batch_folded": 0,
        }
        # lifecycle gauges kept apart from the per-episode token metrics
        self.lifecycle_metrics = {
            "evicted_states": 0,
            "evicted_tokens": 0,
            "revived_states": 0,
            "retained_tokens": 0,
            "retained_tokens_high_water": 0,
            # reuse plane (§12) — zero whether or not the cache is on
            "cache_spills": 0,
            "cache_hits": 0,
            "cache_evictions": 0,
            "rehydrate_tokens": 0,
        }
        # Reuse plane (DESIGN.md §12): evicted KV prefixes spill into the
        # same tiered ArtifactStore the relational engine uses (8 bytes per
        # cached token models the KV page handle) and rehydrate when a
        # later prompt matches.
        self.reuse = None
        if reuse_cache_tokens is not None:
            if not retain_prefixes:
                raise ValueError("reuse_cache_tokens requires retain_prefixes=True")
            from ..core.reuse import ArtifactStore

            self.reuse = ArtifactStore(
                budget=8 * reuse_cache_tokens, counters=self.lifecycle_metrics
            )
        self._next_sid = 0  # scheduler-scoped state ids (no cross-instance leaks)
        # Admission hook for the Session facade (api/serving.py): called as
        # on_admit(req, attachment) right after each request is admitted.
        self.on_admit: Optional[object] = None

    def _new_state(self, tokens: Tuple[int, ...]) -> PrefixState:
        self._next_sid += 1
        return PrefixState(self._next_sid, tokens)

    # -- query grafting (admission) ----------------------------------------
    def preview(self, prompt: Tuple[int, ...]) -> Dict:
        """Read-only admission preview: how ``prompt`` would partition
        against the current live prefix states. Mutates nothing — the
        single source of truth for both ``admit`` and the Session facade's
        ``explain_fold``."""
        best, best_m = None, 0
        if self.fold:
            for st in self.states:
                m = _match_len(st.tokens, prompt)
                if m > best_m:
                    best, best_m = st, m
        if best is None or best_m < self.min_share:
            return {
                "state": None,  # admission would create a fresh state
                "matched": 0,
                "represented": 0,
                "residual": 0,
                "suffix": len(prompt),
                "created": True,
                # a spilled prefix artifact would rehydrate first (§12) —
                # read-only peek, surfaced through explain_fold
                "served_from_cache": self._cached_match(prompt) is not None,
            }
        represented = min(best.covered, best_m)
        return {
            "state": best,
            "matched": best_m,
            "represented": represented,
            "residual": best_m - represented,  # gate: running producer delivers
            "suffix": len(prompt) - best_m,
            "created": False,
            "served_from_cache": False,
        }

    def _cached_match(self, prompt: Tuple[int, ...]):
        """Best spilled prefix artifact for ``prompt`` (longest common
        prefix >= min_share), or None. Deterministic: spill order breaks
        ties. Read-only — ``_admit`` takes the winner."""
        if self.reuse is None or not self.fold:
            return None
        best, best_m = None, 0
        for art in self.reuse.iter_kind("kv_prefix"):
            m = _match_len(tuple(art.meta["tokens"]), prompt)
            if m > best_m:
                best, best_m = art, m
        if best is None or best_m < self.min_share:
            return None
        return best

    def admit(self, req: Request) -> Dict:
        """Partition the request's prompt into represented / residual /
        unattached extents against the best compatible live prefix state."""
        att = self._admit(req)
        if self.on_admit is not None:
            self.on_admit(req, att)
        return att

    def _admit(self, req: Request) -> Dict:
        att = self.preview(req.prompt)
        if att["created"] and att.get("served_from_cache"):
            # reuse plane (§12): rehydrate the spilled prefix before
            # creating fresh state — the restored coverage serves this
            # request's matched prefix as represented tokens
            art = self._cached_match(req.prompt)
            taken = self.reuse.take(art.fingerprint)
            st = self._new_state(tuple(taken.meta["tokens"]))
            st.covered = int(taken.meta["covered"])
            self.states.append(st)
            lm = self.lifecycle_metrics
            lm["cache_hits"] += 1
            lm["rehydrate_tokens"] += len(taken.meta["tokens"])
            att = self.preview(req.prompt)  # re-partition against it
        if att["created"]:
            st = self._new_state(req.prompt)
            st.refs.add(req.rid)
            self.states.append(st)
            req.ordinary_tokens = len(req.prompt)
            self.metrics["ordinary"] += req.ordinary_tokens
            # matched = whole prompt: the created state covers it once this
            # request's own prefill completes (run() advances st.covered by
            # it); "created" lets observers tell this from a full match.
            return {**att, "state": st, "matched": len(req.prompt), "suffix": 0}
        st: PrefixState = att["state"]
        st.refs.add(req.rid)
        if st.retired_epoch is not None:  # revive a retained prefix (§10)
            st.retired_epoch = None
            self.lifecycle_metrics["revived_states"] += 1
        req.represented_tokens = att["represented"]
        req.residual_tokens = att["residual"]
        req.ordinary_tokens = att["suffix"]
        self.metrics["represented"] += att["represented"]
        self.metrics["residual"] += att["residual"]
        self.metrics["ordinary"] += att["suffix"]
        return att

    def release(self, req: Request) -> None:
        for st in self.states:
            st.refs.discard(req.rid)
        if not self.retain_prefixes:
            self.states = [s for s in self.states if s.refs]  # drop at zero refs
            return
        # §10: retire zero-ref prefixes (their KV cache keeps serving later
        # matching requests), then enforce the token budget oldest-first
        for s in self.states:
            if not s.refs and s.retired_epoch is None:
                self._epoch += 1
                s.retired_epoch = self._epoch
        self._enforce_token_budget()

    def _enforce_token_budget(self) -> None:
        """Evict retired prefix states oldest-epoch-first until the retained
        tokens fit ``memory_budget_tokens``. Pinned (ref'd) states are never
        evicted — a request's lens may still read them."""
        retired = sorted(
            (s for s in self.states if s.retired_epoch is not None),
            key=lambda s: s.retired_epoch,
        )
        total = sum(len(s.tokens) for s in retired)
        budget = self.memory_budget_tokens
        evicted: set = set()
        if budget is not None:
            for s in retired:
                if total <= budget:
                    break
                assert not s.refs, "evicting a pinned prefix state"
                evicted.add(s.sid)
                total -= len(s.tokens)
                self.lifecycle_metrics["evicted_states"] += 1
                self.lifecycle_metrics["evicted_tokens"] += len(s.tokens)
                if self.reuse is not None and s.covered > 0:
                    # spill instead of destroy (§12): the covered KV pages
                    # become a cached artifact a later prompt can rehydrate
                    from ..core.reuse import StateArtifact, prefix_fingerprint

                    self.reuse.put(
                        StateArtifact(
                            prefix_fingerprint(s.tokens),
                            "kv_prefix",
                            None,
                            8 * len(s.tokens),
                            {"tokens": tuple(s.tokens), "covered": s.covered},
                            arrays={},
                        )
                    )
        if evicted:
            self.states = [s for s in self.states if s.sid not in evicted]
        lm = self.lifecycle_metrics
        lm["retained_tokens"] = total
        if total > lm["retained_tokens_high_water"]:
            lm["retained_tokens_high_water"] = total

    # -- execution ------------------------------------------------------------
    def run(self, requests: List[Request]) -> Dict:
        """Event loop over a single-server executor."""
        now = 0.0
        pending = sorted(requests, key=lambda r: r.arrival)
        i = 0
        # active: (ready_time, rid) -> phases
        work: List[Tuple[float, int, Request, Dict]] = []
        done: List[Request] = []
        decode_pool: List[Request] = []
        decode_left: Dict[int, int] = {}

        while i < len(pending) or work or decode_pool:
            due: List[Request] = []
            while i < len(pending) and pending[i].arrival <= now:
                due.append(pending[i])
                i += 1
            if self.batch_fold and self.fold and len(due) > 1:
                # §15 joint admission: longest prompt first, so its fresh
                # state is live (at its full length) when the shorter
                # group-mates partition against it. Execution order below
                # is unchanged — the work heap still pops (arrival, rid).
                self.metrics["batch_groups"] += 1
                due = sorted(due, key=lambda r: (-len(r.prompt), r.arrival, r.rid))
                for req in due:
                    att = self.admit(req)
                    if not att["created"]:
                        self.metrics["batch_folded"] += 1
                    heapq.heappush(work, (req.arrival, req.rid, req, att))
            else:
                for req in due:
                    att = self.admit(req)
                    heapq.heappush(work, (req.arrival, req.rid, req, att))
            if not work and not decode_pool:
                if i < len(pending):
                    now = pending[i].arrival
                    continue
                break
            # prefill obligations first (producers open downstream gates)
            if work:
                _, _, req, att = heapq.heappop(work)
                st: PrefixState = att["state"]
                m = att["matched"]
                # state lens at execution time: the represented extent may
                # have GROWN since admission (another producer advanced
                # coverage) — observe it, produce the rest.
                covered_now = st.visible_len(m)
                todo = (len(req.prompt) - m) + (m - covered_now)
                self.metrics["computed"] = self.metrics.get("computed", 0) + todo
                now += self.ex.prefill_cost(todo)
                # residual production contributes to the shared state
                st.covered = max(st.covered, m)
                req.t_first_token = now
                decode_pool.append(req)
                decode_left[req.rid] = req.n_decode
                continue
            # decode: one batched step over all active decodes
            batch = len(decode_pool)
            now += self.ex.decode_cost(batch)
            finished = []
            for r in decode_pool:
                decode_left[r.rid] -= 1
                if decode_left[r.rid] <= 0:
                    r.t_complete = now
                    finished.append(r)
            for r in finished:
                decode_pool.remove(r)
                self.release(r)
                done.append(r)
        lat = [r.t_complete - r.arrival for r in done]
        return {
            "completed": len(done),
            "elapsed": now,
            "mean_latency": sum(lat) / max(len(lat), 1),
            "p95_latency": sorted(lat)[int(0.95 * (len(lat) - 1))] if lat else 0.0,
            "prefill_tokens": dict(self.metrics),
        }


class SimExecutor:
    """Token-cost model of one serving worker (prefill compute-bound,
    decode latency per batched step)."""

    def __init__(self, prefill_tok_s: float = 8000.0, decode_step_s: float = 0.02):
        self.prefill_tok_s = prefill_tok_s
        self.decode_step_s = decode_step_s

    def prefill_cost(self, n_tokens: int) -> float:
        return n_tokens / self.prefill_tok_s

    def decode_cost(self, batch: int) -> float:
        return self.decode_step_s * (1.0 + 0.02 * batch)
