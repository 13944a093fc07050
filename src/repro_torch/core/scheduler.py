"""Ready-unit extraction (Algorithm 2, partition-lifted) and the worker-pool
executor.

The evaluated prototype (paper §6.1) uses one worker thread: inter-query
concurrency comes from interleaving ready fragments of the shared execution
DAG. We reproduce that model and lift it to a partition-parallel pool
(DESIGN.md §9): the schedulable unit is a (shared scan × partition) pair,
and a ``WorkerPool`` of N logical workers repeatedly hands the next ready
unit to the least-advanced worker, which advances that scan shard by one
morsel — pushing the morsel through every attached pipeline for every
active node-query pair. ``workers=1, partitions=1`` reduces exactly to the
paper's single-worker round-robin loop.

Clocks:

* ``WorkClock`` — virtual time advanced by the modeled cost of each executed
  fragment (calibrated per-row constants). Makes the paper's hour-long
  open-loop sweeps reproducible in seconds, deterministically.
* ``WallClock`` — real time (used by the fig.6 two-query experiment). Sleeps
  are capped by ``max_sleep_s``: under virtual-dominant traces the remainder
  of a long idle gap is skipped by advancing an internal skew instead of
  blocking the process.
* ``PoolClock`` — the engine-visible facade over N per-worker ``WorkClock``s.
  Events (admission, activation, completion) are timestamped on the worker
  executing them; cross-worker dependencies merge with max-at-barrier
  semantics — a worker picking up a unit enabled at time t first advances
  its own clock to t. The merged makespan is the max over worker clocks.

Work-model counters (rows scanned / built / probed) are clock-independent,
and the whole pool is deterministic: unit choice depends only on clock
values and (sid, partition) order, never on host timing.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .engine import GraftEngine, QueryHandle
from .grafting import candidate_states, graft_potential
from .plans import Query
from .reuse import reuse_potential
from .runtime import Member, Pipeline, ScanNode

# ---------------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------------


class WorkClock:
    def __init__(self):
        self.now = 0.0

    def tick(self, cost: float) -> None:
        self.now += cost

    def advance_to(self, t: float) -> None:
        if t > self.now:
            self.now = t


class WallClock:
    """Real time. ``max_sleep_s`` caps each blocking sleep: when a trace is
    virtual-dominant (arrivals far apart relative to real work), the
    un-slept remainder is added to an internal skew so ``now`` still lands
    on the requested timestamp without blocking the process for it."""

    def __init__(self, max_sleep_s: Optional[float] = None):
        self._t0 = time.perf_counter()
        self._skew = 0.0
        self.max_sleep_s = max_sleep_s

    @property
    def now(self) -> float:
        return time.perf_counter() - self._t0 + self._skew

    def tick(self, cost: float) -> None:
        pass  # real work took real time

    def advance_to(self, t: float) -> None:
        dt = t - self.now
        if dt <= 0:
            return
        if self.max_sleep_s is not None and dt > self.max_sleep_s:
            time.sleep(self.max_sleep_s)
            rem = t - self.now
            if rem > 0:
                self._skew += rem  # skip the idle remainder virtually
        else:
            time.sleep(dt)


class PoolClock:
    """Engine-visible merge of the pool's per-worker clocks.

    While a worker executes, ``now`` is that worker's local time (events it
    causes are stamped on it); between steps ``now`` is the max over workers
    (the pool's barrier-merged frontier). With one worker this is exactly
    the seed single-clock behavior."""

    def __init__(self, clocks: List):
        self.clocks = clocks
        self.current = None  # the executing worker's clock, if any

    @property
    def now(self) -> float:
        if self.current is not None:
            return self.current.now
        return max(c.now for c in self.clocks)

    def tick(self, cost: float) -> None:
        (self.current or self.clocks[0]).tick(cost)

    def advance_to(self, t: float) -> None:
        for c in self.clocks:
            c.advance_to(t)


# ---------------------------------------------------------------------------
# Algorithm 2 — ExtractReadyFragments, lifted to (fragment × partition)
# ---------------------------------------------------------------------------


def producer_inactive(n: Pipeline, m: Member) -> bool:
    """Lines 22-25: a state-producing node-query pair is inactive once no
    producer work assigned to q remains pending."""
    if n.build_target is None:
        return False
    return m.done or m.received >= m.need > 0


def state_consumer_blocked(m: Member) -> bool:
    """Lines 26-32: a state-consuming node-query pair passes only when every
    state-ref gate entering it is open."""
    return any(not g.open() for g in m.gates)


def active_at_node(n: Pipeline, part: Optional[int] = None) -> List[Member]:
    """Lines 13-21 over one operator node (pipeline); with ``part`` the
    filter additionally requires the member to still be owed morsels from
    that scan partition."""
    out = []
    for m in n.members:
        if m.done:
            continue
        if part is not None and not m.pending_in(part):
            continue
        if producer_inactive(n, m):
            continue
        if state_consumer_blocked(m):
            continue
        if not m.active:
            # gate newly opened — activation assigns the delivery cycle
            continue
        out.append(m)
    return out


def extract_ready_fragments(engine: GraftEngine) -> List[ScanNode]:
    """Restrict the DAG to active node-query pairs, prune by data-edge
    reachability (a pipeline is reachable iff its source scan can still
    deliver morsels to it), group into weak components (pipelines sharing a
    source scan), and order along data edges (scan -> pipelines). Each
    fragment is executable by advancing its scan one morsel."""
    frags: List[ScanNode] = []
    for node in engine.scans.values():
        for p in node.pipelines:
            if active_at_node(p):
                frags.append(node)
                break
    frags.sort(key=lambda s: s.sid)
    return frags


def extract_ready_units(engine: GraftEngine) -> List[Tuple[ScanNode, int]]:
    """The partition-lifted fragment set: every (scan, partition) shard with
    at least one active member still owed morsels from it, ordered by
    (sid, partition). Each unit is executable by advancing that shard one
    morsel on any worker."""
    units: List[Tuple[ScanNode, int]] = []
    for node in engine.scans.values():
        for part in range(node.n_partitions):
            for p in node.pipelines:
                if active_at_node(p, part):
                    units.append((node, part))
                    break
    units.sort(key=lambda u: (u[0].sid, u[1]))
    return units


def unit_ready_time(node: ScanNode, part: int) -> float:
    """Barrier time of one unit: the latest activation among the members it
    would serve — a worker adopting the unit advances its clock here first
    (max-at-barrier merge of the producing workers' clocks)."""
    t = 0.0
    for p in node.pipelines:
        for m in p.active_members_for(part):
            if m.t_activated > t:
                t = m.t_activated
    return t


# ---------------------------------------------------------------------------
# Admission control (overload-aware open-loop serving, DESIGN.md §10)
# ---------------------------------------------------------------------------


class AdmissionController:
    """Per-arrival admission decision for the open-loop queue.

    ``decide(engine, query) -> (verdict, reason)`` where verdict is
    ``'admit'`` or ``'defer'`` and reason labels the admitted path — the
    arrival's three-way cost decision (§12): ``'graft'`` (rides live
    shared state), ``'cache'`` (a spilled artifact rehydrates and serves
    it), or ``'fresh'`` (isolated recompute through an ordinary plan). The
    adaptive policy admits freely below ``max_inflight`` active queries;
    past it, only arrivals whose sharing potential — the demand-weighted
    fraction of their isolated plan that existing shared state
    (``graft_potential``) or cost-winning cached artifacts
    (``reuse_potential``) would absorb — reaches ``share_threshold`` are
    admitted (their marginal work is small, and their lens pins state the
    evictor would otherwise reclaim / consumes an artifact before the
    cache ages it out). Everything else queues until load drops; the
    Runner pins a deferred arrival's candidate states
    (``candidate_states``) so the evictor cannot reclaim coverage a
    queued-but-admissible lens is waiting to observe.

    Decisions depend only on engine state (live indexes + the artifact
    cache, both of which change exactly at submissions/completions), so
    the whole pool stays a deterministic simulation under any
    ``PoolClock`` schedule and the Runner's drain memo stays valid.
    """

    def __init__(self, max_inflight: int = 8, share_threshold: float = 0.5):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight!r}")
        if not (0.0 < share_threshold <= 1.0):
            raise ValueError(
                f"share_threshold must be in (0, 1], got {share_threshold!r}"
            )
        self.max_inflight = max_inflight
        self.share_threshold = share_threshold
        # per-arrival potential memo keyed on the engine's live-state
        # generation (bumped at state attach/retire/evict): a deep FIFO
        # queue used to rescan every arrival's graft_potential on every
        # queue-length change even though its inputs were untouched
        self._pot_memo: Dict[int, Tuple[Tuple[int, float, float], float, float]] = {}

    def potentials(self, engine: GraftEngine, query: Query) -> Tuple[float, float]:
        """Memoized ``(graft_potential, reuse_potential)`` of one arrival.

        The memo key is ``(state_gen, submitted, completed)`` — exactly the
        state a verdict reads (live indexes + artifact cache + in-flight
        progress at the drain granularity), so a hit returns the same value
        a recomputation would. ``admission_evals`` counts only the real
        evaluations (the regression suite pins scan counts on it)."""
        gen = (
            engine.state_gen,
            engine.counters["submitted"],
            engine.counters["completed"],
        )
        hit = self._pot_memo.get(query.qid)
        if hit is not None and hit[0] == gen:
            return hit[1], hit[2]
        live = graft_potential(engine, query)
        cached = reuse_potential(engine, query)
        engine.counters["admission_evals"] += 1
        self._pot_memo[query.qid] = (gen, live, cached)
        return live, cached

    def decide(
        self,
        engine: GraftEngine,
        query: Query,
        active_count: Optional[int] = None,
    ) -> Tuple[str, str]:
        """``active_count`` overrides ``len(engine.active_handles)`` — the
        batched admission path (§15) passes the simulated in-flight count so
        selecting a whole cohort at one decision step keeps the greedy FIFO
        semantics."""
        live, cached = self.potentials(engine, query)
        potential = max(live, cached)
        if potential <= 0.0:
            reason = "fresh"
        elif cached > live:
            reason = "cache"
        else:
            reason = "graft"  # live state dominates: no rehydration cost
        n_active = len(engine.active_handles) if active_count is None else active_count
        if n_active < self.max_inflight:
            self._pot_memo.pop(query.qid, None)
            return ("admit", reason)
        if potential >= self.share_threshold:
            self._pot_memo.pop(query.qid, None)
            return ("admit", reason)
        return ("defer", "overload")


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


class Runner:
    """Drives one GraftEngine over an arrival trace with N logical workers.

    ``on_complete(handle) -> Optional[Query]`` implements closed-loop
    clients: returning a query enqueues it (arrival = completion time).

    One worker with one partition is byte-identical to the seed
    single-worker executor: same unit order, same clock, same timestamps.
    """

    def __init__(
        self,
        engine: GraftEngine,
        clock=None,
        workers: int = 1,
        clock_factory: Optional[Callable[[], object]] = None,
        admission: Optional[AdmissionController] = None,
        batch_planning: bool = False,
        batch_window: float = 0.0,
    ):
        self.engine = engine
        self.workers = max(1, int(workers))
        if self.workers == 1:
            base = clock if clock is not None else (clock_factory or WorkClock)()
            self.clocks = [base]
        else:
            # N logical workers need N independent virtual clocks; a shared
            # wall/instance clock cannot model parallel speedup
            factory = clock_factory or WorkClock
            self.clocks = [factory() for _ in range(self.workers)]
        self.clock = PoolClock(self.clocks)
        self.busy_s = [0.0] * self.workers
        engine.clock = self.clock
        self._rr: Tuple[int, int] = (0, -1)  # last executed (sid, partition)
        self._heap: List[Tuple[float, int, Query]] = []
        # overload-aware admission (§10): None = admit every due arrival
        # (the seed open-loop behavior); a controller may defer arrivals
        # into the FIFO admit queue until load drops.
        self.admission = admission
        self._admit_queue: List[Tuple[float, int, Query, float]] = []
        self._queued_pins: Dict[int, List] = {}  # qid -> pinned candidate states
        # drain memo: controller verdicts depend only on engine state
        # (active handles + shared-state indexes), which changes exactly at
        # submissions and completions — skip replaying the queue through
        # decide()/graft_potential when neither has happened
        self._drain_ver: Optional[Tuple[float, float, int]] = None
        self.admission_log: Dict[int, Dict[str, object]] = {}
        # batch planning (§15): gather every arrival due at one decision
        # step, window them into cohorts, and admit each cohort in the
        # joint planner's provider-first order. False leaves the greedy
        # one-at-a-time path byte-identical to prior PRs.
        self.batch_planning = bool(batch_planning)
        self.batch_window = float(batch_window)
        self.cohort_log: List[Dict[str, object]] = []
        # Called with the query right before each admission (the Session
        # facade captures EXPLAIN GRAFT snapshots through this).
        self.submit_hook: Optional[Callable[[Query], None]] = None
        # fault tolerance + per-query lifecycle (§16): the engine's fault
        # plane (None = hooks disarmed, zero overhead), virtual-time
        # deadlines enforced at decision-step boundaries, and the terminal
        # reason of arrivals cancelled before they ever got a handle.
        self.faults = getattr(engine, "faults", None)
        self.deadlines: Dict[int, float] = {}
        self.cancelled_qids: Dict[int, str] = {}

    def add_arrival(self, query: Query) -> None:
        # keyed by (arrival, qid): permuted add_arrival orders of one trace
        # replay identically (qids are allocated in trace order)
        heapq.heappush(self._heap, (query.arrival, query.qid, query))

    def submit_now(self, query: Query) -> QueryHandle:
        """Admit one query immediately (query grafting happens here)."""
        if self.submit_hook is not None:
            self.submit_hook(query)
        return self.engine.submit(query)

    def submit_arrival(self, query: Query) -> Optional[QueryHandle]:
        """Admission-controlled immediate submission (the Session.submit
        path for due arrivals). Returns the handle, or None if deferred."""
        if self._try_admit(query, self.clock.now):
            return self.engine.handles[query.qid]
        return None

    # -- admission path (§10) ------------------------------------------------
    def _try_admit(self, q: Query, now: float, t_queued: Optional[float] = None) -> bool:
        """Run one query through the admission controller; submit on admit,
        enqueue first-time deferrals. Returns True iff submitted."""
        if self.admission is None:
            self.submit_now(q)
            return True
        verdict, reason = self.admission.decide(self.engine, q)
        if verdict == "admit":
            delay = (now - t_queued) if t_queued is not None else 0.0
            if t_queued is not None:
                self.engine.counters["queue_delay_s_total"] += delay
                self._unpin_candidates(q.qid)
            self.admission_log[q.qid] = {
                "decision": reason,
                "queued": t_queued is not None,
                "queue_delay_s": delay,
                "t_admitted": now,
            }
            self.submit_now(q)
            return True
        if t_queued is None:
            self.engine.counters["queued_admissions"] += 1
            self._admit_queue.append((q.arrival, q.qid, q, now))
            # pin the candidate states this arrival would graft onto: a
            # queued-but-admissible lens must not lose its coverage to the
            # evictor while it waits (§10)
            self._pin_candidates(q)
        return False

    def _pin_candidates(self, q: Query) -> None:
        """(Re-)snapshot the pins of one queued arrival: states that became
        candidates while it waited are pinned too, states that left the
        index drop off. Idempotent — called at defer and at every
        effective drain retry."""
        token = ("queued", q.qid)
        for s in self._queued_pins.pop(q.qid, ()):
            s.unpin(token)
        pinned = []
        for s in candidate_states(self.engine, q):
            s.pin(token)
            pinned.append(s)
        if pinned:
            self._queued_pins[q.qid] = pinned

    def _unpin_candidates(self, qid: int) -> None:
        token = ("queued", qid)
        for s in self._queued_pins.pop(qid, ()):
            s.unpin(token)

    def _drain_admit_queue(self, now: float, on_complete=None) -> None:
        """Retry deferred arrivals in FIFO order; keep the still-deferred.
        Memoized on (submitted, completed, queue length): re-deciding is
        pointless until the engine state a verdict reads has changed."""
        if not self._admit_queue:
            return
        c = self.engine.counters
        ver = (c["submitted"], c["completed"], len(self._admit_queue))
        if ver == self._drain_ver:
            return
        pending, self._admit_queue = self._admit_queue, []
        for arr, qid, q, t0 in pending:
            if self._try_admit(q, now, t_queued=t0):
                self._after_events(on_complete)
            else:
                self._admit_queue.append((arr, qid, q, t0))
                self._pin_candidates(q)  # re-snapshot against fresh state
        self._drain_ver = (c["submitted"], c["completed"], len(self._admit_queue))

    def _force_admit_head(self, now: float, on_complete=None) -> None:
        """Liveness valve: admit the queue head unconditionally (reached
        only if a policy defers while nothing can otherwise progress)."""
        arr, qid, q, t0 = self._admit_queue.pop(0)
        self._unpin_candidates(qid)
        delay = now - t0
        self.engine.counters["queue_delay_s_total"] += delay
        self.engine.counters["forced_admissions"] += 1
        self.admission_log[qid] = {
            "decision": "forced",
            "queued": True,
            "queue_delay_s": delay,
            "t_admitted": now,
        }
        self.submit_now(q)
        self._after_events(on_complete)

    # -- per-query lifecycle (§16) -------------------------------------------
    def _remove_queued(self, qid: int) -> bool:
        """Strip one not-yet-admitted arrival from the heap / admit queue
        (dropping its eviction pins). True iff it was found."""
        found = False
        kept = [e for e in self._heap if e[1] != qid]
        if len(kept) != len(self._heap):
            self._heap = kept
            heapq.heapify(self._heap)
            found = True
        kept_q = [e for e in self._admit_queue if e[1] != qid]
        if len(kept_q) != len(self._admit_queue):
            self._admit_queue = kept_q
            found = True
        if found:
            self._unpin_candidates(qid)
            self._drain_ver = None
        return found

    def cancel(self, qid: int, reason: str = "cancelled") -> bool:
        """Cancel one query. Queued arrivals are removed before they ever
        admit; an in-flight query tears down at this morsel boundary
        (engine.cancel_query: producer handoff / seal, detach, riders
        unfold). False for unknown or already-terminal qids — cancelling a
        completed query is a no-op, its result stays valid."""
        handle = self.engine.handles.get(qid)
        self.deadlines.pop(qid, None)
        if handle is None:
            if not self._remove_queued(qid):
                return False
            self.cancelled_qids[qid] = reason
            c = self.engine.counters
            c["cancelled"] += 1
            if reason == "deadline":
                c["deadline_cancellations"] += 1
            return True
        if handle.done or handle.status != "active":
            return False
        ok = self.engine.cancel_query(handle, reason)
        if ok:
            self._drain_ver = None
        return ok

    def _apply_deadlines(self, now: float, on_complete) -> bool:
        """Enforce due deadlines at a decision-step boundary — exactly an
        explicit ``cancel(qid, "deadline")`` per expired query. Returns
        True when anything was cancelled (the caller re-extracts its ready
        units: a torn-down pipeline must not execute)."""
        if not self.deadlines:
            return False
        expired = sorted(q for q, d in self.deadlines.items() if d <= now)
        acted = False
        for qid in expired:
            if self.cancel(qid, "deadline"):
                acted = True
        if acted:
            self._after_events(on_complete)
        return acted

    def _fault_gate(self, node, part, wclock, on_complete) -> bool:
        """§16 fault hooks around one morsel advance. True ⇒ the morsel may
        execute. A stall only delays the worker; a fault that survives the
        bounded retries escalates — the morsel never runs, no state
        mutates, and the impacted queries quarantine/unfold/fail."""
        fp = self.faults
        stall = fp.stall()
        if stall > 0.0:
            wclock.tick(stall)
        site = "exchange" if self.engine.mesh_plan is not None else "morsel"
        if fp.attempt(site, wclock):
            return True
        self._escalate(node, part, on_complete)
        return False

    def _escalate(self, node, part, on_complete) -> None:
        """Retry exhaustion at one (scan × partition) unit. Every pipeline
        that would have consumed the faulted morsel is affected: shared
        build targets are quarantined (their fragments are suspect — the
        engine tombstones them and unfolds the attached queries), and
        main-pipeline queries not already handled by a quarantine unfold
        to isolated execution (first escalation) or fail (second)."""
        engine = self.engine
        states: List = []
        qids = set()
        for pipeline in list(node.pipelines):
            if not pipeline.active_members_for(part):
                continue
            bt = pipeline.build_target
            if bt is not None:
                if bt.state not in states:
                    states.append(bt.state)
            else:
                qids.update(m.qid for m in pipeline.active_members_for(part))
        handled = set()
        for st in states:
            handled.update(
                h.qid for h in engine.active_handles if st in h.attached_states
            )
            engine.quarantine_state(st)
        for qid in sorted(qids - handled):
            h = engine.handles.get(qid)
            if h is None or h.done or h.status != "active":
                continue
            if h.degraded:
                engine.cancel_query(h, "failed")
            else:
                engine.unfold(h)
        self._drain_ver = None
        self._after_events(on_complete)

    def worker_stats(self) -> Dict[str, object]:
        """Per-worker utilization of the run so far (QueryFuture.stats)."""
        makespan = max(c.now for c in self.clocks)
        return {
            "n": self.workers,
            "busy_s": [round(b, 9) for b in self.busy_s],
            "makespan_s": makespan,
            "utilization": [
                (b / makespan if makespan > 0 else 0.0) for b in self.busy_s
            ],
        }

    def _admit_due(self, now: float, on_complete) -> None:
        if self.batch_planning:
            self._admit_due_batched(now, on_complete)
            return
        self._drain_admit_queue(now, on_complete)
        while self._heap and self._heap[0][0] <= now:
            _, _, q = heapq.heappop(self._heap)
            if self._try_admit(q, now):
                self._after_events(on_complete)

    # -- batched admission (§15) ---------------------------------------------
    def _admit_due_batched(self, now: float, on_complete) -> None:
        """Cohort admission: gather every candidate due at this decision
        step — the deferred FIFO queue first, then due heap arrivals — run
        the admission controller over them in FIFO order against a
        simulated in-flight count, window the admissible ones into arrival
        cohorts, and admit each cohort in the joint planner's order. A
        size-1 cohort takes exactly the greedy admission steps."""
        due: List[Tuple[float, int, Query]] = []
        while self._heap and self._heap[0][0] <= now:
            due.append(heapq.heappop(self._heap))
        if not due:
            if not self._admit_queue:
                return
            # no new arrivals: same memo as the greedy drain — verdicts
            # cannot change until a submission/completion/new deferral
            c = self.engine.counters
            if (c["submitted"], c["completed"], len(self._admit_queue)) == self._drain_ver:
                return
        # -- selection: admission semantics, FIFO order, simulated load
        selected: List[Tuple[Query, Optional[float], Optional[str]]] = []
        queued, self._admit_queue = self._admit_queue, []
        for arr, qid, q, t0 in queued:
            reason = self._select(q, len(selected))
            if reason is not None:
                selected.append((q, t0, reason))
            else:
                self._admit_queue.append((arr, qid, q, t0))
                self._pin_candidates(q)
        for arr, qid, q in due:
            reason = self._select(q, len(selected))
            if reason is not None:
                selected.append((q, None, reason))
            else:
                self.engine.counters["queued_admissions"] += 1
                self._admit_queue.append((arr, qid, q, now))
                self._pin_candidates(q)
        c = self.engine.counters
        self._drain_ver = (c["submitted"], c["completed"], len(self._admit_queue))
        if not selected:
            return
        # -- window the admissible arrivals into cohorts
        selected.sort(key=lambda e: (e[0].arrival, e[0].qid))
        cohorts: List[List[Tuple[Query, Optional[float], Optional[str]]]] = []
        for entry in selected:
            if cohorts and entry[0].arrival <= cohorts[-1][0][0].arrival + self.batch_window:
                cohorts[-1].append(entry)
            else:
                cohorts.append([entry])
        # -- admit each cohort in planned order
        from .batchplan import plan_cohort

        for cohort in cohorts:
            if len(cohort) == 1:
                q, t0, reason = cohort[0]
                self._admit_one(q, now, t0, reason, on_complete)
                continue
            plan = plan_cohort(self.engine, [e[0] for e in cohort])
            cid = len(self.cohort_log)
            self.cohort_log.append({"cohort": cid, "t": now, "plan": plan})
            self.engine.counters["batch_cohorts"] += 1
            self.engine.counters["batch_planned_queries"] += plan.size
            self.engine.counters["batch_coverage_gain_rows"] += plan.gain_rows
            by_qid = {e[0].qid: e for e in cohort}
            # §15 deferred representation: expose extents earlier cohort
            # members register to the later ones (resolve_boundary reads
            # cohort_ctx); cleared before control leaves the cohort so the
            # greedy path never sees it
            self.engine.cohort_ctx = {}
            try:
                for slot, qid in enumerate(plan.order):
                    q, t0, reason = by_qid[qid]
                    self._admit_one(
                        q,
                        now,
                        t0,
                        reason,
                        on_complete,
                        cohort_meta={"cohort": cid, "size": plan.size, "slot": slot},
                    )
            finally:
                self.engine.cohort_ctx = None

    def _select(self, q: Query, n_selected: int) -> Optional[str]:
        """Selection half of the batched path: the admission reason when the
        controller would admit ``q`` with ``n_selected`` cohort members
        already counted in-flight, else None (defer)."""
        if self.admission is None:
            return "always"
        verdict, reason = self.admission.decide(
            self.engine, q, active_count=len(self.engine.active_handles) + n_selected
        )
        return reason if verdict == "admit" else None

    def _admit_one(
        self,
        q: Query,
        now: float,
        t_queued: Optional[float],
        reason: Optional[str],
        on_complete,
        cohort_meta: Optional[Dict[str, int]] = None,
    ) -> None:
        """Admission half of the batched path: mirrors the admit branch of
        ``_try_admit`` (log record, unpin, queue-delay accounting) plus the
        cohort annotation, then submits and processes events."""
        if self.admission is not None or cohort_meta is not None:
            delay = (now - t_queued) if t_queued is not None else 0.0
            if t_queued is not None:
                self.engine.counters["queue_delay_s_total"] += delay
                self._unpin_candidates(q.qid)
            record: Dict[str, object] = {
                "decision": reason,
                "queued": t_queued is not None,
                "queue_delay_s": delay,
                "t_admitted": now,
            }
            if cohort_meta is not None:
                # recorded regardless of admission control: the cohort
                # membership of a planned admission is part of its stats
                record["cohort"] = cohort_meta
            self.admission_log[q.qid] = record
        self.submit_now(q)
        self._after_events(on_complete)

    def run(
        self,
        arrivals: Iterable[Query] = (),
        on_complete: Optional[Callable[[QueryHandle], Optional[Query]]] = None,
        max_steps: int = 50_000_000,
    ) -> List[QueryHandle]:
        engine = self.engine
        for q in arrivals:
            self.add_arrival(q)
        steps = 0
        try:
            while self._heap or self._admit_queue or engine.has_active_work():
                steps += 1
                if steps > max_steps:
                    raise RuntimeError("executor exceeded max_steps — livelock?")
                # least-advanced worker takes the next scheduling decision
                wi = min(range(self.workers), key=lambda i: self.clocks[i].now)
                wclock = self.clocks[wi]
                self.clock.current = wclock
                # due deadlines cancel before anything else at this step
                self._apply_deadlines(wclock.now, on_complete)
                # admit due arrivals (query grafting happens at submit)
                self._admit_due(wclock.now, on_complete)
                units = extract_ready_units(engine)
                if not units:
                    self.clock.current = None
                    if self._heap:
                        self.clock.advance_to(self._heap[0][0])
                        continue
                    if engine.has_active_work():
                        # all remaining handles must be completable observers
                        done = engine.sweep_completions()
                        if done:
                            self._after_events(on_complete, done)
                            continue
                        if self._admit_queue:
                            # nothing completable: free the admit queue head
                            self._force_admit_head(self.clock.now, on_complete)
                            continue
                        raise RuntimeError(
                            f"deadlock: {len(engine.active_handles)} active queries, no ready fragments"
                        )
                    if self._admit_queue:
                        self._force_admit_head(self.clock.now, on_complete)
                        continue
                    break
                # mesh execution (§14): device affinity — partition p's
                # state shard is resident on device p % workers, so only
                # that worker's clock may advance it. The least-advanced
                # worker defers to the least-advanced OWNER of a ready
                # shard when it owns none itself (deterministic: owners
                # sorted, ties resolve to the lowest device id).
                if engine.mesh_plan is not None and self.workers > 1:
                    owned = [u for u in units if u[1] % self.workers == wi]
                    if not owned:
                        owners = sorted({u[1] % self.workers for u in units})
                        wi = min(owners, key=lambda i: self.clocks[i].now)
                        wclock = self.clocks[wi]
                        self.clock.current = wclock
                        owned = [u for u in units if u[1] % self.workers == wi]
                    units = owned
                # round-robin over ready (scan × partition) units
                unit = None
                for cand in units:
                    if (cand[0].sid, cand[1]) > self._rr:
                        unit = cand
                        break
                if unit is None:
                    unit = units[0]
                node, part = unit
                self._rr = (node.sid, part)
                # max-at-barrier: wait for the unit's enabling events, then
                # re-admit anything that became due during the wait
                wclock.advance_to(unit_ready_time(node, part))
                self._admit_due(wclock.now, on_complete)
                if self._apply_deadlines(wclock.now, on_complete):
                    continue  # the unit may be gone: re-extract
                if self.faults is not None and not self._fault_gate(
                    node, part, wclock, on_complete
                ):
                    continue
                cost = node.advance(engine, part)
                wclock.tick(cost)
                self.busy_s[wi] += cost
                self._after_events(on_complete)
        finally:
            self.clock.current = None
        return engine.completed

    def _after_events(self, on_complete, pre_done: Optional[List[QueryHandle]] = None) -> None:
        engine = self.engine
        engine.check_activations()
        done = list(pre_done or ())
        done += engine.sweep_completions()
        while done:
            h = done.pop()
            if on_complete is not None:
                nxt = on_complete(h)
                if nxt is not None:
                    self.add_arrival(nxt)
                    # admit immediately if due (closed loop)
                    while self._heap and self._heap[0][0] <= self.clock.now:
                        _, _, q = heapq.heappop(self._heap)
                        self._try_admit(q, self.clock.now)
            engine.check_activations()
            done += engine.sweep_completions()
