"""GraftEngine: the multi-query execution engine facade.

Execution modes (paper §6.1 / §6.4):

* ``isolated``     — same engine, all sharing disabled (private scans,
                     private pipelines, private states).
* ``qpipe_osp``    — QPipe's on-demand simultaneous pipelining: shared
                     scans + in-flight operator merge under *identical*
                     operator profiles (predicates included) with zero
                     progress; no coverage-based observation of built state.
* ``scan_sharing`` — shared cyclic scans only (+Scan Sharing variant).
* ``residual``     — + residual production into common shared state
                     (+Residual Production variant).
* ``graft``        — + represented-extent attachment through per-query
                     state lenses (full GraftDB).
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..relational.table import Database
from . import trace as _trace
from .descriptors import StateSignature, aggregate_signature
from .faults import FaultPlan, FaultPlane
from .grafting import all_boundaries, estimate_demand, plan_spine, resolve_boundary
from .plans import Aggregate, OrderBy, Query
from .predicates import TRUE, Conjunction
from .reuse import ReusePlane
from .runtime import AggGate, AggSink, Gate, Member, Pipeline, ProbeOp, ScanNode
from .state import SharedAggregateState, SharedHashBuildState, StateLifecycle


@dataclass(frozen=True)
class Mode:
    name: str
    share_scans: bool = False
    share_pipelines: bool = False
    share_state: bool = False
    allow_residual: bool = False
    allow_represented: bool = False
    agg_share: str = "none"  # 'none' | 'qpipe' | 'live' | 'full'
    qpipe: bool = False


MODES: Dict[str, Mode] = {
    "isolated": Mode("isolated"),
    "scan_sharing": Mode("scan_sharing", share_scans=True),
    "qpipe_osp": Mode("qpipe_osp", share_scans=True, qpipe=True, agg_share="qpipe"),
    "residual": Mode(
        "residual",
        share_scans=True,
        share_pipelines=True,
        share_state=True,
        allow_residual=True,
        agg_share="live",
    ),
    "graft": Mode(
        "graft",
        share_scans=True,
        share_pipelines=True,
        share_state=True,
        allow_residual=True,
        allow_represented=True,
        agg_share="full",
    ),
}

# Modeled per-row costs (seconds) of the paper's single-worker row engine
# (~100ns/row class, consistent with Q3@SF10 ≈ 14s in paper Fig.6);
# core/costmodel.py can recalibrate against the host. Ratios between engine
# modes come from row counts, not from these constants.
DEFAULT_COST_MODEL: Dict[str, float] = {
    "scan": 100e-9,
    "filter": 80e-9,
    "probe": 200e-9,
    "match": 150e-9,
    "insert": 600e-9,
    "mark": 250e-9,
    "agg": 400e-9,
    # per-entry cost of rehydrating a spilled state artifact (§12): bulk
    # SoA restore + amortized derived-index rebuild — far below the
    # scan+filter+insert cost of re-producing the same entry
    "rehydrate": 60e-9,
    # per-row cost of the bucketed all_to_all repartition (§14): charged at
    # every probe stage on a >1-device mesh — the dense [P, C, W] exchange
    # tensor transits the interconnect once per stage regardless of how
    # many rows stay resident. Zero-device-mesh (mesh=None) sessions never
    # pay it.
    "exchange": 40e-9,
}


class QueryHandle:
    def __init__(self, query: Query, t_submit: float):
        self.qid = query.qid
        self.query = query
        self.t_submit = t_submit
        self.t_complete: Optional[float] = None
        self.attached_states: List[SharedHashBuildState] = []
        self.members: List[Member] = []
        self.agg_state: Optional[SharedAggregateState] = None
        self.agg_gate: Optional[AggGate] = None
        self.orderby: Optional[OrderBy] = None
        self.result: Optional[Dict[str, np.ndarray]] = None
        self.done = False
        # boundaries this query served by rehydrating a cached artifact (§12)
        self.cache_hits = 0
        # lifecycle (§16): 'active' until completion or a terminal verdict —
        # 'cancelled' (QueryFuture.cancel / Session.close), 'deadline'
        # (submit(deadline=) expired), or 'failed' (fault escalation after
        # the query already unfolded once).
        self.status = "active"
        # the query unfolded to isolated execution after a fault (§16):
        # surfaced in stats() and as the EXPLAIN GRAFT ``degraded`` flag
        self.degraded = False

    @property
    def latency(self) -> float:
        return (self.t_complete or 0.0) - self.query.arrival


class GraftEngine:
    def __init__(
        self,
        db: Database,
        mode: str = "graft",
        morsel_size: int = 65536,
        cost_model: Optional[Dict[str, float]] = None,
        zone_maps: bool = False,
        backend=None,
        partitions: int = 1,
        retention: str = "refcount",
        memory_budget: Optional[int] = None,
        member_major: bool = True,
        reuse_cache_budget: Optional[int] = None,
        reuse_disk_budget: Optional[int] = None,
        mesh_plan=None,
        faults: Optional[FaultPlan] = None,
    ):
        self.db = db
        self.mode = MODES[mode]
        self.morsel_size = morsel_size
        self.cost_model = dict(cost_model or DEFAULT_COST_MODEL)
        # cost models predating §14 lack the exchange term; default it so a
        # mesh session over an older calibrated dict still charges it
        self.cost_model.setdefault("exchange", DEFAULT_COST_MODEL["exchange"])
        self.zone_maps = zone_maps  # beyond-paper morsel skipping (§Perf)
        # Data-plane backend (api/backends.py ExecutionBackend); None keeps
        # the built-in NumPy paths (state.probe / np.bincount reductions).
        self.backend = backend
        # Partition-parallel data plane (DESIGN.md §9): scans shard into
        # P morsel ranges, states shard their indexes / partial aggregates
        # P ways. P == 1 is byte-identical to the seed single-stream engine.
        if not isinstance(partitions, int) or partitions < 1:
            raise ValueError(f"partitions must be a positive int, got {partitions!r}")
        self.n_partitions = partitions
        # Mesh execution (DESIGN.md §14): a core.meshexec.MeshPlan mapping
        # the P key-partition shards onto 'data'-axis devices one-to-one.
        # None = single-host engine (no exchange cost, no device routing).
        if mesh_plan is not None and mesh_plan.n_shards != partitions:
            raise ValueError(
                f"mesh_plan has {mesh_plan.n_shards} data shard(s) but the "
                f"engine was built with partitions={partitions} — state "
                "shards and devices must map one-to-one"
            )
        self.mesh_plan = mesh_plan
        # Shared-state lifecycle (DESIGN.md §10): 'refcount' drops state at
        # zero refs (paper §6.1); 'epoch' retires it for later grafts under
        # a memory-budgeted evictor.
        if retention not in ("refcount", "epoch"):
            raise ValueError(f"retention must be 'refcount' or 'epoch', got {retention!r}")
        self.retention = retention
        self.memory_budget = memory_budget
        # Member-major fused morsel pipeline (DESIGN.md §11): packed-mask
        # passes make per-morsel data-plane cost independent of the folded
        # member count. False retains the per-member loops — the
        # differential oracle the fused path is verified against.
        self.member_major = bool(member_major)

        self.scans: Dict[object, ScanNode] = {}
        self.pipelines: Dict[object, Pipeline] = {}
        self.state_index: Dict[StateSignature, List[SharedHashBuildState]] = {}
        self.agg_index: Dict[StateSignature, SharedAggregateState] = {}
        self.qpipe_registry: Dict[object, Tuple[Member, SharedHashBuildState]] = {}
        self.handles: Dict[int, QueryHandle] = {}
        self.active_handles: List[QueryHandle] = []
        self.completed: List[QueryHandle] = []
        self.counters: Dict[str, float] = defaultdict(float)
        # data-plane perf counters surfaced via QueryFuture.stats — present
        # (zero) from the start so stats dicts are shape-stable
        for k in (
            "index_rebuilds",
            "kernel_lens_probes",
            "fused_filter_rows",
            # member-major fused data plane (§11) — present (zero) from the
            # start so stats dicts stay shape-stable
            "kernel_multi_lens_probes",
            "fused_vis_rows",
            "fused_stage_filter_rows",
            "fused_sink_rows",
            # device-resident fused chain (§13) — one launch per morsel
            # stage chain, with per-reason kernel-decline attribution
            "kernel_chain_launches",
            "fallback_probes_grants",
            "fallback_probes_slot_limit",
            "fallback_probes_keyrange",
            "fallback_probes_capacity",
            "fallback_probes_predicate",
            "agg_cohort_rows",
            "overflow_members",
            "partition_merges",
            "partition_probe_merges",
            # mesh execution (§14) — rows crossing the bucketed all_to_all
            # exchange per probe stage, and rows a device exchange ever
            # failed to place in a bucket (always recovered by regrowing
            # capacity — see relational.distributed.exchange_by_key)
            "mesh_exchange_rows",
            "bucket_overflow_rows",
            # batch planning (§15) — cohorts admitted through the joint
            # planner, and the §10 admission-memo evaluation count
            "batch_cohorts",
            "batch_planned_queries",
            "batch_coverage_gain_rows",
            "admission_evals",
            # lifecycle + admission counters (§10) — present (zero) from the
            # start so stats dicts stay shape-stable
            "evictions",
            "evicted_bytes",
            "state_revivals",
            "queued_admissions",
            "queue_delay_s_total",
            "forced_admissions",
            "retained_bytes",
            "retained_high_water_bytes",
            "state_bytes",
            "mem_high_water_bytes",
            # reuse plane (§12) — present (zero) from the start so stats
            # dicts stay shape-stable whether or not the cache is enabled
            "cache_hits",
            "cache_spills",
            "cache_evictions",
            "rehydrate_bytes",
            "cache_bytes",
            "cache_high_water_bytes",
            "cache_disk_bytes",
            "cache_disk_high_water_bytes",
            # fault plane + query lifecycle (§16) — present (zero) from the
            # start so stats dicts stay shape-stable with faults=None
            "faults_injected",
            "fault_retries",
            "producer_handoffs",
            "quarantined_states",
            "unfolds",
            "cancelled",
            "deadline_cancellations",
            "cache_corrupt",
        ):
            self.counters[k] = 0.0
        self.lifecycle = StateLifecycle(retention, memory_budget, self.counters)
        # Fault plane (§16): None keeps every hook compiled out of the hot
        # paths — the faults=None engine is fingerprint-identical to the
        # pre-fault-plane engine (locked by the chaos overhead leg).
        self.faults: Optional[FaultPlane] = None
        if faults is not None:
            if not isinstance(faults, FaultPlan):
                raise ValueError(
                    f"faults must be a FaultPlan or None, got {faults!r}"
                )
            self.faults = FaultPlane(faults, self.counters)
        # Reuse plane (DESIGN.md §12): evicted retired states spill into a
        # tiered artifact cache instead of being destroyed. Only meaningful
        # under epoch retention — refcount release never evicts.
        self.reuse: Optional[ReusePlane] = None
        if reuse_cache_budget is not None:
            if retention != "epoch":
                raise ValueError("reuse_cache_budget requires retention='epoch'")
            self.reuse = ReusePlane(
                self.cost_model,
                reuse_cache_budget,
                disk_budget=reuse_disk_budget,
                counters=self.counters,
                faults=self.faults,
            )
        elif reuse_disk_budget is not None:
            raise ValueError("reuse_disk_budget requires reuse_cache_budget")
        self.demand_cache: Dict = {}
        # Live-state generation counter (§10/§15): bumped whenever the
        # admission-visible indexes change (submission registers states /
        # rehydrates artifacts; release and eviction unregister them). The
        # AdmissionController memoizes per-arrival potentials on it, and the
        # batch planner's purity contract is scoped to one generation.
        self.state_gen = 0
        # §15 cohort admission context: non-None only while the batched
        # scheduler admits a >1-member cohort. Maps state_id -> list of
        # (eid, b_q, member) for extents cohort members registered this
        # decision step, so later members can attach deferred-represented
        # (grant + gate on the producer) instead of installing duplicate
        # residual producers. The greedy path never sets it.
        self.cohort_ctx: Optional[Dict[int, List]] = None
        self._domains: Dict[str, int] = {}
        self._next_state_id = 0
        self._agg_producers: Dict[int, SharedAggregateState] = {}  # member.mid -> agg
        # engine-scoped runtime-object ids (no class-counter leaks across
        # engine/session constructions — same fix class as PrefixState)
        self._next_mid = 0
        self._next_pid = 0
        self._next_sid = 0
        # §16 producer handoff: lens leases keep a dead query's attachment
        # (slot visibility + grants + ref) alive on the upstream states its
        # adopted replacement members still probe through ``lens_qid``.
        # (lens_qid, state_id) -> (state, {replacement members}); released
        # — detaching the dead lens — once every holder finishes.
        self._lens_leases: Dict[Tuple[int, int], Tuple[object, set]] = {}

        # clock is attached by the scheduler
        self.clock = None

    # -- helpers -------------------------------------------------------------
    def attach_shared(self, handle: QueryHandle, state: SharedHashBuildState) -> None:
        """Attach a query lens to a (possibly retired) shared hash state:
        the grafting admission path — revives retired states (§10)."""
        state.attach(handle.qid)
        handle.attached_states.append(state)
        self.lifecycle.revive(state)

    def next_member_id(self) -> int:
        self._next_mid += 1
        return self._next_mid

    def next_pipeline_id(self) -> int:
        self._next_pid += 1
        return self._next_pid

    def get_scan(self, table: str, qid: int) -> ScanNode:
        key = table if self.mode.share_scans else (table, qid)
        node = self.scans.get(key)
        if node is None:
            self._next_sid += 1
            node = ScanNode(
                self._next_sid,
                self.db[table],
                self.morsel_size,
                zone_maps=self.zone_maps,
                n_partitions=self.n_partitions,
            )
            self.scans[key] = node
        return node

    def new_hash_state(self, sig, join, did_domain: int) -> SharedHashBuildState:
        self._next_state_id += 1
        return SharedHashBuildState(
            self._next_state_id,
            sig,
            tuple(join.build_keys),
            tuple(join.payload),
            did_domain,
            counters=self.counters,
            n_partitions=self.n_partitions,
        )

    # -- submission (query grafting, §5.2) ------------------------------------
    def submit(self, query: Query) -> QueryHandle:
        tr = _trace.active
        if tr is not None:
            span = tr.open("engine.submit", query.qid)
        now = self.clock.now if self.clock is not None else query.arrival
        handle = QueryHandle(query, now)
        self.handles[query.qid] = handle
        self.active_handles.append(handle)
        self.counters["submitted"] += 1
        self._install_query(handle)
        if tr is not None:
            tr.close(span)
        return handle

    def _install_query(self, handle: QueryHandle) -> None:
        """Resolve one active handle's plan against the engine's current
        shared state: the grafting admission body of ``submit``, factored
        so unfolding (§16) can re-install a torn-down query under a
        temporary isolated-mode override."""
        query = handle.query
        scan, joins, agg, orderby = plan_spine(query.plan)
        handle.orderby = orderby

        # -- aggregate identity: observe or live-share one aggregate state
        agg_sig = aggregate_signature(agg)
        if agg_sig is not None and self.mode.agg_share != "none":
            existing = self.agg_index.get(agg_sig)
            if existing is None and self.reuse is not None and self.mode.agg_share == "full":
                # reuse plane (§12): an evicted-but-cached aggregate identity
                # rehydrates and the plan collapses onto it exactly as onto a
                # never-evicted retained identity
                existing = self.reuse.try_rehydrate_agg(
                    self, handle, query.plan, agg, agg_sig
                )
            if existing is not None and self._agg_attachable(existing):
                existing.attach(handle.qid)
                self.lifecycle.revive(existing)
                handle.agg_state = existing
                handle.agg_gate = AggGate(existing)
                self.counters["agg_attaches"] += 1
                for b in all_boundaries(query.plan):
                    d = estimate_demand(self, b.build)
                    self.counters["demand_rows"] += d
                    self.counters["eliminated_rows"] += d
                self.state_gen += 1
                self._maybe_complete(handle)
                return

        # -- per-boundary grafting admission (Algorithm 1), bottom-up
        ops: List[ProbeOp] = []
        gates = []
        stage_filters: Dict[int, List] = {}
        for stage, j in enumerate(joins):
            att = resolve_boundary(self, handle, j)
            gates.append(att.gate)
            out_names = j.payload_as if j.payload_as is not None else j.payload
            ops.append(
                ProbeOp(att.state, tuple(j.probe_keys), tuple(j.payload), tuple(out_names))
            )
            if j.post_filter is not TRUE:
                stage_filters.setdefault(stage, []).append(j.post_filter)

        # -- aggregate state (private; becomes shared under its identity)
        self._next_state_id += 1
        agg_state = SharedAggregateState(
            self._next_state_id,
            agg_sig,
            tuple(agg.group_keys),
            tuple(agg.aggs),
            counters=self.counters,
            n_partitions=self.n_partitions,
        )
        agg_state.attach(handle.qid)
        handle.agg_state = agg_state
        handle.agg_gate = AggGate(agg_state)
        if agg_sig is not None and self.mode.agg_share != "none":
            self.agg_index[agg_sig] = agg_state

        # -- main (state-consuming) pipeline + member
        pkey = ("main", scan.table, tuple(op.state.state_id for op in ops))
        if not self.mode.share_pipelines:
            pkey = pkey + (handle.qid,)
        pipeline = self.pipelines.get(pkey)
        if pipeline is None:
            pipeline = Pipeline(
                self.next_pipeline_id(),
                pkey,
                self.get_scan(scan.table, handle.qid),
                ops,
                counters=self.counters,
            )
            self.pipelines[pkey] = pipeline
        member = Member(
            self.next_member_id(),
            handle.qid,
            scan.pred,
            gates,
            sink=AggSink(agg_state, tuple(agg.group_keys), tuple(agg.aggs)),
            stage_filters=stage_filters,
            kind="main",
        )
        member.pipeline = pipeline
        pipeline.add_member(member)
        handle.members.append(member)
        self._agg_producers[member.mid] = agg_state

        self.state_gen += 1
        self.check_activations()

    def _agg_attachable(self, agg_state: SharedAggregateState) -> bool:
        share = self.mode.agg_share
        if share == "full":
            return True
        if share == "live":
            return not agg_state.complete
        if share == "qpipe":
            return agg_state.rows_consumed == 0 and not agg_state.complete
        return False

    # -- events ----------------------------------------------------------------
    def on_member_part_finished(self, pipeline: Pipeline, m: Member, part: int) -> None:
        """One scan partition of a member's delivery cycle completed: push
        the per-partition extent frontier (§9) of its build target."""
        if pipeline.build_target is not None and m.eid >= 0:
            pipeline.build_target.state.complete_extent_partition(
                m.eid, part, pipeline.source.n_partitions
            )

    def on_member_finished(self, pipeline: Pipeline, m: Member) -> None:
        pipeline.slots.release(m.mid)
        pipeline.release_member(m)  # drop its cohort gid maps (§11)
        if pipeline.build_target is not None:
            pipeline.build_target.state.complete_extent(m.eid)
            for g in m.waiting_gates:
                g.pending.discard(m)
        else:
            agg = self._agg_producers.get(m.mid)
            if agg is not None:
                agg.complete = True
        if pipeline.all_done():
            self.pipelines.pop(pipeline.key, None)
            pipeline.source.detach(pipeline)
        self._dirty = True

    _dirty = False

    def check_activations(self) -> None:
        if self._lens_leases:
            self._release_lens_leases()
        now = self.clock.now if self.clock is not None else 0.0
        for pipeline in list(self.pipelines.values()):
            for m in pipeline.members:
                if m.activatable():
                    m.active = True
                    m.received = 0
                    m.need = pipeline.source.n_morsels
                    m.part_received = np.zeros(pipeline.source.n_partitions, dtype=np.int64)
                    m.part_need = pipeline.source.part_counts.copy()
                    # barrier timestamp: a worker picking this member's
                    # fragment first advances to the activation time (§9
                    # max-at-barrier clock merge)
                    m.t_activated = now

    def sweep_completions(self) -> List[QueryHandle]:
        done: List[QueryHandle] = []
        for h in list(self.active_handles):
            if self._maybe_complete(h):
                done.append(h)
        return done

    def _maybe_complete(self, handle: QueryHandle) -> bool:
        if handle.done or handle.agg_gate is None or not handle.agg_gate.open():
            return False
        tr = _trace.active
        if tr is not None:
            span = tr.open("engine.complete", handle.qid)
        result = handle.agg_state.result()
        if handle.orderby is not None:
            result = _apply_orderby(result, handle.orderby)
        handle.result = result
        handle.t_complete = self.clock.now if self.clock is not None else 0.0
        handle.done = True
        self.active_handles.remove(handle)
        self.completed.append(handle)
        self.counters["completed"] += 1
        self._release(handle)
        if tr is not None:
            tr.close(span)
        return True

    def _release(self, handle: QueryHandle) -> None:
        """Release a completed query's lenses. ``retention='refcount'`` is
        the evaluated prototype's policy — drop operator state the moment no
        query references it; ``retention='epoch'`` retires zero-pin states
        for later grafts and enforces the memory budget (§10)."""
        for s in handle.attached_states:
            s.detach(handle.qid)
            if not s.refs:
                if self.retention == "epoch":
                    self.lifecycle.retire(s)
                else:
                    self._remove_from_indexes(s)
        agg = handle.agg_state
        if agg is not None:
            agg.detach(handle.qid)
            if not agg.refs and agg.sig is not None and self.agg_index.get(agg.sig) is agg:
                if self.retention == "epoch":
                    self.lifecycle.retire(agg)
                else:
                    self._remove_from_indexes(agg)
        if self.retention == "epoch":
            self.enforce_memory_budget()

    # -- fault tolerance: cancellation, handoff, quarantine, unfold (§16) ----
    def cancel_query(self, handle: QueryHandle, reason: str = "cancelled",
                     doomed: Optional[set] = None) -> bool:
        """Terminate one active query at a morsel boundary: hand its
        incomplete shared-state producers to surviving folded beneficiaries
        (or seal the state at its last complete extent), detach its lenses
        (detach-clears-visibility keeps retained rows sound, §10), and mark
        the handle with a terminal status. ``doomed`` widens the
        no-adoption set (Session.close cancels everything at once). Riders
        of an aggregate this query was producing unfold to isolated
        execution — no beneficiary is ever stranded."""
        if handle.done or handle.status != "active":
            return False
        dm = set(doomed) if doomed is not None else set()
        dm.add(handle.qid)
        riders = self._teardown(handle, dm)
        handle.status = reason
        if handle in self.active_handles:
            self.active_handles.remove(handle)
        self.counters["cancelled"] += 1
        if reason == "deadline":
            self.counters["deadline_cancellations"] += 1
        self.state_gen += 1
        for rh in riders:
            self.unfold(rh)
        if self.retention == "epoch":
            self.enforce_memory_budget()
        self.check_activations()
        return True

    def unfold(self, handle: QueryHandle) -> bool:
        """Degrade one active query to isolated execution (§16): tear down
        its folded plan — producers hand off to surviving beneficiaries
        exactly as under cancellation, so the cohort keeps its coverage —
        and re-install it under a private-everything isolated plan. The §4
        soundness argument is preserved trivially: the unfolded plan
        observes only states it produces itself."""
        if handle.done or handle.status != "active":
            return False
        riders = self._teardown(handle, {handle.qid})
        handle.degraded = True
        self.counters["unfolds"] += 1
        self._install_isolated(handle)
        self.state_gen += 1
        for rh in riders:
            self.unfold(rh)
        self.check_activations()
        return True

    def quarantine_state(self, state) -> int:
        """Tombstone one shared hash state after fault escalation (§16):
        every impacted active query is torn down (their producers on OTHER
        states still hand off to outside beneficiaries), the state dies
        through the §10 eviction path — but never spills into the reuse
        plane, its fragments are suspect — and the impacted queries unfold
        to isolated execution. A query that already unfolded once fails
        instead (bounded degradation ⇒ chaos runs terminate). Returns the
        number of impacted queries."""
        if state.quarantined or state.evicted:
            return 0
        state.quarantined = True
        impacted = [
            h for h in self.active_handles
            if not h.done and h.status == "active" and state in h.attached_states
        ]
        impacted.sort(key=lambda h: h.qid)
        doomed = {h.qid for h in impacted}
        riders: List[QueryHandle] = []
        for h in impacted:
            riders.extend(self._teardown(h, doomed))
        self.lifecycle.drop(state)
        state.evicted = True
        self._remove_from_indexes(state)
        self.counters["quarantined_states"] += 1
        self.state_gen += 1
        for h in impacted:
            if h.done or h.status != "active":
                continue
            if h.degraded:
                self.cancel_query(h, "failed")
            else:
                h.degraded = True
                self.counters["unfolds"] += 1
                self._install_isolated(h)
        for rh in riders:
            if rh.qid not in doomed:
                self.unfold(rh)
        self.check_activations()
        return len(impacted)

    def _install_isolated(self, handle: QueryHandle) -> None:
        """Re-install a torn-down handle under a temporary isolated-mode
        override: private scan, private pipelines, private states, private
        aggregate — no index registration, so nothing later folds onto a
        degraded execution."""
        prev = self.mode
        self.mode = MODES["isolated"]
        try:
            self._install_query(handle)
        finally:
            self.mode = prev

    def _teardown(self, handle: QueryHandle, doomed: set) -> List[QueryHandle]:
        """Dismantle one active handle's execution. ``doomed`` is the set of
        qids dying in this event — adoption never targets them. Returns the
        surviving riders of an aggregate this handle was producing (the
        caller unfolds them once its own teardown settles)."""
        replaced: Dict[int, Member] = {}
        agg = handle.agg_state
        was_producer = agg is not None and any(
            self._agg_producers.get(m.mid) is agg and not m.done
            for m in handle.members
        )
        # outermost first (members are appended bottom-up): a downstream
        # producer adopts its doomed upstream chain before the loop reaches
        # those upstream members, so they are never wrongly sealed
        for m in reversed(list(handle.members)):
            if m.done:
                self._agg_producers.pop(m.mid, None)
                continue
            self._retire_member(m, doomed, replaced)
        # lens-owner tagging is only needed on target states a replacement
        # actually probes through the dead lens (= the leased states, all
        # registered by now); everywhere else it would re-allocate the dead
        # query a visibility slot at sink time and leak it
        for m2 in replaced.values():
            lq = m2.lens_qid
            tgt = m2.pipeline.build_target.state
            if lq in m2.beneficiaries and (lq, tgt.state_id) not in self._lens_leases:
                m2.beneficiaries.remove(lq)
        handle.members = []
        for s in list(handle.attached_states):
            if (handle.qid, s.state_id) in self._lens_leases:
                # a replacement member probes this state through the dying
                # query's lens: keep the attachment (slot, vis, grants, ref)
                # alive — the lease release detaches it once the
                # replacement finishes
                continue
            s.detach(handle.qid)
            if s.quarantined or s.evicted:
                continue
            if not s.refs:
                if self.retention == "epoch":
                    self.lifecycle.retire(s)
                else:
                    self._remove_from_indexes(s)
        handle.attached_states = []
        riders: List[QueryHandle] = []
        if agg is not None:
            agg.detach(handle.qid)
            if was_producer and not agg.complete:
                # the shared aggregate lost its producer mid-accumulation:
                # partial sums can never complete and redelivery would
                # double-count, so the identity leaves the index and its
                # surviving riders unfold
                self._remove_from_indexes(agg)
                for q in sorted(agg.refs):
                    if q in doomed:
                        continue
                    rh = self.handles.get(q)
                    if rh is not None and not rh.done and rh.status == "active":
                        riders.append(rh)
            if not agg.refs and agg.sig is not None and self.agg_index.get(agg.sig) is agg:
                if self.retention == "epoch":
                    self.lifecycle.retire(agg)
                else:
                    self._remove_from_indexes(agg)
            handle.agg_state = None
            handle.agg_gate = None
        return riders

    def _retire_member(self, m: Member, doomed: set, replaced: Dict[int, Member]) -> None:
        """Remove one incomplete member of a dying/unfolding query. A
        state-producing member with surviving beneficiaries is adopted
        (producer handoff); with none, its incomplete extent is voided —
        the state seals at its last complete extent."""
        pipeline = m.pipeline
        bt = pipeline.build_target if pipeline is not None else None
        if bt is not None:
            state = bt.state
            survivors = []
            for g in m.waiting_gates:
                if m not in g.pending or g.owner_qid is None or g.owner_qid in doomed:
                    continue
                oh = self.handles.get(g.owner_qid)
                if oh is None or oh.done or oh.status != "active":
                    continue
                survivors.append(g)
            m2 = replaced.get(m.mid)
            if m2 is None and survivors and not state.quarantined:
                adopter = self.handles[min(g.owner_qid for g in survivors)]
                m2 = self._adopt_producer(m, adopter, doomed, replaced)
                self.counters["producer_handoffs"] += 1
            if m2 is not None:
                for g in survivors:
                    g.pending.discard(m)
                    if m2 not in g.pending:
                        g.pending.add(m2)
                        m2.waiting_gates.append(g)
            else:
                for g in m.waiting_gates:
                    g.pending.discard(m)
                if not state.quarantined:
                    state.void_extent(m.eid)
        else:
            for g in m.waiting_gates:
                g.pending.discard(m)
        self._drop_member(m)

    def _adopt_producer(self, m: Member, adopter: QueryHandle, doomed: set,
                        replaced: Dict[int, Member]) -> Member:
        """Producer handoff (§16): the surviving beneficiary ``adopter``
        re-installs the doomed member's delivery obligation as its own.
        The replacement reuses the SAME extent id — redelivery of the full
        scan cycle dedups through ``insert_or_mark`` (existing rows are
        re-marked under the adopter's visibility bit, the extent's
        provenance bit is unchanged for every grant holder) and
        ``Gate.open`` re-proves coverage at completion, so adoption is
        sound and deterministic. Upstream gates are cloned for the adopter;
        doomed upstream producers are adopted recursively.

        The replacement probes upstream states through the DEAD query's
        lens (``lens_qid``): the adopter typically holds no slot or grant
        on the producer's upstream states, and any grant it does hold
        scopes a different visible set — only the dead lens reproduces the
        dead member's rows exactly. A lens lease keeps the dead query
        attached to those states until every replacement holding the lens
        finishes. The lens owner also stays a beneficiary so that sibling
        replacements downstream (which probe through the same dead lens)
        observe rows this replacement redelivers."""
        existing = replaced.get(m.mid)
        if existing is not None:
            return existing
        pipeline = m.pipeline
        state = pipeline.build_target.state
        new_gates = []
        for g in m.gates:
            if g.open():
                new_gates.append(g)  # immutable once open: share it
                continue
            g2 = Gate(g.state, g.conj, g.allowed_emask)
            g2.owner_qid = adopter.qid
            for p in sorted(g.pending, key=lambda x: x.mid):
                if p.qid in doomed and not p.done:
                    p2 = self._adopt_producer(p, adopter, doomed, replaced)
                    if p2 not in g2.pending:
                        g2.pending.add(p2)
                        p2.waiting_gates.append(g2)
                else:
                    g2.pending.add(p)
                    p.waiting_gates.append(g2)
            if g.state not in adopter.attached_states:
                self.attach_shared(adopter, g.state)
            new_gates.append(g2)
        benes = [q for q in m.beneficiaries if q not in doomed]
        if adopter.qid not in benes:
            benes.append(adopter.qid)
        if m.lens_qid not in benes:
            benes.append(m.lens_qid)
        m2 = Member(
            self.next_member_id(),
            adopter.qid,
            m.pred,
            new_gates,
            sink=None,
            stage_filters=m.stage_filters,
            kind=m.kind,
            eid=m.eid,
            conj=m.conj,
            beneficiaries=benes,
        )
        m2.waiting_gates = []
        m2.pipeline = pipeline
        m2.lens_qid = m.lens_qid
        pipeline.add_member(m2)
        adopter.members.append(m2)
        if state not in adopter.attached_states:
            self.attach_shared(adopter, state)
        for op in pipeline.ops:
            key = (m2.lens_qid, op.state.state_id)
            lease = self._lens_leases.get(key)
            if lease is None:
                self._lens_leases[key] = (op.state, {m2})
            else:
                lease[1].add(m2)
        replaced[m.mid] = m2
        return m2

    def _drop_member(self, m: Member) -> None:
        """Physically remove one member from its pipeline (empty pipelines
        die and detach from their scan, exactly as at completion)."""
        pipeline = m.pipeline
        self._agg_producers.pop(m.mid, None)
        if pipeline is not None and m in pipeline.members:
            pipeline.slots.release(m.mid)
            pipeline.release_member(m)
            pipeline.members.remove(m)
            if not pipeline.members:
                self.pipelines.pop(pipeline.key, None)
                pipeline.source.detach(pipeline)
        m.done = True
        m.active = False

    def _release_lens_leases(self) -> None:
        """Drop lens leases whose replacement members all finished (§16):
        detach the dead query's lens from the upstream state — clearing its
        visibility bit before the slot recycles, exactly as a live detach
        would — and retire the state if nothing else references it."""
        for key in list(self._lens_leases):
            state, members = self._lens_leases[key]
            live = {m for m in members if not m.done}
            if live:
                self._lens_leases[key] = (state, live)
                continue
            del self._lens_leases[key]
            state.detach(key[0])
            if state.quarantined or state.evicted:
                continue
            if not state.refs:
                if self.retention == "epoch":
                    self.lifecycle.retire(state)
                else:
                    self._remove_from_indexes(state)

    # -- lifecycle: eviction + memory accounting (§10) -----------------------
    def _remove_from_indexes(self, state) -> None:
        """Unregister a state from every admission-visible index — the one
        place refcount release and eviction share, so the invalidation rule
        cannot diverge between the two paths."""
        self.state_gen += 1
        if isinstance(state, SharedHashBuildState):
            lst = self.state_index.get(state.sig)
            if lst and state in lst:
                lst.remove(state)
            # drop stale qpipe registry entries targeting this state
            for k, (m, st) in list(self.qpipe_registry.items()):
                if st is state:
                    self.qpipe_registry.pop(k, None)
        else:
            if state.sig is not None and self.agg_index.get(state.sig) is state:
                self.agg_index.pop(state.sig, None)

    def enforce_memory_budget(self, budget: Optional[int] = None) -> int:
        """Evict retired states oldest-epoch-first until the retained bytes
        fit the budget (default: the configured ``memory_budget``; pass 0 to
        force-evict everything retired). Returns states evicted."""
        victims = self.lifecycle.victims(budget)
        for v in victims:
            self._evict(v)
        self._note_memory()
        return len(victims)

    def _evict(self, state) -> None:
        """Reclaim one retired state: only legal at zero pins — a live or
        admissible lens can never lose fragments it may still observe."""
        if not state.evictable:
            raise RuntimeError(
                f"evicting pinned state #{state.state_id}: "
                f"refs={state.refs} pins={state.pins}"
            )
        self.counters["evictions"] += 1
        self.counters["evicted_bytes"] += state.nbytes()
        if self.reuse is not None:
            # spill instead of destroy (§12): serialize the victim into the
            # artifact cache before tombstoning. The live object still dies
            # — §10's no-lens-observes-evicted invariant is untouched.
            self.reuse.spill(state)
        self.lifecycle.drop(state)
        state.evicted = True
        self._remove_from_indexes(state)

    def state_bytes(self) -> int:
        """Resident bytes of every live + retired shared state."""
        total = sum(s.nbytes() for lst in self.state_index.values() for s in lst)
        total += sum(a.nbytes() for a in self.agg_index.values())
        return total

    def _note_memory(self) -> None:
        """Refresh the memory gauges + high-water marks (epoch retention)."""
        rb = self.lifecycle.retired_bytes()
        self.counters["retained_bytes"] = rb
        if rb > self.counters["retained_high_water_bytes"]:
            self.counters["retained_high_water_bytes"] = rb
        tb = self.state_bytes()
        self.counters["state_bytes"] = tb
        if tb > self.counters["mem_high_water_bytes"]:
            self.counters["mem_high_water_bytes"] = tb

    # -- introspection -----------------------------------------------------------
    def has_active_work(self) -> bool:
        return bool(self.active_handles)

    def stats(self) -> Dict[str, float]:
        out = dict(self.counters)
        out["live_states"] = sum(len(v) for v in self.state_index.values())
        out["live_agg_states"] = len(self.agg_index)
        out["retained_states"] = len(self.lifecycle.retired)
        out["retention"] = self.retention
        out["cached_artifacts"] = len(self.reuse.store) if self.reuse is not None else 0
        out["mesh_data_shards"] = (
            self.mesh_plan.n_shards if self.mesh_plan is not None else 0
        )
        return out


def _apply_orderby(result: Dict[str, np.ndarray], ob: OrderBy) -> Dict[str, np.ndarray]:
    if not result:
        return result
    n = len(next(iter(result.values())))
    if n == 0:
        return result
    cols = []
    for k, asc in zip(reversed(ob.keys), reversed(ob.ascending)):
        c = result[k]
        cols.append(c if asc else -c)
    order = np.lexsort(cols) if cols else np.arange(n)
    if ob.limit is not None:
        order = order[: ob.limit]
    return {k: v[order] for k, v in result.items()}
