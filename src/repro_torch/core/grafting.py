"""Query grafting: admission of an arriving query onto shared state (§5).

``admit_boundary`` mirrors Algorithm 1: for one stateful boundary and one
candidate state it either rejects the candidate, leaves the boundary as
ordinary-plan work, or installs a state-ref edge (a Gate) over the
represented ∪ residual extents, plus residual producer members and
ordinary-plan assignments. ``resolve_boundary`` drives it per boundary,
recursing bottom-up through the build subtree so that producer paths are
themselves admitted (AdmissibleProducerPaths).

The partition of the state-side extent (PartitionStateExtent):

* represented — proven by predicate containment against coverage restricted
  to provenance extents that imply the non-retained part of B_q (§4.2
  evaluability + §4.3 extent-scoped state-level visibility),
* residual — a producer member installed on the (shared, cyclic) source
  scan, gated on its own upstream state-refs,
* unattached — ordinary-plan work: a fresh state (which immediately becomes
  shared state itself) plus an ordinary producer member.

Unproven obligations (predicates outside the fragment, non-evaluable lens
predicates) only ever lose sharing — they fall to residual/ordinary paths
whose per-row visibility tagging is semantics-preserving by construction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .descriptors import StateSignature, hash_build_signature
from .plans import Aggregate, HashJoin, OrderBy, PlanNode, Scan, collect_subtree_pred
from .predicates import Conjunction, evaluate
from .runtime import (
    ALL_EXTENTS,
    BuildTarget,
    Gate,
    Member,
    Pipeline,
    ProbeOp,
    encode_keys,
)
from .state import SharedHashBuildState

# ---------------------------------------------------------------------------
# Plan walking
# ---------------------------------------------------------------------------


def plan_spine(plan: PlanNode) -> Tuple[Scan, List[HashJoin], Aggregate, Optional[OrderBy]]:
    """Decompose a query plan into probe-side spine scan, the hash-join
    boundaries bottom-up, the aggregate, and the final order-by."""
    node = plan
    ob = None
    if isinstance(node, OrderBy):
        ob, node = node, node.input
    if not isinstance(node, Aggregate):
        raise TypeError("plan must end in an Aggregate")
    agg, node = node, node.input
    joins: List[HashJoin] = []
    while isinstance(node, HashJoin):
        joins.append(node)
        node = node.probe
    if not isinstance(node, Scan):
        raise TypeError("plan spine must bottom out at a Scan")
    joins.reverse()
    return node, joins, agg, ob


def build_spine(subtree: PlanNode) -> Tuple[Scan, List[HashJoin]]:
    """Probe-side spine of a build subtree (its producer path skeleton)."""
    node = subtree
    joins: List[HashJoin] = []
    while isinstance(node, HashJoin):
        joins.append(node)
        node = node.probe
    if not isinstance(node, Scan):
        raise TypeError("build subtree must bottom out at a Scan")
    joins.reverse()
    return node, joins


def all_boundaries(plan: PlanNode) -> List[HashJoin]:
    """Every stateful hash-build boundary in the plan (spine + nested)."""
    out: List[HashJoin] = []

    def walk(node: PlanNode):
        if isinstance(node, (Aggregate, OrderBy)):
            walk(node.input)
        elif isinstance(node, HashJoin):
            out.append(node)
            walk(node.build)
            walk(node.probe)

    walk(plan)
    return out


# ---------------------------------------------------------------------------
# Isolated-plan demand estimation (counters for the Fig.9c decomposition)
# ---------------------------------------------------------------------------


def estimate_demand(engine, node: PlanNode) -> int:
    """Rows an isolated execution would feed into the hash-build at this
    subtree's enclosing boundary = |sigma(build subtree)|."""
    count, _ = _subtree_count(engine, node, need_keys=None)
    return count


def _subtree_count(engine, node: PlanNode, need_keys: Optional[Tuple[str, ...]]):
    key = (id(node.__class__), _node_cache_key(node), need_keys)
    cached = engine.demand_cache.get(key)
    if cached is not None:
        return cached
    if isinstance(node, Scan):
        table = engine.db[node.table]
        mask = evaluate(node.pred, table.columns)
        count = int(mask.sum())
        keys = None
        if need_keys:
            keys = np.unique(
                encode_keys({a: table.columns[a][mask] for a in need_keys}, need_keys)
            )
        result = (count, keys)
    elif isinstance(node, HashJoin):
        _, inner_keys = _subtree_count(engine, node.build, tuple(node.build_keys))
        pt = _probe_side_table(engine, node)
        # probe-side scan pred then semijoin against the build-side key set
        scan, _joins = build_spine(node)
        mask = evaluate(scan.pred, pt.columns)
        codes = encode_keys(
            {a: pt.columns[a][mask] for a in node.probe_keys}, tuple(node.probe_keys)
        )
        sem = np.isin(codes, inner_keys)
        count = int(sem.sum())
        keys = None
        if need_keys:
            kcodes = encode_keys(
                {a: pt.columns[a][mask][sem] for a in need_keys}, need_keys
            )
            keys = np.unique(kcodes)
        result = (count, keys)
    else:
        raise TypeError(node)
    engine.demand_cache[key] = result
    return result


def demand_keycodes(engine, node: PlanNode, key_attrs: Tuple[str, ...]) -> np.ndarray:
    """Per-row key codes (``key_attrs``) of every row an isolated execution
    would feed into the enclosing boundary's hash build — the non-unique
    companion of ``estimate_demand`` (len(codes) == demand). EXPLAIN GRAFT
    splits these by ``key_partition`` for the per-partition demand
    accounting (DESIGN.md §9)."""
    key = ("demand_codes", id(node.__class__), _node_cache_key(node), key_attrs)
    cached = engine.demand_cache.get(key)
    if cached is not None:
        return cached
    if isinstance(node, Scan):
        table = engine.db[node.table]
        mask = evaluate(node.pred, table.columns)
        codes = encode_keys({a: table.columns[a][mask] for a in key_attrs}, key_attrs)
    elif isinstance(node, HashJoin):
        _, inner_keys = _subtree_count(engine, node.build, tuple(node.build_keys))
        pt = _probe_side_table(engine, node)
        scan, _joins = build_spine(node)
        mask = evaluate(scan.pred, pt.columns)
        pcodes = encode_keys(
            {a: pt.columns[a][mask] for a in node.probe_keys}, tuple(node.probe_keys)
        )
        sem = np.isin(pcodes, inner_keys)
        codes = encode_keys({a: pt.columns[a][mask][sem] for a in key_attrs}, key_attrs)
    else:
        raise TypeError(node)
    engine.demand_cache[key] = codes
    return codes


def graft_potential(engine, query) -> float:
    """Fraction of the query's isolated-plan demand that would ride existing
    shared state if admitted right now (the admission controller's
    cost-model signal, §10).

    1.0 when the whole plan collapses onto an attachable shared aggregate
    (exact identity); otherwise the demand-weighted share of stateful
    boundaries with a live or retained candidate state under the exact
    signature (represented and residual attachment both count — either way
    the boundary's build work rides the shared execution). Read-only and
    cached through ``engine.demand_cache`` like EXPLAIN GRAFT."""
    from .descriptors import aggregate_signature, hash_build_signature

    scan, joins, agg, _ = plan_spine(query.plan)
    agg_sig = aggregate_signature(agg)
    if agg_sig is not None and engine.mode.agg_share != "none":
        existing = engine.agg_index.get(agg_sig)
        if existing is not None and engine._agg_attachable(existing):
            return 1.0
    if not engine.mode.share_state:
        return 0.0
    total = shared = 0
    for j in all_boundaries(query.plan):
        d = estimate_demand(engine, j.build)
        total += d
        if engine.state_index.get(hash_build_signature(j)):
            shared += d
    return shared / total if total else 0.0


def candidate_states(engine, query) -> List:
    """The shared states an admission of ``query`` would select right now —
    the admission controller pins these for deferred-but-admissible
    arrivals so the evictor cannot reclaim coverage a queued lens is
    waiting to observe (§10). Read-only; mirrors the signature selection of
    ``resolve_boundary`` and the aggregate-identity attach."""
    from .descriptors import aggregate_signature, hash_build_signature

    out: List = []
    _, _, agg, _ = plan_spine(query.plan)
    agg_sig = aggregate_signature(agg)
    if agg_sig is not None and engine.mode.agg_share != "none":
        existing = engine.agg_index.get(agg_sig)
        if existing is not None and engine._agg_attachable(existing):
            out.append(existing)
    if engine.mode.share_state:
        for j in all_boundaries(query.plan):
            lst = engine.state_index.get(hash_build_signature(j))
            if lst:
                out.append(lst[0])
    return out


def boundary_key(join: HashJoin) -> Tuple[StateSignature, Optional[Conjunction]]:
    """The (signature, build-predicate) pair grafting admission matches on.
    Shared by ``resolve_boundary`` and the §15 batch planner so the two can
    never diverge on what boundary compatibility means."""
    return hash_build_signature(join), Conjunction.from_pred(collect_subtree_pred(join.build))


def coverage_probe(engine, sig: StateSignature, b_q: Optional[Conjunction], demand: int) -> Tuple[bool, int]:
    """Read-only represented-extent probe: what the first live candidate
    under ``sig`` would grant a boundary with build predicate ``b_q`` right
    now, as ``(fully_covered, granted_rows)`` with ``granted_rows`` clamped
    to the boundary's isolated demand. Mirrors the resolve_boundary ladder
    without attaching, installing producers, or rehydrating — the §15 batch
    planner scores cohorts with it."""
    mode = engine.mode
    if not mode.share_state or not mode.allow_represented or b_q is None:
        return False, 0
    candidate = None
    for s in engine.state_index.get(sig, ()):
        candidate = s
        break
    if candidate is None:
        return False, 0
    retained = candidate.retained_attrs
    b_ret = Conjunction({a: c for a, c in b_q.constraints.items() if a in retained})
    b_nonret = Conjunction({a: c for a, c in b_q.constraints.items() if a not in retained})
    allowed = ALL_EXTENTS if not b_nonret.constraints else candidate.allowed_extents_for(b_nonret)
    if not allowed:
        return False, 0
    if candidate.covers_with(b_q, allowed):
        return True, demand
    return False, min(int(candidate.count_granted(allowed, b_ret)), demand)


def _probe_side_table(engine, join: HashJoin):
    scan, _ = build_spine(join)
    return engine.db[scan.table]


def _node_cache_key(node: PlanNode):
    from .plans import strip_pred_subtree
    from .predicates import Conjunction

    conj = Conjunction.from_pred(collect_subtree_pred(node))
    return (strip_pred_subtree(node), conj.key() if conj is not None else id(node))


# ---------------------------------------------------------------------------
# Boundary attachment result
# ---------------------------------------------------------------------------


@dataclass
class Attachment:
    state: SharedHashBuildState
    gate: Gate
    created: bool  # state freshly created (ordinary-plan work)
    producer_member: Optional[Member] = None


# ---------------------------------------------------------------------------
# Algorithm 1 — AdmitBoundary / PartitionStateExtent
# ---------------------------------------------------------------------------


def resolve_boundary(engine, handle, join: HashJoin) -> Attachment:
    """Resolve one stateful boundary of query ``handle`` bottom-up:
    select-or-create the shared state, partition the state-side extent, and
    install producer obligations and the state-readiness gate."""
    qid = handle.qid
    mode = engine.mode
    sig, b_q = boundary_key(join)

    # counters: isolated-plan demand at this boundary
    demand = estimate_demand(engine, join.build)
    engine.counters["demand_rows"] += demand

    # -- CheckLensCompatibility: exact non-predicate identity via signature
    candidate: Optional[SharedHashBuildState] = None
    if mode.share_state:
        for s in engine.state_index.get(sig, ()):  # exact signature match
            candidate = s
            break
        if candidate is None and mode.allow_represented and engine.reuse is not None:
            # reuse plane (§12): no live candidate — a cached artifact under
            # the same signature may rehydrate (cost-gated). The rehydrated
            # state registers under the signature and the ladder below
            # treats it exactly like a never-evicted retained state.
            candidate = engine.reuse.try_rehydrate_hash(engine, handle, sig, b_q, demand)

    # -- Represented extent: proven containment against allowed coverage
    if candidate is not None and mode.allow_represented and b_q is not None:
        retained = candidate.retained_attrs
        b_ret = Conjunction(
            {a: c for a, c in b_q.constraints.items() if a in retained}
        )
        b_nonret = Conjunction(
            {a: c for a, c in b_q.constraints.items() if a not in retained}
        )
        if not b_nonret.constraints:
            allowed = ALL_EXTENTS
        else:
            allowed = candidate.allowed_extents_for(b_nonret)
        # §15 deferred representation: extents cohort-mates registered at
        # this decision step but have not produced yet. Only the batched
        # admission path populates cohort_ctx, so greedy admission never
        # takes this branch.
        pend_mask = np.uint64(0)
        pend_members: List[Member] = []
        pend_conjs: List[Conjunction] = []
        if engine.cohort_ctx is not None:
            for p_eid, p_conj, p_member in engine.cohort_ctx.get(
                candidate.state_id, ()
            ):
                if not b_nonret.constraints or p_conj.implies(b_nonret):
                    pend_mask |= np.uint64(1) << np.uint64(p_eid)
                    pend_members.append(p_member)
                    pend_conjs.append(p_conj)
        if allowed and candidate.covers_with(b_q, allowed):
            # Fully represented: state-ref edge only, gate open now.
            engine.attach_shared(handle, candidate)
            candidate.add_grant(qid, allowed, b_ret)
            engine.counters["represented_rows"] += candidate.count_granted(allowed, b_ret)
            # upstream producer work eliminated by this state-lens obs.
            for up in all_boundaries(join.build):
                d = estimate_demand(engine, up.build)
                engine.counters["demand_rows"] += d
                engine.counters["eliminated_rows"] += d
            gate = Gate(candidate, b_q, allowed)
            gate.owner_qid = qid
            return Attachment(candidate, gate, created=False)
        if pend_mask and candidate.covers_with_pending(b_q, allowed, pend_conjs):
            # Fully represented once the cohort-mates' producers complete:
            # grant the pending provenance bits now, gate on the producers.
            # No producer of our own — this is the §15 win: the narrower
            # member rides the state a wider member is about to build
            # instead of re-delivering its own extent. ``Gate.open``
            # re-proves coverage against the completed extents, so a
            # producer that under-delivers can never unblock us unsoundly.
            engine.attach_shared(handle, candidate)
            candidate.add_grant(qid, allowed | pend_mask, b_ret)
            engine.counters["represented_rows"] += candidate.count_granted(allowed, b_ret)
            for up in all_boundaries(join.build):
                d = estimate_demand(engine, up.build)
                engine.counters["demand_rows"] += d
                engine.counters["eliminated_rows"] += d
            gate = Gate(candidate, b_q, allowed | pend_mask)
            gate.owner_qid = qid
            for p_member in pend_members:
                gate.pending.add(p_member)
                p_member.waiting_gates.append(gate)
            return Attachment(candidate, gate, created=False)
        if allowed:
            # Partially represented: grant what is covered, install a
            # residual producer for the rest (its extent bit joins the
            # allowed set so the gate can open on its completion).
            engine.attach_shared(handle, candidate)
            candidate.add_grant(qid, allowed, b_ret)
            engine.counters["represented_rows"] += candidate.count_granted(allowed, b_ret)
            member, eid = _install_producer(engine, handle, join, candidate, b_q, kind="residual")
            _record_cohort_extent(engine, candidate, eid, b_q, member)
            if eid >= 0:
                gate_allowed = allowed | (np.uint64(1) << np.uint64(eid))
                gate = Gate(candidate, b_q, gate_allowed)
            else:
                # provenance bits exhausted (long-retained state, §10): the
                # residual producer re-delivers every B_q row under the
                # query's own visibility bit, so its completion alone is a
                # sound gate — only coverage-based accounting is lost.
                gate = Gate(candidate, None)
            gate.owner_qid = qid
            gate.pending.add(member)
            member.waiting_gates.append(gate)
            return Attachment(candidate, gate, created=False, producer_member=member)

    # -- Residual-only attachment (no coverage observation)
    if candidate is not None and mode.allow_residual:
        engine.attach_shared(handle, candidate)
        member, eid = _install_producer(engine, handle, join, candidate, b_q, kind="residual")
        _record_cohort_extent(engine, candidate, eid, b_q, member)
        gate = Gate(candidate, None)  # own producer completion suffices
        gate.owner_qid = qid
        gate.pending.add(member)
        member.waiting_gates.append(gate)
        return Attachment(candidate, gate, created=False, producer_member=member)

    # -- QPipe-OSP: merge identical in-flight profiles (no coverage logic)
    if mode.qpipe and candidate is None:
        att = _qpipe_try_merge(engine, handle, join, sig, b_q)
        if att is not None:
            return att

    # -- Ordinary-plan work: fresh state (which becomes shared state itself)
    state = engine.new_hash_state(sig, join, did_domain=_did_domain(engine, join.build))
    state.attach(qid)
    handle.attached_states.append(state)
    if mode.share_state:
        engine.state_index.setdefault(sig, []).append(state)
    member, eid = _install_producer(engine, handle, join, state, b_q, kind="ordinary")
    _record_cohort_extent(engine, state, eid, b_q, member)
    gate = Gate(state, None)
    gate.owner_qid = qid
    gate.pending.add(member)
    member.waiting_gates.append(gate)
    if mode.qpipe:
        engine.qpipe_registry[_qpipe_key(sig, join, b_q)] = (member, state)
    return Attachment(state, gate, created=True, producer_member=member)


def _record_cohort_extent(engine, state, eid: int, b_q, member) -> None:
    """§15: while a batched cohort admission is in flight, expose this
    producer's registered extent to later cohort members so they can attach
    deferred-represented instead of installing duplicate producers."""
    if engine.cohort_ctx is not None and eid >= 0 and b_q is not None:
        engine.cohort_ctx.setdefault(state.state_id, []).append((eid, b_q, member))


def _install_producer(
    engine, handle, join: HashJoin, state: SharedHashBuildState, b_q, kind: str
) -> Tuple[Member, int]:
    """Install residual/ordinary producer edges: a member on the (shared)
    build pipeline targeting ``state``, gated on its own upstream
    state-refs (AdmissibleProducerPaths — recursion admits the upstream
    boundaries first)."""
    scan, inner_joins = build_spine(join.build)
    inner_ops: List[ProbeOp] = []
    inner_gates: List[Gate] = []
    stage_filters: Dict[int, List] = {}
    for stage, ij in enumerate(inner_joins):
        att = resolve_boundary(engine, handle, ij)  # bottom-up recursion
        inner_gates.append(att.gate)
        out_names = ij.payload_as if ij.payload_as is not None else ij.payload
        inner_ops.append(
            ProbeOp(att.state, tuple(ij.probe_keys), tuple(ij.payload), tuple(out_names))
        )
        from .predicates import TRUE

        if ij.post_filter is not TRUE:
            stage_filters.setdefault(stage, []).append(ij.post_filter)

    pkey = ("build", scan.table, tuple(op.state.state_id for op in inner_ops), state.state_id)
    if not engine.mode.share_pipelines:
        pkey = pkey + (handle.qid,)
    pipeline = engine.pipelines.get(pkey)
    if pipeline is None:
        pipeline = Pipeline(
            engine.next_pipeline_id(),
            pkey,
            engine.get_scan(scan.table, handle.qid),
            inner_ops,
            build_target=BuildTarget(state, tuple(join.build_keys)),
            compose_did=bool(inner_ops),
            counters=engine.counters,
        )
        engine.pipelines[pkey] = pipeline

    eid = state.register_extent(b_q)
    member = Member(
        engine.next_member_id(),
        handle.qid,
        scan.pred,
        inner_gates,
        sink=None,
        stage_filters=stage_filters,
        kind=kind,
        eid=eid,
        conj=b_q,
    )
    member.waiting_gates = []
    member.pipeline = pipeline
    pipeline.add_member(member)
    handle.members.append(member)
    return member, eid


def _did_domain(engine, subtree: PlanNode) -> int:
    if isinstance(subtree, Scan):
        return engine.db[subtree.table].nrows
    if isinstance(subtree, HashJoin):
        scan, joins = build_spine(subtree)
        d = engine.db[scan.table].nrows
        for j in joins:
            d *= _did_domain(engine, j.build)
        return d
    raise TypeError(subtree)


# ---------------------------------------------------------------------------
# QPipe-OSP merge: identical operator profiles, in-flight, zero progress
# ---------------------------------------------------------------------------


def _qpipe_key(sig: StateSignature, join: HashJoin, b_q):
    from .plans import strip_pred_subtree

    pred_key = b_q.key() if b_q is not None else repr(collect_subtree_pred(join.build))
    return (sig, pred_key)


def _qpipe_try_merge(engine, handle, join, sig, b_q) -> Optional[Attachment]:
    entry = engine.qpipe_registry.get(_qpipe_key(sig, join, b_q))
    if entry is None:
        return None
    member, state = entry
    if member.done or member.received > 0 or state.n_entries > 0:
        return None  # OSP window closed — only near-simultaneous arrivals merge
    # Merge: the existing physical producer also tags this query's bit.
    engine.attach_shared(handle, state)
    member.beneficiaries.append(handle.qid)
    gate = Gate(state, None)
    gate.owner_qid = handle.qid
    gate.pending.add(member)
    member.waiting_gates.append(gate)
    engine.counters["qpipe_merges"] += 1
    return Attachment(state, gate, created=False, producer_member=None)
