"""Graft-aware batch planning (DESIGN.md §15).

Greedy grafting admits one arrival at a time: each queued query matches
against live state as-is, so two queued queries that could share a scan or
a hash build are folded independently. When the admission path holds
several due arrivals at one decision step, ``plan_cohort`` plans them
jointly over (queued demand × live state): it groups compatible scans,
detects intra-cohort providers — a member whose build extent contains
another member's build predicate, or whose aggregate identity other
members share — and orders the cohort provider-first so the narrower
members attach fully represented to state the wider member is about to
produce, instead of each installing its own residual producer.

Purity contract (the §10/§14 determinism invariants depend on it):

* ``plan_cohort`` is a pure function of (engine state, query set). It
  reads ``state_index`` / ``agg_index`` / the demand cache and mutates
  nothing — no attachment, no rehydration, no pipelines. Calling it twice
  on the same snapshot returns the same plan.
* The plan is invariant under permutation of the input order: members are
  canonicalized by ``(arrival, qid)`` before scoring, and every ordering
  key is an intrinsic property of the (snapshot, member) pair.
* Coverage never regresses: each member's planned coverage is scored
  against the live snapshot PLUS the extents earlier cohort members will
  register, so planned coverage >= the per-query greedy snapshot coverage
  by construction (the metamorphic suite pins this).

The planner scores with the same read-only ladder ``resolve_boundary``
admits with (``grafting.coverage_probe``), so "compatible" cannot drift
between planning and admission. Reuse-plane rehydration is intentionally
not simulated — it mutates the store, and the admission path performs it
identically in any order.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .descriptors import StateSignature, aggregate_signature
from .grafting import boundary_key, build_spine, coverage_probe, estimate_demand, plan_spine
from .plans import PlanNode, Query
from .predicates import Conjunction

# ---------------------------------------------------------------------------
# Read-only profiles of queued demand
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BoundaryProfile:
    """One stateful boundary of a queued plan: the (signature, build
    predicate) pair admission matches on, its isolated-plan demand, and the
    boundaries nested inside its build subtree (eliminated wholesale when
    this boundary attaches fully represented)."""

    sig: StateSignature
    b_q: Optional[Conjunction]
    demand: int
    children: Tuple["BoundaryProfile", ...] = ()

    @property
    def total(self) -> int:
        """Demand of this boundary plus everything a full-represented
        attachment here eliminates upstream."""
        return self.demand + sum(c.total for c in self.children)

    def flat(self) -> List["BoundaryProfile"]:
        out = [self]
        for c in self.children:
            out.extend(c.flat())
        return out


@dataclass(frozen=True)
class QueryProfile:
    """Everything the planner needs to know about one queued arrival,
    derived read-only from its plan + the engine's demand cache."""

    qid: int
    arrival: float
    template: str
    scan_table: str
    agg_sig: Optional[StateSignature]
    bounds: Tuple[BoundaryProfile, ...]

    @property
    def total_demand(self) -> int:
        return sum(b.total for b in self.bounds)

    def flat_bounds(self) -> List[BoundaryProfile]:
        out: List[BoundaryProfile] = []
        for b in self.bounds:
            out.extend(b.flat())
        return out


def _profile_join(engine, join) -> BoundaryProfile:
    sig, b_q = boundary_key(join)
    _, inner = build_spine(join.build)
    children = tuple(_profile_join(engine, ij) for ij in inner)
    return BoundaryProfile(sig, b_q, estimate_demand(engine, join.build), children)


def profile_query(engine, query: Query) -> QueryProfile:
    scan, joins, agg, _ = plan_spine(query.plan)
    agg_sig = aggregate_signature(agg) if engine.mode.agg_share != "none" else None
    return QueryProfile(
        qid=query.qid,
        arrival=query.arrival,
        template=getattr(query, "template", "?"),
        scan_table=scan.table,
        agg_sig=agg_sig,
        bounds=tuple(_profile_join(engine, j) for j in joins),
    )


# ---------------------------------------------------------------------------
# Coverage scoring: live snapshot + virtual in-cohort extents
# ---------------------------------------------------------------------------


def _agg_live(engine, agg_sig: Optional[StateSignature]) -> bool:
    if agg_sig is None or engine.mode.agg_share == "none":
        return False
    existing = engine.agg_index.get(agg_sig)
    return existing is not None and engine._agg_attachable(existing)


def _cover(engine, bp: BoundaryProfile, virtual, register: bool) -> int:
    """Rows of ``bp``'s subtree demand that ride shared state.

    ``virtual`` maps signature -> build predicates of extents earlier
    cohort members will register (their residual/ordinary producers); with
    ``virtual=None`` this scores the per-query greedy snapshot. Mirrors
    ``resolve_boundary``: a fully covered boundary (live or virtual)
    eliminates its whole subtree and registers nothing; a partial/ordinary
    attachment registers its own extent and resolves children bottom-up."""
    full, granted = coverage_probe(engine, bp.sig, bp.b_q, bp.demand)
    if full:
        return bp.total
    if virtual is not None and bp.b_q is not None:
        for wide in virtual.get(bp.sig, ()):
            if bp.b_q.implies(wide):
                return bp.total
    if register and bp.b_q is not None:
        virtual.setdefault(bp.sig, []).append(bp.b_q)
    cov = granted
    for c in bp.children:
        cov += _cover(engine, c, virtual, register)
    return cov


def snapshot_coverage(engine, prof: QueryProfile) -> int:
    """Represented coverage a per-query greedy admission would observe
    against the engine's current state — the baseline the planner must
    never fall below."""
    if _agg_live(engine, prof.agg_sig):
        return prof.total_demand
    return sum(_cover(engine, b, None, False) for b in prof.bounds)


def _simulate(engine, ordered: List[QueryProfile]) -> Dict[int, Tuple[int, bool]]:
    """Planned coverage per member when the cohort admits in ``ordered``
    order: each member sees the live snapshot plus the extents and
    aggregate identities earlier members will have registered."""
    virtual: Dict[StateSignature, List[Conjunction]] = {}
    virtual_aggs: set = set()
    out: Dict[int, Tuple[int, bool]] = {}
    for p in ordered:
        if _agg_live(engine, p.agg_sig) or p.agg_sig in virtual_aggs:
            out[p.qid] = (p.total_demand, True)
            continue
        cov = sum(_cover(engine, b, virtual, True) for b in p.bounds)
        if p.agg_sig is not None and engine.mode.agg_share != "none":
            virtual_aggs.add(p.agg_sig)
        out[p.qid] = (cov, False)
    return out


def _provider_weights(engine, profs: List[QueryProfile]) -> Dict[int, int]:
    """Rows of OTHER members' demand each member's admission would turn
    into represented coverage: boundary extents containing another
    member's build predicate, plus shared aggregate identities. Intrinsic
    to the (snapshot, member-set) pair — never to the input order."""
    flats = {p.qid: p.flat_bounds() for p in profs}
    full_memo: Dict[object, bool] = {}

    def live_full(bp: BoundaryProfile) -> bool:
        key = (bp.sig, bp.b_q.key() if bp.b_q is not None else None)
        hit = full_memo.get(key)
        if hit is None:
            hit = coverage_probe(engine, bp.sig, bp.b_q, bp.demand)[0]
            full_memo[key] = hit
        return hit

    weights = {p.qid: 0 for p in profs}
    for p in profs:
        for o in profs:
            if o.qid == p.qid:
                continue
            for bo in flats[o.qid]:
                if bo.b_q is None or live_full(bo):
                    continue
                for bp in flats[p.qid]:
                    if bp.sig == bo.sig and bp.b_q is not None and bo.b_q.implies(bp.b_q):
                        weights[p.qid] += bo.total
                        break
    groups: Dict[StateSignature, List[QueryProfile]] = defaultdict(list)
    for p in profs:
        if p.agg_sig is not None and not _agg_live(engine, p.agg_sig):
            groups[p.agg_sig].append(p)
    for members in groups.values():
        if len(members) > 1:
            tot = sum(m.total_demand for m in members)
            for m in members:
                weights[m.qid] += tot - m.total_demand
    return weights


# ---------------------------------------------------------------------------
# The cohort plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MemberPlan:
    qid: int
    arrival: float
    template: str
    scan_table: str
    demand_rows: int
    snapshot_rows: int  # per-query greedy coverage on the same snapshot
    planned_rows: int  # coverage in planned cohort order
    provider_weight: int
    agg_collapse: bool

    def to_dict(self) -> Dict[str, object]:
        return {
            "qid": self.qid,
            "arrival": self.arrival,
            "template": self.template,
            "scan_table": self.scan_table,
            "demand_rows": self.demand_rows,
            "snapshot_rows": self.snapshot_rows,
            "planned_rows": self.planned_rows,
            "provider_weight": self.provider_weight,
            "agg_collapse": self.agg_collapse,
        }


@dataclass(frozen=True)
class CohortPlan:
    """One jointly planned admission cohort, in planned admission order."""

    members: Tuple[MemberPlan, ...]

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def order(self) -> Tuple[int, ...]:
        return tuple(m.qid for m in self.members)

    @property
    def snapshot_rows(self) -> int:
        return sum(m.snapshot_rows for m in self.members)

    @property
    def planned_rows(self) -> int:
        return sum(m.planned_rows for m in self.members)

    @property
    def gain_rows(self) -> int:
        return max(0, self.planned_rows - self.snapshot_rows)

    def to_dict(self) -> Dict[str, object]:
        return {
            "size": self.size,
            "order": list(self.order),
            "snapshot_rows": self.snapshot_rows,
            "planned_rows": self.planned_rows,
            "gain_rows": self.gain_rows,
            "members": [m.to_dict() for m in self.members],
        }

    def render(self) -> str:
        """The EXPLAIN GRAFT COHORT block."""
        lines = [
            f"EXPLAIN GRAFT COHORT: {self.size} queries, planned coverage "
            f"{self.planned_rows} rows (greedy snapshot {self.snapshot_rows}, "
            f"gain +{self.gain_rows})"
        ]
        by_scan: Dict[str, List[MemberPlan]] = defaultdict(list)
        for m in self.members:
            by_scan[m.scan_table].append(m)
        for table in sorted(by_scan):
            qids = ", ".join(f"q{m.qid}" for m in by_scan[table])
            lines.append(f"  scan group {table}: {qids}")
        for i, m in enumerate(self.members):
            tags = []
            if m.agg_collapse:
                tags.append("agg-collapse")
            if m.provider_weight > 0:
                tags.append(f"provides {m.provider_weight} rows")
            tag = f" [{', '.join(tags)}]" if tags else ""
            lines.append(
                f"  {i + 1}. q{m.qid} [{m.template}] arrival={m.arrival:g} "
                f"demand={m.demand_rows} planned={m.planned_rows} "
                f"(snapshot {m.snapshot_rows}){tag}"
            )
        return "\n".join(lines)


def plan_cohort(engine, queries: List[Query]) -> CohortPlan:
    """Jointly plan one admission cohort against the engine's current
    state. Pure + read-only; see the module docstring for the contract."""
    profs = sorted(
        (profile_query(engine, q) for q in queries),
        key=lambda p: (p.arrival, p.qid),
    )
    weights = _provider_weights(engine, profs)
    ordered = sorted(profs, key=lambda p: (-weights[p.qid], p.arrival, p.qid))
    sim = _simulate(engine, ordered)
    members = tuple(
        MemberPlan(
            qid=p.qid,
            arrival=p.arrival,
            template=p.template,
            scan_table=p.scan_table,
            demand_rows=p.total_demand,
            snapshot_rows=snapshot_coverage(engine, p),
            planned_rows=sim[p.qid][0],
            provider_weight=weights[p.qid],
            agg_collapse=sim[p.qid][1],
        )
        for p in ordered
    )
    return CohortPlan(members)
