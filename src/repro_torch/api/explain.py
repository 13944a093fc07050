"""EXPLAIN GRAFT: the grafting decision as structured data.

``analyze_query(engine, query)`` mirrors the admission logic of
``core/grafting.py`` (Algorithm 1) **read-only**: it walks the plan spine
bottom-up, selects candidate shared states exactly as ``resolve_boundary``
would, and partitions each stateful boundary's isolated-plan demand into

* ``represented`` — rows already proven observable through a state lens,
* ``residual``    — rows a residual producer would still deliver into the
                    selected shared state,
* ``unattached``  — ordinary-plan rows (fresh state + ordinary producer),

without attaching, granting, or creating anything. Per boundary (and in
total) ``represented + residual + unattached == demand`` by construction,
so the report is an exact accounting of where the query's work would come
from at this instant of the shared execution.

``Session.explain_graft`` calls this pre-flight; with
``EngineConfig(capture_explain=True)`` the same analysis is captured at each
query's actual admission and exposed via ``QueryFuture.explain()``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..core.descriptors import aggregate_signature, hash_build_signature
from ..core.grafting import (
    all_boundaries,
    build_spine,
    demand_keycodes,
    estimate_demand,
    plan_spine,
)
from ..core.hashindex import key_partition
from ..core.plans import HashJoin, Query
from ..core.predicates import Conjunction
from ..core.runtime import ALL_EXTENTS
from ..core.plans import collect_subtree_pred


@dataclass(frozen=True)
class BoundaryExplain:
    """One stateful hash-build boundary's attachment decision.

    The ``part_*`` tuples split the same accounting by key-hash partition
    (DESIGN.md §9): element p covers the demand rows whose build key hashes
    to state shard p. Per partition (and therefore in total)
    ``represented + residual + unattached == demand`` exactly."""

    build_table: str  # base table at the bottom of the build spine
    depth: int  # 0 = innermost spine boundary; nested boundaries indent
    decision: str  # 'represented' | 'partial' | 'residual' | 'ordinary' | 'eliminated'
    demand_rows: int  # rows an isolated plan would feed this build
    represented_rows: int
    residual_rows: int
    unattached_rows: int
    state_id: Optional[int] = None  # selected shared state (None = fresh)
    # the selected state is retired (zero refs, kept by the epoch retention
    # policy §10) — attaching would revive it out of the evictor's reach
    state_retired: bool = False
    # the selected state is a cached artifact (§12): admission would
    # rehydrate it from the reuse plane and attach exactly as to a live
    # candidate — represented/residual/unattached still sum to demand
    served_from_cache: bool = False
    nested: Tuple["BoundaryExplain", ...] = ()
    part_demand_rows: Tuple[int, ...] = ()
    part_represented_rows: Tuple[int, ...] = ()
    part_residual_rows: Tuple[int, ...] = ()
    part_unattached_rows: Tuple[int, ...] = ()

    def flat(self) -> List["BoundaryExplain"]:
        out = [self]
        for b in self.nested:
            out.extend(b.flat())
        return out


@dataclass(frozen=True)
class GraftExplain:
    """The full EXPLAIN GRAFT report for one query against one engine state."""

    qid: int
    template: str
    mode: str
    spine_scan: str  # probe-side base table of the main pipeline
    # 'attach' (exact live aggregate identity) | 'attach_cached' (identity
    # rehydrates from the reuse plane, §12) | 'new'
    agg_decision: str
    boundaries: Tuple[BoundaryExplain, ...] = ()
    # §16: the query unfolded to isolated execution after a fault (set on
    # the captured report by QueryFuture.explain, never at admission)
    degraded: bool = False

    # -- totals --------------------------------------------------------------
    def _all(self) -> List[BoundaryExplain]:
        out: List[BoundaryExplain] = []
        for b in self.boundaries:
            out.extend(b.flat())
        return out

    @property
    def total_demand_rows(self) -> int:
        return sum(b.demand_rows for b in self._all())

    @property
    def represented_rows(self) -> int:
        return sum(b.represented_rows for b in self._all())

    @property
    def residual_rows(self) -> int:
        return sum(b.residual_rows for b in self._all())

    @property
    def unattached_rows(self) -> int:
        return sum(b.unattached_rows for b in self._all())

    def partition_totals(self) -> List[dict]:
        """Per-key-partition roll-up across all boundaries (§9): each entry
        partitions its shard's demand exactly into represented + residual +
        unattached, and the shard demands sum to ``total_demand_rows``."""
        n_parts = max((len(b.part_demand_rows) for b in self._all()), default=0)
        out = []
        for p in range(n_parts):
            row = {"partition": p, "demand_rows": 0, "represented_rows": 0,
                   "residual_rows": 0, "unattached_rows": 0}
            for b in self._all():
                if p < len(b.part_demand_rows):
                    row["demand_rows"] += b.part_demand_rows[p]
                    row["represented_rows"] += b.part_represented_rows[p]
                    row["residual_rows"] += b.part_residual_rows[p]
                    row["unattached_rows"] += b.part_unattached_rows[p]
            out.append(row)
        return out

    def to_dict(self) -> dict:
        return {
            "qid": self.qid,
            "template": self.template,
            "mode": self.mode,
            "spine_scan": self.spine_scan,
            "agg_decision": self.agg_decision,
            "degraded": self.degraded,
            "total_demand_rows": self.total_demand_rows,
            "represented_rows": self.represented_rows,
            "residual_rows": self.residual_rows,
            "unattached_rows": self.unattached_rows,
            "partition_totals": self.partition_totals(),
            "boundaries": [
                {
                    "build_table": b.build_table,
                    "depth": b.depth,
                    "decision": b.decision,
                    "demand_rows": b.demand_rows,
                    "represented_rows": b.represented_rows,
                    "residual_rows": b.residual_rows,
                    "unattached_rows": b.unattached_rows,
                    "state_id": b.state_id,
                    "state_retired": b.state_retired,
                    "served_from_cache": b.served_from_cache,
                    "part_demand_rows": list(b.part_demand_rows),
                    "part_represented_rows": list(b.part_represented_rows),
                    "part_residual_rows": list(b.part_residual_rows),
                    "part_unattached_rows": list(b.part_unattached_rows),
                }
                for root in self.boundaries
                for b in root.flat()
            ],
        }

    def render(self) -> str:
        """Human-readable EXPLAIN GRAFT block."""
        tag = " DEGRADED" if self.degraded else ""
        lines = [
            f"EXPLAIN GRAFT q{self.qid} [{self.template}] mode={self.mode}{tag}",
            f"  spine scan: {self.spine_scan}  aggregate: {self.agg_decision}",
            f"  demand {self.total_demand_rows:,} rows = represented {self.represented_rows:,}"
            f" + residual {self.residual_rows:,} + unattached {self.unattached_rows:,}",
        ]
        ptotals = self.partition_totals()
        if len(ptotals) > 1:
            for row in ptotals:
                lines.append(
                    f"  partition {row['partition']}: demand {row['demand_rows']:,}"
                    f" (rep {row['represented_rows']:,} / res {row['residual_rows']:,}"
                    f" / ord {row['unattached_rows']:,})"
                )
        for root in self.boundaries:
            for b in root.flat():
                pad = "    " + "  " * b.depth
                if b.state_id is not None:
                    tag = " (retired)" if b.state_retired else ""
                    if b.served_from_cache:
                        tag = " (cache)"
                    tgt = f" -> state #{b.state_id}{tag}"
                elif b.served_from_cache:
                    # eliminated under a cached aggregate identity (§12)
                    tgt = " -> cached artifact (cache)"
                else:
                    tgt = " -> fresh state"
                lines.append(
                    f"{pad}build[{b.build_table}] {b.decision}{tgt}: "
                    f"demand {b.demand_rows:,} (rep {b.represented_rows:,} / "
                    f"res {b.residual_rows:,} / ord {b.unattached_rows:,})"
                )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Read-only admission analysis
# ---------------------------------------------------------------------------


def analyze_query(engine, query: Query) -> GraftExplain:
    """EXPLAIN GRAFT for ``query`` against the engine's current shared state.

    Pure observation: never attaches, grants, registers extents, or creates
    states — safe to call at any time, including pre-flight.
    """
    scan, joins, agg, _ = plan_spine(query.plan)
    mode = engine.mode

    # Exact aggregate identity (§4.5): the whole plan collapses onto an
    # attachable shared aggregate — every boundary's demand is eliminated
    # (fully represented by already-accumulated state).
    agg_sig = aggregate_signature(agg)
    if agg_sig is not None and mode.agg_share != "none":
        existing = engine.agg_index.get(agg_sig)
        cached = False
        if (
            existing is None
            and mode.agg_share == "full"
            and getattr(engine, "reuse", None) is not None
        ):
            # reuse plane (§12): the identity would rehydrate from the
            # artifact cache (cost-gated peek, read-only — nothing taken)
            cached = (
                engine.reuse.peek_agg(engine, query.plan, agg, agg_sig) is not None
            )
        if cached or (existing is not None and engine._agg_attachable(existing)):
            bounds = tuple(
                _eliminated(engine, j, depth=0, served_from_cache=cached)
                for j in all_boundaries(query.plan)
            )
            return GraftExplain(
                qid=query.qid,
                template=query.template,
                mode=mode.name,
                spine_scan=scan.table,
                agg_decision="attach_cached" if cached else "attach",
                boundaries=bounds,
            )

    bounds = tuple(_explain_boundary(engine, j, depth=0) for j in joins)
    return GraftExplain(
        qid=query.qid,
        template=query.template,
        mode=mode.name,
        spine_scan=scan.table,
        agg_decision="new",
        boundaries=bounds,
    )


def _build_table(join: HashJoin) -> str:
    bscan, _ = build_spine(join.build)
    return bscan.table


def _demand_split(engine, join: HashJoin, demand: int) -> np.ndarray:
    """Key-hash partition split of this boundary's isolated-plan demand
    (sums to ``estimate_demand`` exactly — same row set, same masks).
    Unpartitioned engines short-circuit: the split is trivially [demand]
    and the per-row keycode pass is skipped."""
    if engine.n_partitions == 1:
        return np.array([demand], dtype=np.int64)
    codes = demand_keycodes(engine, join.build, tuple(join.build_keys))
    parts = key_partition(codes, engine.n_partitions)
    return np.bincount(parts, minlength=engine.n_partitions).astype(np.int64)


def _zeros_like(split: np.ndarray) -> Tuple[int, ...]:
    return tuple(0 for _ in split)


def _eliminated(
    engine, join: HashJoin, depth: int, served_from_cache: bool = False
) -> BoundaryExplain:
    demand = estimate_demand(engine, join.build)
    split = _demand_split(engine, join, demand)
    return BoundaryExplain(
        build_table=_build_table(join),
        depth=depth,
        decision="eliminated",
        demand_rows=demand,
        represented_rows=demand,
        residual_rows=0,
        unattached_rows=0,
        served_from_cache=served_from_cache,
        part_demand_rows=tuple(int(x) for x in split),
        part_represented_rows=tuple(int(x) for x in split),
        part_residual_rows=_zeros_like(split),
        part_unattached_rows=_zeros_like(split),
    )


def _explain_boundary(engine, join: HashJoin, depth: int) -> BoundaryExplain:
    """Mirror of ``grafting.resolve_boundary``'s decision ladder, read-only."""
    mode = engine.mode
    sig = hash_build_signature(join)
    b_q = Conjunction.from_pred(collect_subtree_pred(join.build))
    demand = estimate_demand(engine, join.build)
    table = _build_table(join)
    split = _demand_split(engine, join, demand)

    candidate = None
    cached = False
    if mode.share_state:
        for s in engine.state_index.get(sig, ()):
            candidate = s
            break
        if (
            candidate is None
            and mode.allow_represented
            and getattr(engine, "reuse", None) is not None
        ):
            # reuse plane (§12): mirror the admission-time cache consult
            # with a ghost rehydration — an unregistered throwaway state
            # carrying the artifact's coverage + entries, so the ladder
            # below scores it exactly like the live candidate admission
            # would create. Read-only: the artifact stays cached.
            sel = engine.reuse.select_hash(engine, sig, b_q, demand)
            if sel is not None:
                candidate = engine.reuse.ghost_hash(sel[0])
                cached = candidate is not None  # None: corrupt at load
    retired = bool(candidate is not None and candidate.retired_epoch is not None)

    # Represented extent: proven containment against allowed coverage.
    if candidate is not None and mode.allow_represented and b_q is not None:
        retained = candidate.retained_attrs
        b_ret = Conjunction({a: c for a, c in b_q.constraints.items() if a in retained})
        b_nonret = Conjunction(
            {a: c for a, c in b_q.constraints.items() if a not in retained}
        )
        allowed = (
            ALL_EXTENTS
            if not b_nonret.constraints
            else candidate.allowed_extents_for(b_nonret)
        )
        if allowed:
            if candidate.covers_with(b_q, allowed):
                # Fully represented: upstream producers eliminated too.
                nested = tuple(
                    _eliminated(engine, up, depth + 1)
                    for up in all_boundaries(join.build)
                )
                return BoundaryExplain(
                    build_table=table,
                    depth=depth,
                    decision="represented",
                    demand_rows=demand,
                    represented_rows=demand,
                    residual_rows=0,
                    unattached_rows=0,
                    state_id=candidate.state_id,
                    state_retired=retired,
                    served_from_cache=cached,
                    nested=nested,
                    part_demand_rows=tuple(int(x) for x in split),
                    part_represented_rows=tuple(int(x) for x in split),
                    part_residual_rows=_zeros_like(split),
                    part_unattached_rows=_zeros_like(split),
                )
            # per-shard grant counts, each capped by that shard's demand so
            # the per-partition identity rep + res == demand holds exactly
            granted_parts = candidate.count_granted_by_part(
                allowed, b_ret, engine.n_partitions
            )
            rep_parts = np.minimum(granted_parts, split)
            granted = int(rep_parts.sum())
            nested = tuple(
                _explain_boundary(engine, up, depth + 1)
                for up in _build_joins(join)
            )
            return BoundaryExplain(
                build_table=table,
                depth=depth,
                decision="partial",
                demand_rows=demand,
                represented_rows=granted,
                residual_rows=demand - granted,
                unattached_rows=0,
                state_id=candidate.state_id,
                state_retired=retired,
                served_from_cache=cached,
                nested=nested,
                part_demand_rows=tuple(int(x) for x in split),
                part_represented_rows=tuple(int(x) for x in rep_parts),
                part_residual_rows=tuple(int(x) for x in (split - rep_parts)),
                part_unattached_rows=_zeros_like(split),
            )

    # Residual-only attachment: all demand flows through a residual producer.
    if candidate is not None and mode.allow_residual:
        nested = tuple(
            _explain_boundary(engine, up, depth + 1) for up in _build_joins(join)
        )
        return BoundaryExplain(
            build_table=table,
            depth=depth,
            decision="residual",
            demand_rows=demand,
            represented_rows=0,
            residual_rows=demand,
            unattached_rows=0,
            state_id=candidate.state_id,
            state_retired=retired,
            served_from_cache=cached,
            nested=nested,
            part_demand_rows=tuple(int(x) for x in split),
            part_represented_rows=_zeros_like(split),
            part_residual_rows=tuple(int(x) for x in split),
            part_unattached_rows=_zeros_like(split),
        )

    # Ordinary-plan work (a fresh state; QPipe merges still execute the same
    # physical producer, so their demand stays classified as unattached).
    nested = tuple(
        _explain_boundary(engine, up, depth + 1) for up in _build_joins(join)
    )
    return BoundaryExplain(
        build_table=table,
        depth=depth,
        decision="ordinary",
        demand_rows=demand,
        represented_rows=0,
        residual_rows=0,
        unattached_rows=demand,
        state_id=None,
        nested=nested,
        part_demand_rows=tuple(int(x) for x in split),
        part_represented_rows=_zeros_like(split),
        part_residual_rows=_zeros_like(split),
        part_unattached_rows=tuple(int(x) for x in split),
    )


def _build_joins(join: HashJoin) -> List[HashJoin]:
    """Stateful boundaries nested inside this boundary's build subtree, in
    the order the producer path resolves them (bottom-up along its spine)."""
    _, inner = build_spine(join.build)
    return inner


# ---------------------------------------------------------------------------
# Cohort analysis (§15): EXPLAIN GRAFT for a planned batch
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CohortExplain:
    """EXPLAIN GRAFT COHORT: the batch planner's verdict for a set of queued
    queries, paired with each member's pre-flight single-query analysis.

    ``plan`` is the pure ``core.batchplan.CohortPlan`` (admission order,
    per-member snapshot vs planned coverage); ``members`` holds the ordinary
    EXPLAIN GRAFT reports taken against the *current* engine snapshot, in
    planned admission order. Read-only, like ``analyze_query``."""

    plan: "object"  # core.batchplan.CohortPlan
    members: Tuple[GraftExplain, ...] = ()

    def to_dict(self) -> dict:
        return {
            "plan": self.plan.to_dict(),
            "members": [m.to_dict() for m in self.members],
        }

    def render(self) -> str:
        lines = [self.plan.render()]
        for m in self.members:
            lines.append("")
            lines.append(m.render())
        return "\n".join(lines)


def analyze_cohort(engine, queries) -> CohortExplain:
    """EXPLAIN GRAFT COHORT for ``queries`` against the current engine state.

    Runs the §15 batch planner as a pure function of the live snapshot, then
    attaches each member's ordinary ``analyze_query`` report in the planned
    admission order. Never attaches, grants, or creates state."""
    from ..core.batchplan import plan_cohort

    queries = list(queries)
    plan = plan_cohort(engine, queries)
    by_qid = {q.qid: q for q in queries}
    members = tuple(analyze_query(engine, by_qid[qid]) for qid in plan.order)
    return CohortExplain(plan=plan, members=members)
