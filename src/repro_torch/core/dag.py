"""Read-only snapshot of the shared execution DAG (§5.1) for tests,
debugging, and the Algorithm-2 invariant checks.

Nodes are operator instances with their assigned queries; DataEdge carries
row flow (scan -> pipeline -> sink), StateRefEdge connects state-consuming
members to shared state through their state-readiness gates.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple


@dataclass
class DagNode:
    kind: str  # 'scan' | 'pipeline' | 'state' | 'agg'
    ident: object
    queries: Tuple[int, ...] = ()


@dataclass
class DagSnapshot:
    nodes: List[DagNode] = field(default_factory=list)
    data_edges: List[Tuple[object, object]] = field(default_factory=list)
    state_ref_edges: List[Tuple[object, object, int, bool, Tuple[int, int]]] = field(
        default_factory=list
    )
    # (consumer pipeline, state, qid, gate_open, partition_frontier):
    # the frontier is (delivered, total) producer scan-partition units
    # still gating this edge (DESIGN.md §9) — (0, 0) once nothing pends

    def dep_edges(self):
        return [(a, b) for a, b in self.data_edges] + [
            (s, p) for p, s, *_ in self.state_ref_edges
        ]


def snapshot(engine) -> DagSnapshot:
    snap = DagSnapshot()
    seen_states: Set[int] = set()
    for key, scan in engine.scans.items():
        snap.nodes.append(DagNode("scan", key))
        for p in scan.pipelines:
            qs = tuple(sorted({m.qid for m in p.members if not m.done}))
            snap.nodes.append(DagNode("pipeline", p.key, qs))
            snap.data_edges.append((key, p.key))
            if p.build_target is not None:
                sid = p.build_target.state.state_id
                if sid not in seen_states:
                    seen_states.add(sid)
                    snap.nodes.append(DagNode("state", sid))
                snap.data_edges.append((p.key, sid))
            for m in p.members:
                if m.done:
                    continue
                for g in m.gates:
                    sid = g.state.state_id
                    if sid not in seen_states:
                        seen_states.add(sid)
                        snap.nodes.append(DagNode("state", sid))
                    snap.state_ref_edges.append(
                        (p.key, sid, m.qid, g.open(), g.partition_frontier())
                    )
    return snap


def check_invariants(engine) -> List[str]:
    """Core correctness conditions of §5.4: active node-query pairs never
    have a closed gate; producers pending on a gate are live members of a
    pipeline targeting that gate's state; states referenced by active
    queries are retained."""
    errors: List[str] = []
    for key, scan in engine.scans.items():
        for p in scan.pipelines:
            for m in p.members:
                if m.active and not m.done:
                    for g in m.gates:
                        if not g.open():
                            errors.append(
                                f"member q{m.qid} active on {p.key} with closed gate on state {g.state.state_id}"
                            )
    for h in engine.active_handles:
        for s in h.attached_states:
            if h.qid not in s.refs:
                errors.append(f"query {h.qid} attached to state {s.state_id} without a ref")
    return errors
