"""Physical plan representation for GraftDB queries.

GraftDB targets finite analytical SELECT queries representable as acyclic
relational operator plans built from base-table scans, selections,
projections, hash joins, and aggregations (§3.2). A query instance is a plan
tree plus concrete parameter values already substituted into predicates.

Plans here are *physical*: join order and operator sequence are fixed per
template before any sharing decision is applied (mirroring the paper's
PostgreSQL-pinned plans), and sharing decisions never change the plan shape —
they only re-source stateful boundaries onto shared state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .predicates import Pred, TRUE, free_attrs

# ---------------------------------------------------------------------------
# Scalar expression AST (aggregate inputs like sum(price * (1 - discount)))
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Col:
    name: str


@dataclass(frozen=True)
class Const:
    value: float


@dataclass(frozen=True)
class BinOp:
    op: str  # '+', '-', '*'
    lhs: object
    rhs: object


@dataclass(frozen=True)
class WhereEq:
    """CASE WHEN attr == value THEN then_expr ELSE else_expr (TPC-H Q8)."""

    attr: str
    value: float
    then: object
    other: object


Expr = object  # Col | Const | BinOp | WhereEq


def expr_eval(e: Expr, cols: Dict[str, np.ndarray]) -> np.ndarray:
    if isinstance(e, Col):
        return cols[e.name]
    if isinstance(e, Const):
        return e.value  # broadcasts
    if isinstance(e, BinOp):
        a, b = expr_eval(e.lhs, cols), expr_eval(e.rhs, cols)
        if e.op == "+":
            return a + b
        if e.op == "-":
            return a - b
        if e.op == "*":
            return a * b
        raise ValueError(e.op)
    if isinstance(e, WhereEq):
        return np.where(
            cols[e.attr] == e.value, expr_eval(e.then, cols), expr_eval(e.other, cols)
        )
    raise TypeError(e)


def expr_attrs(e: Expr) -> frozenset:
    if isinstance(e, Col):
        return frozenset((e.name,))
    if isinstance(e, Const):
        return frozenset()
    if isinstance(e, BinOp):
        return expr_attrs(e.lhs) | expr_attrs(e.rhs)
    if isinstance(e, WhereEq):
        return frozenset((e.attr,)) | expr_attrs(e.then) | expr_attrs(e.other)
    raise TypeError(e)


def expr_key(e: Expr):
    if isinstance(e, Col):
        return ("col", e.name)
    if isinstance(e, Const):
        return ("const", float(e.value))
    if isinstance(e, BinOp):
        return ("bin", e.op, expr_key(e.lhs), expr_key(e.rhs))
    if isinstance(e, WhereEq):
        return ("where_eq", e.attr, float(e.value), expr_key(e.then), expr_key(e.other))
    raise TypeError(e)


# ---------------------------------------------------------------------------
# Plan nodes
# ---------------------------------------------------------------------------


@dataclass
class Scan:
    """Base-table scan + selection + projection (filters fold into scans)."""

    table: str
    pred: Pred = TRUE
    columns: Tuple[str, ...] = ()


@dataclass
class HashJoin:
    """Inner equi hash join. ``build`` is the state-side input subtree;
    ``probe`` drives lookups (consumer-side data flow, §3.3).

    ``payload_as`` optionally renames payload attrs in the join output (the
    state keeps canonical names so sharing is preserved; e.g. TPC-H Q7 probes
    two nation-derived states whose payloads would otherwise collide).
    ``post_filter`` is applied to the join output (evaluation-only predicates
    such as Q5's c_nationkey = s_nationkey)."""

    build: object
    probe: object
    build_keys: Tuple[str, ...]
    probe_keys: Tuple[str, ...]
    payload: Tuple[str, ...]  # build-side attrs carried to output (RetainedAttrs)
    payload_as: Optional[Tuple[str, ...]] = None
    post_filter: Pred = TRUE


@dataclass(frozen=True)
class AggSpec:
    func: str  # 'sum' | 'count' | 'avg' | 'min' | 'max'
    expr: Optional[Expr] = None  # None for count(*)
    distinct: bool = False
    name: str = ""


@dataclass
class Aggregate:
    input: object
    group_keys: Tuple[str, ...]
    aggs: Tuple[AggSpec, ...]


@dataclass
class OrderBy:
    """Final presentation operator — never shared, negligible work."""

    input: object
    keys: Tuple[str, ...]
    ascending: Tuple[bool, ...]
    limit: Optional[int] = None


PlanNode = object  # Scan | HashJoin | Aggregate | OrderBy


@dataclass
class Query:
    """A query instance: template id, plan, params (for reporting)."""

    qid: int
    template: str
    plan: PlanNode
    params: Dict[str, object] = field(default_factory=dict)
    arrival: float = 0.0


# ---------------------------------------------------------------------------
# Plan utilities
# ---------------------------------------------------------------------------


def plan_scans(node: PlanNode) -> List[Scan]:
    if isinstance(node, Scan):
        return [node]
    if isinstance(node, HashJoin):
        return plan_scans(node.build) + plan_scans(node.probe)
    if isinstance(node, (Aggregate, OrderBy)):
        return plan_scans(node.input)
    raise TypeError(node)


def plan_output_columns(node: PlanNode) -> Tuple[str, ...]:
    """Columns available at a node's output."""
    if isinstance(node, Scan):
        return tuple(node.columns)
    if isinstance(node, HashJoin):
        out_names = node.payload_as if node.payload_as is not None else node.payload
        return tuple(plan_output_columns(node.probe)) + tuple(out_names)
    if isinstance(node, Aggregate):
        return tuple(node.group_keys) + tuple(a.name for a in node.aggs)
    if isinstance(node, OrderBy):
        return plan_output_columns(node.input)
    raise TypeError(node)


def collect_subtree_pred(node: PlanNode) -> Pred:
    """All predicates applied inside a subtree, as one conjunction. This is
    the state-side predicate of a hash-build subtree (coverage vocabulary)."""
    from .predicates import pred_and

    if isinstance(node, Scan):
        return node.pred
    if isinstance(node, HashJoin):
        return pred_and(
            collect_subtree_pred(node.build),
            collect_subtree_pred(node.probe),
            node.post_filter,
        )
    if isinstance(node, (Aggregate, OrderBy)):
        return collect_subtree_pred(node.input)
    raise TypeError(node)


def strip_pred_subtree(node: PlanNode):
    """Structural skeleton of a subtree with predicates removed — the
    non-predicate part of a state signature (§4.3: relation, keys, payload
    layout, required upstream state)."""
    if isinstance(node, Scan):
        return ("scan", node.table, tuple(node.columns))
    if isinstance(node, HashJoin):
        return (
            "hashjoin",
            strip_pred_subtree(node.build),
            strip_pred_subtree(node.probe),
            tuple(node.build_keys),
            tuple(node.probe_keys),
            tuple(node.payload),
            tuple(node.payload_as) if node.payload_as is not None else None,
        )
    if isinstance(node, Aggregate):
        return (
            "aggregate",
            strip_pred_subtree(node.input),
            tuple(node.group_keys),
            tuple((a.func, expr_key(a.expr) if a.expr is not None else None, a.distinct) for a in node.aggs),
        )
    if isinstance(node, OrderBy):
        return strip_pred_subtree(node.input)
    raise TypeError(node)
