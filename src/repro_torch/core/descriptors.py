"""Lens descriptors, state signatures, and coverage metadata (§4.1, §4.3).

A *state signature* fixes the exact non-predicate identity of a shared state:

* hash-build state: build relation subtree (structure only), build keys,
  payload layout, and required upstream state (captured structurally by the
  subtree skeleton). Predicates are NOT part of the signature — they live in
  coverage metadata, so one physical table can cover several predicate
  extents.
* aggregate state: exact aggregate identity — the aggregate input *including
  the per-query input condition* (predicates), grouping keys, aggregate
  functions, and distinct-argument semantics (§4.5).

A *lens descriptor* is what an arriving query requires at a stateful
boundary: the signature it must match exactly plus the predicate/extent
obligations checked by the prover.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .plans import Aggregate, HashJoin, PlanNode, expr_key, strip_pred_subtree, collect_subtree_pred
from .predicates import Conjunction, Pred


@dataclass(frozen=True)
class StateSignature:
    kind: str  # 'hash_build' | 'aggregate'
    key: tuple  # canonical structural key

    def __repr__(self):
        return f"StateSignature({self.kind}, {hash(self.key) & 0xFFFFFF:06x})"


def hash_build_signature(join: HashJoin) -> StateSignature:
    """Signature of the hash-build state at a HashJoin boundary."""
    return StateSignature(
        kind="hash_build",
        key=(
            strip_pred_subtree(join.build),
            tuple(join.build_keys),
            tuple(join.payload),
        ),
    )


def aggregate_signature(agg: Aggregate) -> Optional[StateSignature]:
    """Exact aggregate identity. Includes the canonicalized per-query input
    condition; returns None when the input condition is outside the
    supported predicate fragment (identity then unprovable -> no sharing)."""
    cond = Conjunction.from_pred(collect_subtree_pred(agg.input))
    if cond is None:
        return None
    return StateSignature(
        kind="aggregate",
        key=(
            strip_pred_subtree(agg.input),
            cond.key(),
            tuple(agg.group_keys),
            tuple(
                (a.func, expr_key(a.expr) if a.expr is not None else None, a.distinct)
                for a in agg.aggs
            ),
        ),
    )


@dataclass(frozen=True)
class LensDescriptor:
    """d = (a, rho): lens signature + operator rule (§5.2).

    For hash-probe boundaries ``rho`` is the (fixed) inner-join rule and
    ``build_pred`` is B_q, the query's required build-side predicate as a
    canonical conjunction (None when outside the fragment — then nothing can
    be proven represented). For aggregate boundaries the signature alone *is*
    the identity."""

    signature: StateSignature
    build_pred: Optional[Conjunction] = None  # hash_build only
    rule: str = "inner"
