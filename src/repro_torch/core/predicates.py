"""Predicate ASTs, canonicalization, and the containment prover Prove(P => Q).

Implements the sound-but-incomplete predicate fragment of GraftDB §4.2:

* conjunctions of deterministic comparisons between retained attributes and
  constants (plus dictionary-coded set membership, which subsumes equality),
* canonicalization of equality predicates and lower/upper bounds on each
  retained attribute,
* per-attribute range-containment rules applied independently over comparable
  scalar domains.

Anything outside the fragment (disjunctions, NULL-sensitive forms, cross
attribute expressions) canonicalizes to ``None`` and is treated as UNPROVEN.
Unproven obligations never classify an extent as represented — they fall to
residual production or ordinary-plan work (lost sharing, never unsafe
sharing).

All column values are encoded into comparable scalar domains up front
(dates -> int days, strings -> dictionary codes with membership-only
semantics), so the prover works on floats/ints only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

_OPS = ("<", "<=", ">", ">=", "==")


@dataclass(frozen=True)
class Cmp:
    """attr <op> constant."""

    attr: str
    op: str
    value: float

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unsupported comparison op {self.op!r}")


@dataclass(frozen=True)
class InSet:
    """attr IN {codes} — dictionary-coded membership (equality is a
    singleton set). Membership is the only meaningful relation on dictionary
    codes; range comparisons on coded columns are outside the fragment."""

    attr: str
    values: FrozenSet[float]


@dataclass(frozen=True)
class And:
    children: Tuple[object, ...]


_COL_OPS = ("<", "<=", ">", ">=", "==", "!=")


@dataclass(frozen=True)
class ColCmp:
    """attr_a <op> attr_b — cross-attribute comparison (e.g. TPC-H Q5's
    c_nationkey = s_nationkey, Q4's l_commitdate < l_receiptdate). Evaluable,
    but OUTSIDE the prover fragment: canonicalization returns None, so such
    predicates are never used to classify an extent as represented
    (unproven -> lost sharing, never unsafe sharing)."""

    lhs: str
    op: str
    rhs: str

    def __post_init__(self):
        if self.op not in _COL_OPS:
            raise ValueError(f"unsupported column comparison op {self.op!r}")


TRUE = And(())

Pred = object  # Cmp | InSet | And | ColCmp


def pred_and(*preds: Pred) -> Pred:
    """Conjunction constructor that flattens nested Ands and drops TRUE."""
    out: List[Pred] = []
    for p in preds:
        if p is None or p == TRUE:
            continue
        if isinstance(p, And):
            out.extend(p.children)
        else:
            out.append(p)
    if not out:
        return TRUE
    if len(out) == 1:
        return out[0]
    return And(tuple(out))


def free_attrs(pred: Pred) -> FrozenSet[str]:
    """FV(P): the attributes a predicate references (§4.2 evaluability)."""
    if isinstance(pred, (Cmp, InSet)):
        return frozenset((pred.attr,))
    if isinstance(pred, ColCmp):
        return frozenset((pred.lhs, pred.rhs))
    if isinstance(pred, And):
        out: FrozenSet[str] = frozenset()
        for c in pred.children:
            out = out | free_attrs(c)
        return out
    return frozenset()


# ---------------------------------------------------------------------------
# Canonical conjunctions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttrConstraint:
    """Canonical per-attribute constraint: an interval and/or a member set.

    ``members`` is ``None`` when no membership constraint applies. An empty
    members set means the constraint is unsatisfiable.
    """

    lo: float = -math.inf
    lo_inc: bool = True
    hi: float = math.inf
    hi_inc: bool = True
    members: Optional[FrozenSet[float]] = None

    # -- algebra ----------------------------------------------------------
    def intersect(self, other: "AttrConstraint") -> "AttrConstraint":
        lo, lo_inc = max(
            (self.lo, not self.lo_inc), (other.lo, not other.lo_inc)
        )
        lo_inc = not lo_inc
        hi, hi_inc = min(
            (self.hi, self.hi_inc), (other.hi, other.hi_inc)
        )
        if self.members is None:
            members = other.members
        elif other.members is None:
            members = self.members
        else:
            members = self.members & other.members
        return AttrConstraint(lo, lo_inc, hi, hi_inc, members)

    def contains(self, other: "AttrConstraint") -> bool:
        """True iff every value satisfying ``other`` satisfies ``self``.

        Sound under the encoded scalar domains. Mixed set/range reasoning is
        limited to the sound direction: a member set is contained in a range
        iff all members fall inside it.
        """
        if other.is_empty():
            return True
        # Membership side.
        if self.members is not None:
            if other.members is None:
                return False  # range cannot be proven inside a finite set
            if not other.members <= self.members:
                return False
        # Range side: other's effective range must sit inside self's range.
        o_lo, o_lo_inc, o_hi, o_hi_inc = other.lo, other.lo_inc, other.hi, other.hi_inc
        if other.members is not None and other.members:
            mlo, mhi = min(other.members), max(other.members)
            if mlo > o_lo or (mlo == o_lo and not o_lo_inc):
                o_lo, o_lo_inc = mlo, True
            if mhi < o_hi or (mhi == o_hi and not o_hi_inc):
                o_hi, o_hi_inc = mhi, True
        if o_lo < self.lo or (o_lo == self.lo and o_lo_inc and not self.lo_inc):
            return False
        if o_hi > self.hi or (o_hi == self.hi and o_hi_inc and not self.hi_inc):
            return False
        return True

    def is_empty(self) -> bool:
        if self.members is not None and not self.members:
            return True
        if self.lo > self.hi:
            return True
        if self.lo == self.hi and not (self.lo_inc and self.hi_inc):
            return True
        if self.members is not None:
            return not any(self._in_range(m) for m in self.members)
        return False

    def _in_range(self, v: float) -> bool:
        if v < self.lo or (v == self.lo and not self.lo_inc):
            return False
        if v > self.hi or (v == self.hi and not self.hi_inc):
            return False
        return True

    def is_unconstrained(self) -> bool:
        return (
            self.members is None
            and self.lo == -math.inf
            and self.hi == math.inf
        )

    def key(self):
        mem = None if self.members is None else tuple(sorted(self.members))
        return (self.lo, self.lo_inc, self.hi, self.hi_inc, mem)


class Conjunction:
    """Canonical conjunction: attr -> AttrConstraint. Hash/eq by content."""

    __slots__ = ("constraints",)

    def __init__(self, constraints: Optional[Dict[str, AttrConstraint]] = None):
        cons = dict(constraints or {})
        # Normalize away no-op constraints so TRUE has a unique form.
        self.constraints: Dict[str, AttrConstraint] = {
            a: c for a, c in cons.items() if not c.is_unconstrained()
        }

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_pred(pred: Pred) -> Optional["Conjunction"]:
        """Canonicalize a predicate. Returns None outside the fragment."""
        cons: Dict[str, AttrConstraint] = {}

        def add(attr: str, c: AttrConstraint):
            cons[attr] = cons[attr].intersect(c) if attr in cons else c

        def walk(p: Pred) -> bool:
            if p is TRUE:
                return True
            if isinstance(p, And):
                return all(walk(c) for c in p.children)
            if isinstance(p, Cmp):
                v = float(p.value)
                if p.op == "<":
                    add(p.attr, AttrConstraint(hi=v, hi_inc=False))
                elif p.op == "<=":
                    add(p.attr, AttrConstraint(hi=v, hi_inc=True))
                elif p.op == ">":
                    add(p.attr, AttrConstraint(lo=v, lo_inc=False))
                elif p.op == ">=":
                    add(p.attr, AttrConstraint(lo=v, lo_inc=True))
                elif p.op == "==":
                    add(p.attr, AttrConstraint(members=frozenset((v,))))
                return True
            if isinstance(p, InSet):
                add(p.attr, AttrConstraint(members=frozenset(float(v) for v in p.values)))
                return True
            return False  # unsupported node -> outside the fragment

        if not walk(pred):
            return None
        return Conjunction(cons)

    # -- relations ----------------------------------------------------------
    def implies(self, other: "Conjunction") -> bool:
        """Prove(self => other): every attr constraint of ``other`` must
        contain the corresponding constraint of ``self``. Missing constraint
        on our side means we are weaker there -> unproven."""
        if self.is_empty():
            return True
        for attr, oc in other.constraints.items():
            sc = self.constraints.get(attr)
            if sc is None:
                return False
            if not oc.contains(sc):
                return False
        return True

    def intersect(self, other: "Conjunction") -> "Conjunction":
        cons = dict(self.constraints)
        for a, c in other.constraints.items():
            cons[a] = cons[a].intersect(c) if a in cons else c
        return Conjunction(cons)

    def is_empty(self) -> bool:
        return any(c.is_empty() for c in self.constraints.values())

    def attrs(self) -> FrozenSet[str]:
        return frozenset(self.constraints)

    # -- hashing ------------------------------------------------------------
    def key(self):
        return tuple(sorted((a, c.key()) for a, c in self.constraints.items()))

    def __eq__(self, other):
        return isinstance(other, Conjunction) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        if not self.constraints:
            return "Conjunction(TRUE)"
        parts = []
        for a, c in sorted(self.constraints.items()):
            s = a
            if c.members is not None:
                s += f" in {sorted(c.members)}"
            if c.lo != -math.inf:
                s += f" {'>=' if c.lo_inc else '>'} {c.lo}"
            if c.hi != math.inf:
                s += f" {'<=' if c.hi_inc else '<'} {c.hi}"
            parts.append(s)
        return "Conjunction(" + " & ".join(parts) + ")"


TRUE_CONJ = Conjunction()


# ---------------------------------------------------------------------------
# Coverage: union of conjunctions, with one-attribute interval merging
# ---------------------------------------------------------------------------


def _try_merge(a: Conjunction, b: Conjunction) -> Optional[Conjunction]:
    """Merge two conjunctions that agree on all attrs except at most one,
    where their intervals overlap or touch. Sound widening used only for
    coverage bookkeeping (the union of complete extents stays complete)."""
    attrs = set(a.constraints) | set(b.constraints)
    diff = [
        t
        for t in attrs
        if a.constraints.get(t, AttrConstraint()) != b.constraints.get(t, AttrConstraint())
    ]
    if not diff:
        return a
    if len(diff) > 1:
        return None
    t = diff[0]
    ca = a.constraints.get(t, AttrConstraint())
    cb = b.constraints.get(t, AttrConstraint())
    if ca.members is not None or cb.members is not None:
        if ca.members is not None and cb.members is not None and (
            ca.lo, ca.lo_inc, ca.hi, ca.hi_inc
        ) == (cb.lo, cb.lo_inc, cb.hi, cb.hi_inc):
            merged = AttrConstraint(ca.lo, ca.lo_inc, ca.hi, ca.hi_inc, ca.members | cb.members)
            cons = dict(a.constraints)
            cons[t] = merged
            return Conjunction(cons)
        return None
    lo_first, hi_first = (ca, cb) if (ca.lo, not ca.lo_inc) <= (cb.lo, not cb.lo_inc) else (cb, ca)
    # Overlap or touch: second interval must start at or before first's end.
    touch = lo_first.hi > hi_first.lo or (
        lo_first.hi == hi_first.lo and (lo_first.hi_inc or hi_first.lo_inc)
    )
    if not touch:
        return None
    hi, hi_inc = max((ca.hi, ca.hi_inc), (cb.hi, cb.hi_inc))
    merged = AttrConstraint(lo_first.lo, lo_first.lo_inc, hi, hi_inc, None)
    cons = dict(a.constraints)
    cons[t] = merged
    return Conjunction(cons)


class Coverage:
    """Coverage metadata: the extents for which a shared state is complete,
    kept as a merged union of canonical conjunctions (§4.3)."""

    def __init__(self, extents: Iterable[Conjunction] = ()):  # noqa: B008
        self.extents: List[Conjunction] = []
        for e in extents:
            self.add(e)

    def add(self, conj: Conjunction) -> None:
        if conj.is_empty():
            return
        # Drop extents subsumed by the new one, skip if subsumed ourselves.
        kept: List[Conjunction] = []
        for e in self.extents:
            if conj.implies(e):
                return self._merge_fixpoint()  # already covered
            if not e.implies(conj):
                kept.append(e)
        kept.append(conj)
        self.extents = kept
        self._merge_fixpoint()

    def _merge_fixpoint(self) -> None:
        changed = True
        while changed:
            changed = False
            n = len(self.extents)
            for i in range(n):
                for j in range(i + 1, n):
                    m = _try_merge(self.extents[i], self.extents[j])
                    if m is not None:
                        rest = [
                            e for k, e in enumerate(self.extents) if k not in (i, j)
                        ]
                        rest.append(m)
                        self.extents = rest
                        changed = True
                        break
                if changed:
                    break

    def covers(self, conj: Conjunction) -> bool:
        """Prove(conj => coverage): conj must be contained in a single merged
        extent. Sound; incompleteness only loses sharing."""
        return any(conj.implies(e) for e in self.extents)

    def snapshot(self) -> List[Conjunction]:
        return list(self.extents)

    def __repr__(self):
        return f"Coverage({self.extents!r})"


# ---------------------------------------------------------------------------
# Prover entry points (paper notation)
# ---------------------------------------------------------------------------


def prove_implies(p: Pred, q: Pred) -> bool:
    """Prove(P => Q) by canonical containment. Returns False when unproven
    (either predicate outside the supported fragment)."""
    cp = Conjunction.from_pred(p)
    cq = Conjunction.from_pred(q)
    if cp is None or cq is None:
        return False
    return cp.implies(cq)


# ---------------------------------------------------------------------------
# Vectorized evaluation over columnar data
# ---------------------------------------------------------------------------


def evaluate(pred: Pred, cols: Dict[str, np.ndarray]) -> np.ndarray:
    """Evaluate a predicate over columnar numpy data -> bool mask."""
    if pred is TRUE or (isinstance(pred, And) and not pred.children):
        n = len(next(iter(cols.values()))) if cols else 0
        return np.ones(n, dtype=bool)
    if isinstance(pred, And):
        mask = evaluate(pred.children[0], cols)
        for c in pred.children[1:]:
            mask &= evaluate(c, cols)
        return mask
    if isinstance(pred, Cmp):
        col = cols[pred.attr]
        if pred.op == "<":
            return col < pred.value
        if pred.op == "<=":
            return col <= pred.value
        if pred.op == ">":
            return col > pred.value
        if pred.op == ">=":
            return col >= pred.value
        return col == pred.value
    if isinstance(pred, InSet):
        col = cols[pred.attr]
        vals = np.fromiter(pred.values, dtype=np.float64, count=len(pred.values))
        return np.isin(col, vals)
    if isinstance(pred, ColCmp):
        a, b = cols[pred.lhs], cols[pred.rhs]
        if pred.op == "<":
            return a < b
        if pred.op == "<=":
            return a <= b
        if pred.op == ">":
            return a > b
        if pred.op == ">=":
            return a >= b
        if pred.op == "==":
            return a == b
        return a != b
    raise TypeError(f"cannot evaluate predicate node {pred!r}")


def evaluate_conj(conj: Conjunction, cols: Dict[str, np.ndarray]) -> np.ndarray:
    n = len(next(iter(cols.values()))) if cols else 0
    mask = np.ones(n, dtype=bool)
    for attr, c in conj.constraints.items():
        col = cols[attr]
        if c.lo != -math.inf:
            mask &= (col >= c.lo) if c.lo_inc else (col > c.lo)
        if c.hi != math.inf:
            mask &= (col <= c.hi) if c.hi_inc else (col < c.hi)
        if c.members is not None:
            vals = np.fromiter(c.members, dtype=np.float64, count=len(c.members))
            mask &= np.isin(col, vals)
    return mask
