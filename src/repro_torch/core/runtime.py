"""Operational runtime objects for state-centric execution.

The shared execution DAG (§5.1) is realized by three kinds of live objects:

* ``ScanNode`` — a cyclic shared scan over one base table (§4.4). One
  cursor; every attached pipeline receives each emitted morsel. Paths
  attach mid-cycle and complete when the cursor wraps back to their start.
* ``Pipeline`` — a producer or consumer path: source scan -> zero or more
  hash-probe ops -> sink (build into shared state / per-query aggregates).
  One physical pipeline serves many queries ("members"): per-row packed
  visibility bitmasks route every row to exactly the queries whose
  predicates and state lenses admit it (§4.2, §4.6).
* ``Gate`` — a state-readiness gate (§5.3) guarding a member's activation:
  open when the selected state covers the member's assigned extent and all
  residual producer members installed for it have completed.

Morsels are the TPU adaptation of the paper's row fragments (DESIGN.md §2):
every step is a vectorized column-batch operation. The data plane is
*member-major and mask-packed end to end* (DESIGN.md §11): each morsel
carries one ``uint64`` per-row ownership word through every stage, and
per-stage work is independent of the folded member count —

* source + post-join stage filters fuse into interval matrices
  (``FusedBoundFilter``: SIMD compare sweeps, or per-attribute interval
  stabbing past ~8 members/attr);
* probe-stage semijoin visibility is one gather of the matched entries'
  packed lens words + one byte-table translation into pipeline ownership
  bits (``core.visibility.translate_bits``); single-member probes resolve
  the lens in-kernel, multi-member probes take the ``probe_visible_multi``
  kernel that returns the packed words in one launch;
* build-sink tagging for all beneficiaries is two translations feeding the
  single ``bitwise_or.at`` scatter inside ``insert_or_mark``;
* identically-shaped aggregate sinks fold as a cohort in one segmented
  pass keyed by (group id × member bit), scattering per-member partials
  through cached cohort-gid -> accumulator-id maps (``_CohortIndex``).

The pre-§11 per-member loop is retained verbatim
(``EngineConfig(member_major=False)``) as the differential oracle — the
fused path is bit-identical to it in results, pair streams, counters, and
modeled cost. Members beyond the 64-bit packed word (slot overflow) run a
member-at-a-time slow lane that never drops rows.

Partition-parallel execution (DESIGN.md §9): each scan splits its morsel
cycle into P contiguous partition shards with independent cyclic cursors;
the schedulable unit becomes (scan × partition), and members account
delivery per partition (``part_received`` / ``part_need``) so a shard that
wraps early for one member never re-delivers to it. One logical ScanNode
per table is preserved, so grafting/admission is partition-blind; P == 1
degenerates to the seed single-cursor scan exactly.

Member / Pipeline / ScanNode ids are engine-scoped (allocated by the owning
GraftEngine), so repeated engine constructions are isolated — ids never
leak across sessions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..relational.table import Table
from . import trace as _trace
from .hashindex import MultiKeyIndex
from .plans import AggSpec, expr_attrs, expr_eval
from .predicates import AttrConstraint, Conjunction, Pred, TRUE, evaluate, pred_and
from .state import (
    ALL_EXTENTS,
    GrowArray,
    SharedAggregateState,
    SharedHashBuildState,
    _bincount_segment_sum,
)
from .visibility import (
    SlotAllocator,
    bit_of,
    slot_popcounts,
    translate_bits,
    translation_table,
    unpack_slots,
)

U64_1 = np.uint64(1)
U64_0 = np.uint64(0)

# de Bruijn single-bit -> bit-index table (branch-free vectorized log2 for
# the disjoint-ownership fast path of the cohort fold, §11)
_DB64 = np.uint64(0x03F79D71B4CB0A89)
_DB_SHIFT = np.uint64(58)
_DB_TABLE = np.zeros(64, dtype=np.int64)
for _i in range(64):
    _DB_TABLE[(((1 << _i) * 0x03F79D71B4CB0A89) & ((1 << 64) - 1)) >> 58] = _i


def _member_conj(m: "Member"):
    """Cached canonical conjunction of a member's source predicate (None
    when outside the prover fragment)."""
    if not hasattr(m, "_conj_cache"):
        m._conj_cache = Conjunction.from_pred(m.pred)
    return m._conj_cache


# ---------------------------------------------------------------------------
# Key encoding: composite equi-join keys -> single int64 (mixed radix)
# ---------------------------------------------------------------------------


KEY_RADIX = np.int64(1 << 21)  # per-component domain bound (asserted in datagen scale)


def encode_keys(cols: Dict[str, np.ndarray], attrs: Sequence[str]) -> np.ndarray:
    code = np.asarray(cols[attrs[0]], dtype=np.int64)
    for a in attrs[1:]:
        code = code * KEY_RADIX + np.asarray(cols[a], dtype=np.int64)
    return code


def _backend_probe(backend, state, keycodes, counters):
    """Generic pre-visibility probe, handing the engine counter dict to
    backends that attribute their fallbacks by reason (DESIGN.md §13)."""
    if getattr(backend, "probe_accepts_counters", False):
        return backend.probe(state, keycodes, counters=counters)
    return backend.probe(state, keycodes)


def _chain_grant_bounds(conj: Conjunction):
    """Compile a grant's retained conjunction to closed per-attribute
    intervals for the fused-chain kernel, mirroring ``evaluate_conj``
    EXACTLY (§13): a bound equal to its own infinity is *skipped* there
    regardless of inclusivity, so it compiles to the unconstrained band
    rather than an ulp-tightened one; exclusive finite bounds tighten by
    one float64 ulp (``col > v`` == ``col >= nextafter(v)``); membership
    sets compile only at size one. Returns the constrained-attr tuple
    ``((attr, lo, hi), ...)`` or None when the conjunction is not
    interval-compilable in-kernel (the chain then declines with reason
    ``grants``)."""
    bounds = []
    for attr, c in conj.constraints.items():
        lo, hi = -math.inf, math.inf
        if c.lo != -math.inf:
            if math.isnan(c.lo) or (not c.lo_inc and c.lo == math.inf):
                return None
            lo = c.lo if c.lo_inc else float(np.nextafter(c.lo, math.inf))
        if c.hi != math.inf:
            if math.isnan(c.hi) or (not c.hi_inc and c.hi == -math.inf):
                return None
            hi = c.hi if c.hi_inc else float(np.nextafter(c.hi, -math.inf))
        if c.members is not None:
            if len(c.members) != 1:
                return None
            v = float(next(iter(c.members)))
            if math.isnan(v):
                return None  # isin never admits NaN; not an interval
            lo, hi = max(lo, v), min(hi, v)
        if lo == -math.inf and hi == math.inf:
            continue  # evaluate_conj skips both checks: unconstrained
        bounds.append((attr, lo, hi))
    return tuple(bounds)


# ---------------------------------------------------------------------------
# Fused multi-member source filter (DESIGN.md §8)
# ---------------------------------------------------------------------------


def _bounds_of_conj(conj: Optional[Conjunction]):
    """Per-attribute inclusive [lo, hi] intervals of a canonical
    conjunction (membership sets of size one become point intervals;
    exclusive bounds tighten by one float64 ulp so a single inclusive
    compare is exact), or None when any constraint is not an interval.

    Bounds live in float64 — exact over the engine's float64 column
    domain (every table column, see relational.table). Integer columns
    with values beyond 2^53 would lose the int-exact comparison the
    per-predicate ``evaluate`` path performs; such domains must not fuse.
    """
    if conj is None:
        return None
    bounds: Dict[str, Tuple[float, float]] = {}
    for attr, c in conj.constraints.items():
        if c.members is not None and len(c.members) != 1:
            return None
        lo = c.lo if c.lo_inc else np.nextafter(c.lo, math.inf)
        hi = c.hi if c.hi_inc else np.nextafter(c.hi, -math.inf)
        if c.members is not None:
            v = next(iter(c.members))
            lo, hi = max(lo, v), min(hi, v)
        bounds[attr] = (lo, hi)
    return bounds


def _pack_bound_matrices(pairs):
    """[(member, bounds)] -> (attrs, lo[M, A], hi[M, A]) SoA matrices."""
    attrs = sorted({a for _, b in pairs for a in b})
    lo = np.full((len(pairs), len(attrs)), -math.inf)
    hi = np.full((len(pairs), len(attrs)), math.inf)
    for i, (_, bounds) in enumerate(pairs):
        for j, a in enumerate(attrs):
            if a in bounds:
                lo[i, j], hi[i, j] = bounds[a]
    return attrs, lo, hi


def member_bound_matrices(members: Sequence["Member"]):
    """SoA bound matrices for the fused source-predicate pass.

    A member fuses when its predicate canonicalizes into per-attribute
    intervals. Returns ``(attrs, lo[M,A], hi[M,A], fused, slow)`` where
    ``slow`` members fall back to per-member evaluation."""
    pairs = []
    slow: List["Member"] = []
    for m in members:
        bounds = _bounds_of_conj(_member_conj(m))
        if bounds is None:
            slow.append(m)
        else:
            pairs.append((m, bounds))
    attrs, lo, hi = _pack_bound_matrices(pairs)
    return attrs, lo, hi, [m for m, _ in pairs], slow


def stage_filter_matrices(members: Sequence["Member"], stage: int):
    """Fused bound matrices for the members' post-join filters at one probe
    stage — the §11 generalization of ``member_bound_matrices`` beyond the
    source stage. Members whose filter conjunction does not canonicalize to
    intervals (e.g. Q5's column-equality) fall back to per-member
    evaluation; members with no filter at this stage are ignored."""
    pairs = []
    slow: List["Member"] = []
    for m in members:
        preds = m.stage_filters.get(stage, ())
        if not preds:
            continue
        bounds = _bounds_of_conj(Conjunction.from_pred(pred_and(*preds)))
        if bounds is None:
            slow.append(m)
        else:
            pairs.append((m, bounds))
    attrs, lo, hi = _pack_bound_matrices(pairs)
    return attrs, lo, hi, [m for m, _ in pairs], slow


class FusedBoundFilter:
    """Compiled fused member filter over per-attribute interval bounds.

    Two evaluation strategies, bit-identical on every finite input:

    * **Interval stabbing** (member count >= STAB_FACTOR × attrs): each
      attribute's [lo, hi] intervals become a sorted boundary array + a
      prefix-XOR segment-mask table (closed intervals turned half-open by
      one float64 ulp, so coverage is exact); a row's admitted-member word
      is one ``searchsorted`` + one gather — per-row cost O(log members),
      not O(members). Columns containing non-finite values fall back (NaN
      ordering under searchsorted differs from comparison semantics).
    * **SoA compare matrix** (small member counts / fallback): scalar-bound
      sweeps per attribute with a per-member OR-reduction. SIMD compares
      have a far lower per-element constant than binary search, so the
      crossover grows with the attribute count (measured ~8 members/attr).
    """

    STAB_FACTOR = 8

    __slots__ = ("attrs", "lo", "hi", "bitvals", "_all_mask", "_stab", "_con")

    def __init__(self, attrs: Sequence[str], lo: np.ndarray, hi: np.ndarray,
                 bitvals: np.ndarray):
        self.attrs = tuple(attrs)
        self.lo = lo
        self.hi = hi
        self.bitvals = bitvals
        self._all_mask = np.uint64(np.bitwise_or.reduce(bitvals)) if len(bitvals) else np.uint64(0)
        # which (member, attr) cells carry a real constraint: a member with
        # no constraint on an attribute admits every row of it — including
        # NaN, matching per-predicate ``evaluate`` semantics
        self._con = (lo != -math.inf) | (hi != math.inf)
        self._stab = None
        m = len(bitvals)
        if self.attrs and m >= self.STAB_FACTOR * len(self.attrs):
            stab = []
            for j in range(len(self.attrs)):
                lo_j = lo[:, j]
                # closed [lo, hi] == half-open [lo, nextafter(hi)); empty
                # intervals collapse (toggle on+off at one coordinate)
                hi_plus = np.maximum(np.nextafter(hi[:, j], math.inf), lo_j)
                coords = np.concatenate([lo_j, hi_plus])
                masks = np.concatenate([bitvals, bitvals])
                order = np.argsort(coords, kind="stable")
                seg = np.zeros(len(coords) + 1, dtype=np.uint64)
                np.bitwise_xor.accumulate(masks[order], out=seg[1:])
                stab.append((coords[order], seg))
            self._stab = stab

    def __call__(self, n: int, cols: Dict[str, np.ndarray]) -> np.ndarray:
        m = len(self.bitvals)
        if not m:
            return np.zeros(n, dtype=np.uint64)
        if not self.attrs:
            return np.full(n, self._all_mask, dtype=np.uint64)
        if self._stab is not None:
            bits = None
            for j, a in enumerate(self.attrs):
                col = cols[a]
                if not np.isfinite(col).all():
                    break
                bounds, seg = self._stab[j]
                w = seg[np.searchsorted(bounds, col, side="right")]
                bits = w if bits is None else bits & w
            else:
                return bits
        ok = None
        buf = np.empty((m, n), dtype=bool)
        for j, a in enumerate(self.attrs):
            col = cols[a]
            aj = np.greater_equal(col, self.lo[:, j, None])
            np.less_equal(col, self.hi[:, j, None], out=buf)
            np.logical_and(aj, buf, out=aj)
            if not self._con[:, j].all() and np.isnan(col).any():
                # NaN fails every compare, but members that do not
                # constrain this attribute must still admit the row
                np.logical_or(aj, ~self._con[:, j, None], out=aj)
            ok = aj if ok is None else np.logical_and(ok, aj, out=ok)
        bits = np.zeros(n, dtype=np.uint64)
        for i in range(m):
            bits |= ok[i] * self.bitvals[i]
        return bits


def fused_bound_bits(
    n: int,
    cols: Dict[str, np.ndarray],
    attrs: Sequence[str],
    lo: np.ndarray,
    hi: np.ndarray,
    bitvals: np.ndarray,
) -> np.ndarray:
    """One-shot form of :class:`FusedBoundFilter` (the pipeline caches the
    compiled filter per wave; standalone callers pay the compile per call)."""
    return FusedBoundFilter(attrs, lo, hi, bitvals)(n, cols)


# ---------------------------------------------------------------------------
# Gates (§5.3)
# ---------------------------------------------------------------------------


class Gate:
    """State-readiness gate for one admitted state-ref edge r=(q, b, v).

    open iff stateReady(S, r, R): the selected state covers the assigned
    extent (coverage restricted to the grant's allowed provenance extents
    when the attachment is represented) and every residual producer member
    installed for this edge has completed."""

    def __init__(
        self,
        state: SharedHashBuildState,
        conj: Optional[Conjunction],
        allowed_emask: Optional[np.uint64] = None,
    ):
        self.state = state
        self.conj = conj
        self.allowed_emask = allowed_emask
        self.pending: set = set()  # producer Member objects still owed
        self._open_cache = False
        # owning query (stamped at resolve_boundary): producer handoff
        # (§16) reads it to find the surviving beneficiaries of a doomed
        # producer — a gate's owner is the query its edge serves.
        self.owner_qid: Optional[int] = None

    def open(self) -> bool:
        if self._open_cache:
            return True
        if self.pending:
            return False
        if self.conj is not None and self.allowed_emask is not None:
            if not self.state.covers_with(self.conj, self.allowed_emask):
                return False
        self._open_cache = True
        return True

    def partition_frontier(self) -> Tuple[int, int]:
        """(delivered, total) scan-partition units across this gate's
        pending producers — the per-partition visibility frontier of §9.
        A closed gate at (k, n) has k of n producer shards fully delivered;
        (n, n) means only the coverage check remains. Open gates report
        their last frontier as fully delivered."""
        done = total = 0
        for m in self.pending:
            d, t = self.state.extent_partition_frontier(m.eid)
            # a producer that has not begun reports its shard count as owed
            if t == 0 and m.part_need is not None:
                t = len(m.part_need)
            done += d
            total += t
        return (done, total)


class AggGate:
    """Readiness of a shared aggregate state under exact identity (§4.5)."""

    def __init__(self, agg_state: SharedAggregateState):
        self.agg_state = agg_state

    def open(self) -> bool:
        return self.agg_state.complete


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------


@dataclass
class BuildTarget:
    """Pipeline-level sink: insert produced rows into a shared hash-build
    state, with visibility + extent provenance combined across members."""

    state: SharedHashBuildState
    key_attrs: Tuple[str, ...]


@dataclass
class AggSink:
    """Per-member sink: fold the member's visible rows into (possibly
    shared) aggregate state."""

    agg_state: SharedAggregateState
    group_keys: Tuple[str, ...]
    aggs: Tuple[AggSpec, ...]


# ---------------------------------------------------------------------------
# Members
# ---------------------------------------------------------------------------


class Member:
    """One query's participation in a pipeline (an active node-query pair in
    Algorithm 2's sense). ``beneficiaries`` supports QPipe-style merged
    identical profiles: one physical member tagging several queries.
    ``mid`` is allocated by the owning engine (no class-counter leaks)."""

    def __init__(
        self,
        mid: int,
        qid: int,
        pred: Pred,
        gates: List[Gate],
        sink: Optional[AggSink] = None,
        stage_filters: Optional[Dict[int, List[Pred]]] = None,
        kind: str = "main",  # 'main' | 'ordinary' | 'residual'
        eid: int = -1,
        conj: Optional[Conjunction] = None,
        beneficiaries: Optional[List[int]] = None,
    ):
        self.mid = mid
        self.qid = qid
        self.pred = pred
        self.gates = gates
        self.sink = sink
        self.stage_filters = stage_filters or {}
        self.kind = kind
        self.eid = eid
        self.conj = conj
        self.beneficiaries = beneficiaries or [qid]
        # §16 producer handoff: the qid whose state lens this member probes
        # with. Equal to ``qid`` except for adopted replacement members,
        # which continue a dead query's delivery obligation and must
        # observe upstream states through the dead query's exact lens
        # (slot visibility + grants) to reproduce its rows bit-identically.
        self.lens_qid = qid

        self.active = False
        self.done = False
        self.received = 0
        self.need = 0
        # per-partition delivery accounting (set at activation; §9): the
        # member finishes partition p after part_need[p] morsels from shard
        # p, and finishes overall when received reaches need (their sum)
        self.part_received: Optional[np.ndarray] = None
        self.part_need: Optional[np.ndarray] = None
        self.t_activated = 0.0  # activation barrier time (worker-clock merge)
        self.slot = -1  # pipeline-local bit slot
        self.rows_sunk = 0
        self.waiting_gates: List[Gate] = []  # gates whose pending set holds us
        self.pipeline: Optional["Pipeline"] = None

    @property
    def bitval(self) -> np.uint64:
        return U64_1 << np.uint64(self.slot)

    def activatable(self) -> bool:
        return (not self.active) and (not self.done) and all(g.open() for g in self.gates)

    def pending_in(self, part: int) -> bool:
        """Still owed morsels from scan partition ``part``."""
        if self.part_received is None:
            return True
        return self.part_received[part] < self.part_need[part]


# ---------------------------------------------------------------------------
# Probe op
# ---------------------------------------------------------------------------


@dataclass
class ProbeOp:
    state: SharedHashBuildState
    probe_attrs: Tuple[str, ...]
    payload: Tuple[str, ...]  # entry attrs (canonical names in the state)
    out_names: Tuple[str, ...] = ()  # names in the row stream (renames)

    def __post_init__(self):
        if not self.out_names:
            self.out_names = tuple(self.payload)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


class _CohortIndex:
    """Pipeline-persistent shared group index for one aggregate cohort
    (§11): one batched lookup per morsel maps the cohort's group-key rows
    to cohort-local dense gids; per-(member, partition) translation arrays
    then turn cohort gids into member-local accumulator ids, so the
    steady-state per-member residue is a gather + scatter — no hashing."""

    __slots__ = ("_idx", "_gvals", "maps")

    def __init__(self, n_keys: int):
        self._idx = MultiKeyIndex(n_keys) if n_keys else None
        # per-gid key values, created lazily with the columns' ORIGINAL
        # dtypes: a member's accumulator index keys integer columns by
        # value and floats by bit pattern, so a float64 cast here would
        # assign different ids than the row-level `update` path
        self._gvals: Optional[List[GrowArray]] = None
        self.maps: Dict[tuple, np.ndarray] = {}  # (mid, part) -> local gid

    def resolve(self, key_cols: List[np.ndarray], n: int):
        """(cohort gids for the rows, per-gid key values, n groups)."""
        if self._idx is None:
            return np.zeros(n, dtype=np.int64), [], 1
        gids, is_new = self._idx.lookup_or_insert(key_cols)
        if self._gvals is None:
            self._gvals = [GrowArray(np.asarray(c).dtype) for c in key_cols]
        if is_new.any():
            firsts = np.flatnonzero(is_new)
            for c, gv in zip(key_cols, self._gvals):
                gv.append(np.asarray(c)[firsts])
        return gids, [gv.data for gv in self._gvals], self._idx.n

    def member_map(self, mid: int, part: int, ng: int) -> np.ndarray:
        """Cohort gid -> member-local accumulator id (-1 = unmapped)."""
        key = (mid, part)
        cur = self.maps.get(key)
        if cur is None or len(cur) < ng:
            grown = np.full(ng, -1, dtype=np.int64)
            if cur is not None:
                grown[: len(cur)] = cur
            self.maps[key] = cur = grown
        return cur

    def release(self, mid: int) -> None:
        """Drop a finished member's gid maps (all partitions)."""
        for key in [k for k in self.maps if k[0] == mid]:
            del self.maps[key]


class Pipeline:
    def __init__(
        self,
        pid: int,
        key,
        source: "ScanNode",
        ops: List[ProbeOp],
        build_target: Optional[BuildTarget] = None,
        compose_did: bool = False,
        counters: Optional[Dict] = None,
    ):
        self.pid = pid
        self.key = key
        self.source = source
        self.ops = ops
        self.build_target = build_target
        self.compose_did = compose_did
        self.members: List[Member] = []
        self.slots = SlotAllocator()
        self._counters = counters
        # per-wave plan caches, keyed by the active member set (with
        # partitions the set differs per shard near completion)
        self._filter_plans: Dict[tuple, tuple] = {}
        self._mm_plans: Dict[tuple, dict] = {}
        # shared cohort group indexes + member gid maps (§11) — persistent
        # across waves (a member's accumulator mapping outlives wave churn)
        self._cohort_state: Dict[tuple, _CohortIndex] = {}
        source.attach(self)

    # -- membership ---------------------------------------------------------
    def add_member(self, m: Member) -> None:
        """Assign the member a packed-word bit slot, or route it to the
        overflow slow lane (slot == -1) when all 64 bits of the pipeline
        word are taken (§11: overflow members are processed member-at-a-time
        on a plain boolean mask — sound, never silently dropped)."""
        slot = self.slots.try_get(m.mid)
        if slot is None:
            m.slot = -1
            if self._counters is not None:
                self._counters["overflow_members"] += 1
        else:
            m.slot = slot
        self.members.append(m)

    def release_member(self, m: Member) -> None:
        """Drop a finished member's cohort gid maps (§11): long-lived
        shared pipelines (open-loop serving) must not accumulate
        per-member cache state. A cohort index with no mapped members is
        dropped entirely (rebuilt on demand), bounding ``_cohort_state``
        by the live membership."""
        for ck, ci in list(self._cohort_state.items()):
            ci.release(m.mid)
            if not ci.maps:
                del self._cohort_state[ck]

    def active_members(self) -> List[Member]:
        return [m for m in self.members if m.active and not m.done]

    def active_members_for(self, part: int) -> List[Member]:
        """Active members still owed morsels from scan partition ``part``."""
        return [m for m in self.members if m.active and not m.done and m.pending_in(part)]

    def progress(self) -> int:
        return max((m.received for m in self.members), default=0)

    def all_done(self) -> bool:
        return all(m.done for m in self.members)

    # -- execution ----------------------------------------------------------
    def _source_bits(self, act: List[Member], cols, n: int, engine) -> np.ndarray:
        """Per-member source predicates -> packed row bitmask, via one fused
        SoA bound-check pass (per-wave matrices cached on the pipeline);
        members outside the interval fragment evaluate individually."""
        key = tuple((m.mid, m.slot) for m in act)
        plan = self._filter_plans.get(key)
        if plan is None:
            attrs, lo, hi, fused, slow = member_bound_matrices(act)
            bitvals = np.array([m.bitval for m in fused], dtype=np.uint64)
            plan = (FusedBoundFilter(attrs, lo, hi, bitvals), fused, slow)
            if len(self._filter_plans) > 64:  # bounded: waves churn members
                self._filter_plans.clear()
            self._filter_plans[key] = plan
        ff, fused, slow = plan
        bits = ff(n, cols)
        engine.counters["fused_filter_rows"] += n * len(fused)
        for m in slow:
            mask = evaluate(m.pred, cols)
            bits |= np.where(mask, m.bitval, U64_0)
        return bits

    def _member_major_plan(self, act: List[Member]) -> dict:
        """Per-wave member-major execution plan (§11), cached on the active
        member set: per-stage lens translation tables + grant fallbacks,
        fused stage-filter matrices, sink tag tables, and aggregate
        cohorts. Beneficiary counts key the cache because qpipe merges can
        extend a zero-progress member's beneficiary list mid-wave."""
        key = tuple((m.mid, m.slot, len(m.beneficiaries)) for m in act)
        plan = self._mm_plans.get(key)
        if plan is not None:
            return plan
        stages = []
        filters = []
        for stage, op in enumerate(self.ops):
            # lens targets: state slot -> pipeline ownership bit. Members
            # with extent-scoped grants need predicate evaluation on entry
            # columns — they keep the per-member lens; members with no slot
            # and no grants can never see an entry (no target bit).
            target = np.zeros(64, dtype=np.uint64)
            grant_members: List[Member] = []
            kernelable = True
            for m in act:
                if op.state.grants.get(m.lens_qid):
                    grant_members.append(m)
                    kernelable = False
                    continue
                slot = op.state.slots.peek(m.lens_qid)
                if slot is not None:
                    # any slot 0..63 serves: the kernel lens mirrors are
                    # (lo, hi) uint32 pairs (DESIGN.md §13)
                    target[slot] |= m.bitval
            stages.append((translation_table(target), tuple(grant_members), kernelable))
            attrs, lo, hi, fused, slow = stage_filter_matrices(act, stage)
            fmask = np.uint64(0)
            for m in fused:
                fmask |= m.bitval
            bitvals = np.array([m.bitval for m in fused], dtype=np.uint64)
            filters.append(
                (FusedBoundFilter(attrs, lo, hi, bitvals), len(fused), fmask, tuple(slow))
            )
        plan = {"stages": stages, "filters": filters}
        if self.build_target is not None:
            bt = self.build_target
            tvis = np.zeros(64, dtype=np.uint64)
            tem = np.zeros(64, dtype=np.uint64)
            for m in act:
                w = np.uint64(0)
                for b in m.beneficiaries:
                    w |= bt.state.slots.mask(b)
                tvis[m.slot] = w
                if m.eid >= 0:
                    tem[m.slot] = U64_1 << np.uint64(m.eid)
            plan["sink"] = (translation_table(tvis), translation_table(tem))
        # aggregate cohorts: members with identically-shaped sinks fold in
        # one segmented pass; distinct aggs take the per-member path
        # (count-distinct dedups through per-state seen-pair indexes)
        cohorts: Dict[tuple, List[Member]] = {}
        for m in act:
            if m.sink is None:
                continue
            s = m.sink
            ck = (s.group_keys, tuple((a.func, a.distinct, repr(a.expr)) for a in s.aggs))
            cohorts.setdefault(ck, []).append(m)
        plan["cohorts"] = [
            (
                ck,
                ms,
                not any(a.distinct for a in ms[0].sink.aggs),
                # columns the fold actually reads: group keys + expr attrs
                tuple(
                    dict.fromkeys(
                        list(ms[0].sink.group_keys)
                        + [
                            attr
                            for a in ms[0].sink.aggs
                            if a.expr is not None
                            for attr in sorted(expr_attrs(a.expr))
                        ]
                    )
                ),
            )
            for ck, ms in cohorts.items()
        ]
        plan["chain"] = self._build_chain_plan(act, plan)
        if len(self._mm_plans) > 64:  # bounded: waves churn members
            self._mm_plans.clear()
        self._mm_plans[key] = plan
        return plan

    def _build_chain_plan(self, act: List[Member], plan: dict):
        """Compile the wave's stage chain for one fused device launch
        (DESIGN.md §13), or record why it cannot fuse.

        Per stage: the chain lens translation table (unlike the staged
        tables it INCLUDES grant members' slot bits — ``visible_mask`` ORs
        the slot bit with the grants, and the kernel does the same), key
        sourcing resolved through the running payload environment (source
        columns stay per-row host keys; a single payload-origin key gathers
        from the origin stage's entry-indexed device key mirror), compiled
        grant intervals, and the fused filter matrices with their operand
        sourcing. Static declines return ``{"ok": False, "reason": ...}``
        so the dispatcher counts them per reason: non-interval grants
        (``grants``), slow stage-filter members (``predicate``),
        mixed/composite payload-origin keys (``keyrange``)."""
        if not self.ops:
            return None
        n_members = len(act)
        env: Dict[str, tuple] = {}
        reason = None
        stages_meta = []
        for stage, op in enumerate(self.ops):
            refs = [env.get(a) for a in op.probe_attrs]
            if all(r is None for r in refs):
                key = ("host", tuple(op.probe_attrs))
            elif len(refs) == 1:
                key = refs[0]
            else:
                # composite keys with payload-origin components would need
                # the radix encode on device — not worth a kernel variant
                key = None
                reason = reason or "keyrange"
            target = np.zeros(64, dtype=np.uint64)
            grants = []
            n_grant_members = 0
            for m in act:
                slot = op.state.slots.peek(m.lens_qid)
                if slot is not None:
                    target[slot] |= m.bitval
                gs = op.state.grants.get(m.lens_qid)
                if gs:
                    n_grant_members += 1
                    for allowed, conj in gs:
                        b = _chain_grant_bounds(conj)
                        if b is None or any(
                            a not in op.state.cols for a, _, _ in b
                        ):
                            reason = reason or "grants"
                        else:
                            grants.append((m.bitval, np.uint64(allowed), b))
            ff, n_fused, fmask, slow = plan["filters"][stage]
            if slow:
                reason = reason or "predicate"
            # payload outputs shadow the environment BEFORE filter operand
            # resolution (stage filters run on the post-gather columns)
            for a, out in zip(op.payload, op.out_names):
                env[out] = ("entry", stage, a)
            fmeta = None
            if n_fused and ff.attrs:
                if np.isnan(ff.lo).any() or np.isnan(ff.hi).any():
                    reason = reason or "predicate"
                frefs = []
                for a in ff.attrs:
                    r = env.get(a)
                    frefs.append(("host", a) if r is None else r)
                fmeta = {
                    "attrs": tuple(frefs),
                    "lo": ff.lo,
                    "hi": ff.hi,
                    "con": ff._con,
                    "bitvals": ff.bitvals,
                    "n_members": n_fused,
                }
            # post-visibility accounting iff the staged path would have
            # taken the single-member fused-lens probe for this stage
            use_post = (
                n_members == 1
                and n_grant_members == 0
                and op.state.slots.peek(act[0].lens_qid) is not None
            )
            stages_meta.append(
                {
                    "state": op.state,
                    "tables": translation_table(target),
                    "key": key,
                    "grants": tuple(grants),
                    "n_grant_members": n_grant_members,
                    "use_post": use_post,
                    "filter": fmeta,
                }
            )
        if reason is not None:
            return {"ok": False, "reason": reason}
        needed = set()
        if self.build_target is not None:
            bt = self.build_target
            needed |= set(bt.key_attrs) | set(bt.state.retained_attrs)
        for _ck, _ms, _fold, ncols in plan["cohorts"]:
            needed |= set(ncols)
        return {
            "ok": True,
            "n_members": n_members,
            "stages": stages_meta,
            "sink": plan.get("sink"),
            "env": dict(env),
            "needed": tuple(sorted(needed)),
            "_dev": {},
        }

    def process(
        self, engine, cols: Dict[str, np.ndarray], row_ids: np.ndarray, part: int = 0
    ) -> float:
        """Run one morsel of scan partition ``part`` through the pipeline
        for every member still owed that shard. Returns the modeled cost
        (seconds) of the work performed.

        Members with a packed-word bit slot run the member-major fused
        path (§11) — or the retained per-member oracle path when the
        engine disables ``member_major``; slot-overflow members (beyond the
        64-bit word) run the member-at-a-time slow lane."""
        tr = _trace.active
        if tr is not None:
            span = tr.open("morsel")
        act = self.active_members_for(part)
        if not act:
            if tr is not None:
                tr.close(span)
            return 0.0
        if tr is not None:
            tr.tag(span, len(act))
        packed = [m for m in act if m.slot >= 0]
        overflow = [m for m in act if m.slot < 0]
        cost = 0.0
        if packed:
            if getattr(engine, "member_major", True):
                cost += self._process_packed_fused(engine, packed, cols, row_ids, part)
            else:
                cost += self._process_packed_members(engine, packed, cols, row_ids, part)
        for m in overflow:
            cost += self._process_overflow(engine, m, cols, row_ids, part)
        # morsel accounting (per partition, §9)
        finished: List[Member] = []
        for m in act:
            m.received += 1
            if m.part_received is not None:
                m.part_received[part] += 1
                if m.part_received[part] >= m.part_need[part]:
                    engine.on_member_part_finished(self, m, part)
            if m.received >= m.need:
                m.done = True
                m.active = False
                finished.append(m)
        for m in finished:
            engine.on_member_finished(self, m)
        if tr is not None:
            tr.close(span)
        return cost

    # -- member-major fused path (§11) --------------------------------------
    def _process_packed_fused(
        self, engine, act: List[Member], cols, row_ids: np.ndarray, part: int
    ) -> float:
        """One morsel through every stage as packed uint64 mask
        transformations — per-stage cost independent of the member count:
        semijoin visibility is one lens-word translation, stage filters are
        one fused bound-check, sink tagging is one translate + scatter, and
        aggregate cohorts fold via one (group × member) segmented pass.

        Traced as three spans: ``morsel.filter`` (plan, source bits,
        compaction), ``morsel.probe`` (the chain or the staged loop) and
        ``morsel.sink`` (build sink or aggregate cohorts)."""
        n = len(row_ids)
        cm = engine.cost_model
        cost = 0.0
        tr = _trace.active
        if tr is not None:
            span = tr.open("morsel.filter", n)
        plan = self._member_major_plan(act)

        bits = self._source_bits(act, cols, n, engine)
        cost += cm["filter"] * n * len(act)

        keep = np.flatnonzero(bits)
        cols = {k: v[keep] for k, v in cols.items()}
        bits = bits[keep]
        did = row_ids[keep].astype(np.int64)

        # mesh execution (§14): record the morsel's first-stage repartition
        # in the per-device histogram — stage-0 keys are identical whether
        # the chain or the staged loop serves the morsel, so the histogram
        # is backend-independent
        if engine.mesh_plan is not None and self.ops and len(did) > 0:
            engine.mesh_plan.note_morsel(encode_keys(cols, self.ops[0].probe_attrs))
        if tr is not None:
            tr.close(span)
            span = tr.open("morsel.probe", len(did))

        backend = engine.backend
        served = False
        chain_sink = None
        cplan = plan.get("chain")
        probe_chain = (
            getattr(backend, "probe_chain", None) if backend is not None else None
        )
        if cplan is not None and probe_chain is not None and len(did) > 0:
            if cplan["ok"]:
                # one fused launch for the whole stage chain (§13); host
                # keys validated backend-side over the full morsel — any
                # dynamic decline falls through to the staged loop below
                host_keys = {
                    si: encode_keys(cols, st["key"][1])
                    for si, st in enumerate(cplan["stages"])
                    if st["key"][0] == "host"
                }
                res = probe_chain(
                    cplan, cols, bits, host_keys, counters=engine.counters
                )
                if res is not None:
                    engine.counters["kernel_chain_launches"] += 1
                    cost, cols, bits, did, chain_sink = self._replay_chain(
                        engine, plan, cplan, res, cols, did, cost
                    )
                    served = True
            else:
                backend.note_fallback(cplan["reason"], engine.counters)
        for stage, op in enumerate(self.ops):
            if served or len(did) == 0:
                break
            keycodes = encode_keys(cols, op.probe_attrs)
            vis_tables, grant_members, kernelable = plan["stages"][stage]
            lens_fused = False
            words = None
            if backend is not None:
                if len(act) == 1 and not grant_members:
                    probe_visible = getattr(backend, "probe_visible", None)
                    if probe_visible is not None:
                        fused_pair = probe_visible(op.state, keycodes, act[0].lens_qid)
                        if fused_pair is not None:
                            probe_idx, entry_idx = fused_pair
                            lens_fused = True
                            engine.counters["kernel_lens_probes"] += 1
                elif kernelable and len(act) > 1:
                    # multi-member lens: one launch returns every probing
                    # member's ownership word (the matched entry's packed
                    # visibility word), translated below
                    probe_multi = getattr(backend, "probe_visible_multi", None)
                    if probe_multi is not None:
                        trip = probe_multi(op.state, keycodes)
                        if trip is not None:
                            probe_idx, entry_idx, words = trip
                            engine.counters["kernel_multi_lens_probes"] += 1
                if not lens_fused and words is None:
                    probe_idx, entry_idx = _backend_probe(
                        backend, op.state, keycodes, engine.counters
                    )
            else:
                probe_idx, entry_idx = op.state.probe(keycodes)
            if engine.mesh_plan is not None:
                # §14: probe rows cross the bucketed all_to_all to their
                # key shard's device before the shard-local probe
                xr = engine.mesh_plan.exchange_rows(len(keycodes))
                cost += cm["exchange"] * xr
                engine.counters["mesh_exchange_rows"] += xr
            cost += cm["probe"] * len(keycodes) + cm["match"] * len(probe_idx)
            engine.counters["probe_rows"] += len(keycodes)
            bits_in = bits[probe_idx]
            if lens_fused:
                new_bits = bits_in & act[0].bitval
            else:
                if words is None:
                    words = op.state.vis.data[entry_idx]
                vis_pl = translate_bits(words, vis_tables)
                for m in grant_members:
                    vm = op.state.visible_mask(m.lens_qid, entry_idx)
                    vis_pl = vis_pl | np.where(vm, m.bitval, U64_0)
                new_bits = bits_in & vis_pl
                engine.counters["fused_vis_rows"] += len(probe_idx) * (
                    len(act) - len(grant_members)
                )
            cols = {k: v[probe_idx] for k, v in cols.items()}
            for a, out in zip(op.payload, op.out_names):
                cols[out] = op.state.cols[a].data[entry_idx]
            if self.compose_did:
                did = did[probe_idx] * np.int64(op.state.did_domain) + op.state.did.data[entry_idx]
            else:
                did = did[probe_idx]
            bits = new_bits
            # post-join stage filters: one fused bound-check over all
            # interval-canonical members (§11); the rest evaluate per-member
            ff, n_fused, fmask, slow = plan["filters"][stage]
            if n_fused:
                fbits = ff(len(bits), cols)
                bits = bits & (~fmask | fbits)
                engine.counters["fused_stage_filter_rows"] += len(bits) * n_fused
            for m in slow:
                for p in m.stage_filters.get(stage, ()):  # e.g. Q5 ColEq
                    bm = bit_of(bits, m.slot) & evaluate(p, cols)
                    bits = (bits & ~m.bitval) | np.where(bm, m.bitval, U64_0)
            keep = np.flatnonzero(bits)
            if len(keep) != len(bits):
                cols = {k: v[keep] for k, v in cols.items()}
                did = did[keep]
                bits = bits[keep]

        if tr is not None:
            tr.close(span)
            span = tr.open("morsel.sink", len(did))
        # sinks
        if self.build_target is not None and len(did) > 0:
            bt = self.build_target
            if chain_sink is not None:
                # chain launches translate the sink words in-kernel and
                # return per-slot survivor counts alongside (§13)
                vismask, emask, counts = chain_sink
            else:
                vis_tables, em_tables = plan["sink"]
                # all beneficiaries of all members tag in ONE translate +
                # one bitwise_or.at scatter inside insert_or_mark (§11)
                vismask = translate_bits(bits, vis_tables)
                emask = translate_bits(bits, em_tables)
                counts = slot_popcounts(bits)
            engine.counters["fused_sink_rows"] += len(bits)
            idx = np.flatnonzero(vismask)
            if len(idx):
                keycodes = encode_keys(cols, bt.key_attrs)
                ins, mrk = bt.state.insert_or_mark(
                    did[idx],
                    keycodes[idx],
                    {a: cols[a][idx] for a in bt.state.retained_attrs},
                    vismask[idx],
                    emask[idx],
                )
                cost += cm["insert"] * ins + cm["mark"] * mrk
            for m in act:
                nsel = int(counts[m.slot])
                m.rows_sunk += nsel
                key = "residual_build_rows" if m.kind == "residual" else "ordinary_build_rows"
                engine.counters[key] += nsel * len(m.beneficiaries)
        else:
            nsel_of: Dict[int, int] = {}
            for ck, ms, fold, needed in plan["cohorts"]:
                if len(did) == 0:
                    break
                if fold and len(ms) > 1:
                    self._agg_fold_cohort(engine, ck, ms, needed, cols, bits, part, nsel_of)
                else:
                    for m in ms:
                        sel = bit_of(bits, m.slot)
                        nsel = int(sel.sum())
                        if nsel == 0:
                            continue
                        scols = {k: v[sel] for k, v in cols.items()}
                        self._agg_sink_rows(engine, m, scols, nsel, part)
                        nsel_of[m.mid] = nsel
            # accumulate modeled agg cost in member order so the running
            # float sum is bit-identical to the per-member oracle path
            for m in act:
                if m.sink is not None and nsel_of.get(m.mid):
                    cost += cm["agg"] * nsel_of[m.mid]
        if tr is not None:
            tr.close(span)
        return cost

    def _replay_chain(self, engine, plan: dict, cplan: dict, res, cols, did, cost):
        """Fold one chain launch's results back into the morsel loop's
        contract: replay the staged loop's modeled cost and row counters
        from the kernel's per-stage (alive, matched, matched_visible)
        stats, then reconstruct the surviving rows' columns and provenance
        host-side from the returned entry indices. Every formula mirrors a
        line of the staged loop — including threading the RUNNING morsel
        cost through the per-stage adds, since float summation order is
        part of the virtual-clock contract — so the clock and ROW counters
        stay bit-identical whether a wave runs fused or staged (§13)."""
        cm = engine.cost_model
        n_members = cplan["n_members"]
        stats = res["stats"]
        for s, st in enumerate(cplan["stages"]):
            alive = int(stats[s, 0])
            if alive == 0:
                # the staged loop breaks before probing an empty morsel
                break
            # post-visibility match counts iff the staged path would have
            # probed through the single-member fused lens
            matched = int(stats[s, 2] if st["use_post"] else stats[s, 1])
            if engine.mesh_plan is not None:
                # mirrors the staged loop's §14 exchange charge (same
                # summation order — virtual clocks stay bit-identical
                # whether the chain or the staged loop served the morsel)
                xr = engine.mesh_plan.exchange_rows(alive)
                cost += cm["exchange"] * xr
                engine.counters["mesh_exchange_rows"] += xr
            cost += cm["probe"] * alive + cm["match"] * matched
            engine.counters["probe_rows"] += alive
            if st["use_post"]:
                engine.counters["kernel_lens_probes"] += 1
            else:
                engine.counters["kernel_multi_lens_probes"] += 1
                engine.counters["fused_vis_rows"] += int(stats[s, 1]) * (
                    n_members - st["n_grant_members"]
                )
            n_fused = plan["filters"][s][1]
            if n_fused:
                engine.counters["fused_stage_filter_rows"] += matched * n_fused
        keep = np.flatnonzero(res["bits"])
        bits = res["bits"][keep]
        # survivors matched every stage (a probe miss zeroes the row's
        # word), so every gathered entry index is valid
        entries = [e[keep] for e in res["entries"]]
        env = cplan["env"]
        out_cols = {}
        for a in cplan["needed"]:
            ref = env.get(a)
            if ref is None:
                out_cols[a] = cols[a][keep]
            else:
                _, stg, attr = ref
                out_cols[a] = self.ops[stg].state.cols[attr].data[entries[stg]]
        did = did[keep]
        if self.compose_did:
            for s, op in enumerate(self.ops):
                did = did * np.int64(op.state.did_domain) + op.state.did.data[entries[s]]
        sink = None
        if "vismask" in res:
            sink = (res["vismask"][keep], res["emask"][keep], res["slots"])
        return cost, out_cols, bits, did, sink

    def _agg_fold_cohort(
        self, engine, ck, ms: List[Member], needed, cols, bits: np.ndarray,
        part: int, nsel_of: Dict[int, int],
    ) -> None:
        """Fold a cohort of identically-shaped aggregate sinks in one
        segmented pass keyed by (group id × member bit) (§11): group ids
        and aggregate expressions are computed once over the cohort's row
        union, per-(group, member) partials come from one composite
        ``segment_sum``, and each member's scatter goes through a cached
        cohort-gid -> accumulator-id map — in steady state the per-member
        residue is a gather + scatter over its touched groups, no hashing.
        Unseen groups enter a member's accumulator index in that member's
        own first-occurrence row order, so layout and float accumulation
        stay bit-identical to the per-member oracle path."""
        sink = ms[0].sink
        k = len(ms)
        cmask = np.uint64(0)
        for m in ms:
            cmask |= m.bitval
        rows = np.flatnonzero(bits & cmask)
        if not len(rows):
            return
        sub = bits[rows] & cmask
        slots = np.array([m.slot for m in ms], dtype=np.int64)
        nkept = len(rows)
        if not (sub & (sub - U64_1)).any():
            # disjoint ownership (one cohort bit per row — the common fold
            # shape): pairs ARE the rows, no member matrix and no gathers;
            # bit index via branch-free de Bruijn multiply, not float log2
            inv = np.full(64, -1, dtype=np.int64)
            inv[slots] = np.arange(len(ms), dtype=np.int64)
            pm = inv[_DB_TABLE[((sub * _DB64) >> _DB_SHIFT).astype(np.intp)]]
            pr = None  # identity: pairs[i] == row i
        else:
            memmat = unpack_slots(sub, slots)
            pm, pr = np.nonzero(memmat)  # per member, rows ascend
        n_pairs = len(pm)
        scols = {key: cols[key][rows] for key in needed}
        ci = self._cohort_state.get(ck)
        if ci is None:
            ci = self._cohort_state[ck] = _CohortIndex(len(sink.group_keys))
        gids, gvals, ng = ci.resolve([scols[g] for g in sink.group_keys], nkept)
        pair_gids = gids if pr is None else gids[pr]
        code = pair_gids * np.int64(k) + pm
        nbuckets = ng * k
        backend = engine.backend
        segment_sum = (
            backend.segment_sum if backend is not None else _bincount_segment_sum
        )
        counts2d = segment_sum(code, None, nbuckets).reshape(ng, k)
        vals = []
        for a in sink.aggs:
            if a.expr is None:
                vals.append(None)
            else:
                v = expr_eval(a.expr, scols)
                v = np.broadcast_to(np.asarray(v, dtype=np.float64), (nkept,))
                vals.append(v if pr is None else v[pr])
        partials = []
        for a, v in zip(sink.aggs, vals):
            if a.func == "count":
                partials.append(counts2d)
            elif a.func in ("sum", "avg"):
                partials.append(segment_sum(code, v, nbuckets).reshape(ng, k))
            elif a.func == "min":
                p = np.full(nbuckets, math.inf)
                np.minimum.at(p, code, v)
                partials.append(p.reshape(ng, k))
            elif a.func == "max":
                p = np.full(nbuckets, -math.inf)
                np.maximum.at(p, code, v)
                partials.append(p.reshape(ng, k))
            else:
                raise ValueError(a.func)
        engine.counters["agg_cohort_rows"] += n_pairs
        # member-major (k, ng) layouts: contiguous per-member row gathers
        counts2d_t = np.ascontiguousarray(counts2d.T)
        partials_t = [np.ascontiguousarray(p.T) for p in partials]
        tz_m, tz_g = np.nonzero(counts2d_t != 0)
        mb = np.searchsorted(tz_m, np.arange(k + 1))
        nsel_all = np.bincount(pm, minlength=k)
        for i, m in enumerate(ms):
            n_touched = int(mb[i + 1] - mb[i])
            if not n_touched:
                continue
            full = n_touched == ng  # steady state: every group touched
            touched = None if full else tz_g[mb[i] : mb[i + 1]]
            nsel = int(nsel_all[i])
            gmap = ci.member_map(m.mid, part, ng)
            local = gmap if full else gmap[touched]
            if (local < 0).any():
                # first contact with these groups: insert into the member's
                # accumulator index in ITS first-occurrence row order
                sel = pm == i
                g = pair_gids[sel]  # member's rows, ascending
                uq, first = np.unique(g, return_index=True)
                fo = uq[np.argsort(first, kind="stable")]
                new = fo[gmap[fo] < 0]
                gmap[new] = m.sink.agg_state.map_groups(
                    [gv[new] for gv in gvals], part=part
                )
                local = gmap if full else gmap[touched]
            m.sink.agg_state.fold_groups(
                local,
                counts2d_t[i] if full else counts2d_t[i][touched],
                [p[i] if full else p[i][touched] for p in partials_t],
                nsel,
                part=part,
            )
            m.rows_sunk += nsel
            engine.counters["agg_rows"] += nsel
            nsel_of[m.mid] = nsel

    def _agg_sink_rows(self, engine, m: Member, scols, nsel: int, part: int) -> None:
        """Fold one member's selected rows into its aggregate state (the
        per-member sink body, shared by the oracle path, singleton/distinct
        cohorts, and the overflow slow lane)."""
        sink = m.sink
        backend = engine.backend
        key_cols = [scols[k] for k in sink.group_keys]
        vals = [
            expr_eval(a.expr, scols) if a.expr is not None else None
            for a in sink.aggs
        ]
        vals = [
            np.broadcast_to(np.asarray(v, dtype=np.float64), (nsel,))
            if v is not None
            else None
            for v in vals
        ]
        sink.agg_state.update(
            key_cols,
            vals,
            nsel,
            segment_sum=backend.segment_sum if backend is not None else None,
            part=part,
        )
        m.rows_sunk += nsel
        engine.counters["agg_rows"] += nsel

    # -- retained per-member oracle path -------------------------------------
    def _process_packed_members(
        self, engine, act: List[Member], cols, row_ids: np.ndarray, part: int
    ) -> float:
        """The pre-§11 per-member morsel loop, retained verbatim as the
        differential oracle for the fused path (``member_major=False``):
        per-stage visibility, stage filters, sink tagging, and aggregate
        folds each walk the members one by one."""
        n = len(row_ids)
        cm = engine.cost_model
        cost = 0.0

        bits = self._source_bits(act, cols, n, engine)
        cost += cm["filter"] * n * len(act)

        keep = np.flatnonzero(bits)
        cols = {k: v[keep] for k, v in cols.items()}
        bits = bits[keep]
        did = row_ids[keep].astype(np.int64)

        # §14: same first-stage routing histogram as the fused path
        if engine.mesh_plan is not None and self.ops and len(did) > 0:
            engine.mesh_plan.note_morsel(encode_keys(cols, self.ops[0].probe_attrs))

        # hash-probe ops (§4.3: one physical probe step serves all queries
        # whose visibility check succeeds)
        backend = engine.backend
        for stage, op in enumerate(self.ops):
            if len(did) == 0:
                break
            keycodes = encode_keys(cols, op.probe_attrs)
            # single-member probes resolve the state lens in-kernel when the
            # backend can serve it; the runtime then skips visible_mask
            lens_fused = False
            if backend is not None:
                if len(act) == 1:
                    probe_visible = getattr(backend, "probe_visible", None)
                    if probe_visible is not None:
                        fused_pair = probe_visible(op.state, keycodes, act[0].lens_qid)
                        if fused_pair is not None:
                            probe_idx, entry_idx = fused_pair
                            lens_fused = True
                            engine.counters["kernel_lens_probes"] += 1
                if not lens_fused:
                    probe_idx, entry_idx = _backend_probe(
                        backend, op.state, keycodes, engine.counters
                    )
            else:
                probe_idx, entry_idx = op.state.probe(keycodes)
            if engine.mesh_plan is not None:
                # §14 exchange charge — identical to the fused path's so
                # the oracle stays clock-bit-identical under mesh
                xr = engine.mesh_plan.exchange_rows(len(keycodes))
                cost += cm["exchange"] * xr
                engine.counters["mesh_exchange_rows"] += xr
            cost += cm["probe"] * len(keycodes) + cm["match"] * len(probe_idx)
            engine.counters["probe_rows"] += len(keycodes)
            bits_in = bits[probe_idx]
            new_bits = np.zeros(len(probe_idx), dtype=np.uint64)
            for m in act:
                if lens_fused:
                    bm = bit_of(bits_in, m.slot)
                else:
                    vis = op.state.visible_mask(m.lens_qid, entry_idx)
                    bm = bit_of(bits_in, m.slot) & vis
                new_bits |= np.where(bm, m.bitval, U64_0)
            cols = {k: v[probe_idx] for k, v in cols.items()}
            for a, out in zip(op.payload, op.out_names):
                cols[out] = op.state.cols[a].data[entry_idx]
            if self.compose_did:
                did = did[probe_idx] * np.int64(op.state.did_domain) + op.state.did.data[entry_idx]
            else:
                did = did[probe_idx]
            bits = new_bits
            # member post-join filters at this stage
            for m in act:
                for p in m.stage_filters.get(stage, ()):  # e.g. Q5 ColEq
                    bm = bit_of(bits, m.slot) & evaluate(p, cols)
                    bits = (bits & ~m.bitval) | np.where(bm, m.bitval, U64_0)
            keep = np.flatnonzero(bits)
            if len(keep) != len(bits):
                cols = {k: v[keep] for k, v in cols.items()}
                did = did[keep]
                bits = bits[keep]

        # sinks
        if self.build_target is not None and len(did) > 0:
            bt = self.build_target
            vismask = np.zeros(len(did), dtype=np.uint64)
            emask = np.zeros(len(did), dtype=np.uint64)
            member_rows: List[Tuple[Member, int]] = []
            for m in act:
                sel = bit_of(bits, m.slot)
                nsel = int(sel.sum())
                if nsel:
                    for b in m.beneficiaries:
                        vismask[sel] |= bt.state.slots.mask(b)
                    if m.eid >= 0:
                        emask[sel] |= U64_1 << np.uint64(m.eid)
                member_rows.append((m, nsel))
            any_rows = vismask != 0
            idx = np.flatnonzero(any_rows)
            if len(idx):
                keycodes = encode_keys(cols, bt.key_attrs)
                ins, mrk = bt.state.insert_or_mark(
                    did[idx],
                    keycodes[idx],
                    {a: cols[a][idx] for a in bt.state.retained_attrs},
                    vismask[idx],
                    emask[idx],
                )
                cost += cm["insert"] * ins + cm["mark"] * mrk
            for m, nsel in member_rows:
                m.rows_sunk += nsel
                key = "residual_build_rows" if m.kind == "residual" else "ordinary_build_rows"
                engine.counters[key] += nsel * len(m.beneficiaries)
        else:
            for m in act:
                if m.sink is None:
                    continue
                sel = bit_of(bits, m.slot)
                nsel = int(sel.sum())
                if nsel == 0:
                    continue
                scols = {k: v[sel] for k, v in cols.items()}
                self._agg_sink_rows(engine, m, scols, nsel, part)
                cost += cm["agg"] * nsel
        return cost

    # -- overflow slow lane (§11) --------------------------------------------
    def _process_overflow(
        self, engine, m: Member, cols, row_ids: np.ndarray, part: int
    ) -> float:
        """Member-at-a-time pass for one slot-overflow member: the same
        stages on a plain boolean row mask. Sound — rows are never dropped
        when the packed word runs out of bits — just not fused."""
        n = len(row_ids)
        cm = engine.cost_model
        cost = cm["filter"] * n
        sel = np.flatnonzero(evaluate(m.pred, cols))
        mcols = {k: v[sel] for k, v in cols.items()}
        did = row_ids[sel].astype(np.int64)
        backend = engine.backend
        for stage, op in enumerate(self.ops):
            if len(did) == 0:
                break
            keycodes = encode_keys(mcols, op.probe_attrs)
            if backend is not None:
                probe_idx, entry_idx = _backend_probe(
                    backend, op.state, keycodes, engine.counters
                )
            else:
                probe_idx, entry_idx = op.state.probe(keycodes)
            if engine.mesh_plan is not None:
                # §14 exchange charge — the slow lane's rows route through
                # the same bucketed all_to_all as the packed path's
                xr = engine.mesh_plan.exchange_rows(len(keycodes))
                cost += cm["exchange"] * xr
                engine.counters["mesh_exchange_rows"] += xr
            cost += cm["probe"] * len(keycodes) + cm["match"] * len(probe_idx)
            engine.counters["probe_rows"] += len(keycodes)
            vis = op.state.visible_mask(m.lens_qid, entry_idx)
            ksel = np.flatnonzero(vis)
            probe_idx, entry_idx = probe_idx[ksel], entry_idx[ksel]
            mcols = {k: v[probe_idx] for k, v in mcols.items()}
            for a, out in zip(op.payload, op.out_names):
                mcols[out] = op.state.cols[a].data[entry_idx]
            if self.compose_did:
                did = did[probe_idx] * np.int64(op.state.did_domain) + op.state.did.data[entry_idx]
            else:
                did = did[probe_idx]
            keep = np.ones(len(did), dtype=bool)
            for p in m.stage_filters.get(stage, ()):
                keep &= evaluate(p, mcols)
            if not keep.all():
                ks = np.flatnonzero(keep)
                mcols = {k: v[ks] for k, v in mcols.items()}
                did = did[ks]
        if self.build_target is not None and len(did) > 0:
            bt = self.build_target
            w = np.uint64(0)
            for b in m.beneficiaries:
                w |= bt.state.slots.mask(b)
            e = (U64_1 << np.uint64(m.eid)) if m.eid >= 0 else np.uint64(0)
            keycodes = encode_keys(mcols, bt.key_attrs)
            ins, mrk = bt.state.insert_or_mark(
                did,
                keycodes,
                {a: mcols[a] for a in bt.state.retained_attrs},
                np.full(len(did), w, dtype=np.uint64),
                np.full(len(did), e, dtype=np.uint64),
            )
            cost += cm["insert"] * ins + cm["mark"] * mrk
            m.rows_sunk += len(did)
            key = "residual_build_rows" if m.kind == "residual" else "ordinary_build_rows"
            engine.counters[key] += len(did) * len(m.beneficiaries)
        elif m.sink is not None and len(did) > 0:
            self._agg_sink_rows(engine, m, mcols, len(did), part)
            cost += cm["agg"] * len(did)
        return cost


# ---------------------------------------------------------------------------
# Scan node (§4.4 shared cyclic scans)
# ---------------------------------------------------------------------------


class ScanNode:
    """One shared cyclic scan, split into ``n_partitions`` contiguous
    morsel-range shards with independent cyclic cursors (§9). The node
    keeps ONE logical scan identity per table — attachment, zone maps, and
    grafting see a single scan; only delivery is sharded."""

    def __init__(
        self,
        sid: int,
        table: Table,
        morsel_size: int,
        zone_maps: bool = False,
        n_partitions: int = 1,
    ):
        self.sid = sid
        self.table = table
        self.morsel_size = morsel_size
        self.n_morsels = max(1, math.ceil(table.nrows / morsel_size))
        p = max(1, min(int(n_partitions), self.n_morsels))
        self.n_partitions = p
        base, rem = divmod(self.n_morsels, p)
        self.part_counts = np.array(
            [base + (1 if i < rem else 0) for i in range(p)], dtype=np.int64
        )
        self.part_starts = np.concatenate(([0], np.cumsum(self.part_counts)[:-1]))
        # per-partition cyclic cursor (absolute morsel index within the shard)
        self.cursors = [int(s) for s in self.part_starts]
        self.pipelines: List[Pipeline] = []
        self.row_bytes = table.nbytes() / max(table.nrows, 1)
        self.zone_maps = zone_maps
        self._zone_cache: Optional[Tuple[tuple, np.ndarray]] = None

    @property
    def cursor(self) -> int:
        """Partition-0 cursor (seed-compatible view for P == 1)."""
        return self.cursors[0]

    def attach(self, p: Pipeline) -> None:
        self.pipelines.append(p)

    def has_active_work(self) -> bool:
        return any(p.active_members() for p in self.pipelines)

    def _wave_possible(self) -> np.ndarray:
        """Beyond-paper zone-map skipping, hoisted per activation wave: one
        vectorized pass over ALL morsels' [min,max] zones per distinct set
        of active members, instead of per-morsel per-member re-derivation.
        ``possible[i]`` is False only when no active member's canonical
        predicate can match morsel i."""
        act = [m for p in self.pipelines for m in p.active_members()]
        key = tuple(m.mid for m in act)
        cached = self._zone_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        zm = self.table.zone_map(self.morsel_size)
        possible = np.zeros(self.n_morsels, dtype=bool)
        for m in act:
            conj = _member_conj(m)
            if conj is None:
                possible[:] = True  # unprovable predicate -> must read
                break
            ok = np.ones(self.n_morsels, dtype=bool)
            for attr, c in conj.constraints.items():
                if attr not in zm:
                    continue
                mins, maxs = zm[attr]
                if c.lo != -math.inf:
                    ok &= (maxs > c.lo) if not c.lo_inc else (maxs >= c.lo)
                if c.hi != math.inf:
                    ok &= (mins < c.hi) if not c.hi_inc else (mins <= c.hi)
                if c.members is not None:
                    anym = np.zeros(self.n_morsels, dtype=bool)
                    for v in c.members:
                        anym |= (mins <= v) & (maxs >= v)
                    ok &= anym
                if not ok.any():
                    break
            possible |= ok
            if possible.all():
                break
        self._zone_cache = (key, possible)
        return possible

    def _bump_cursor(self, part: int) -> None:
        lo = int(self.part_starts[part])
        self.cursors[part] = lo + (self.cursors[part] + 1 - lo) % int(self.part_counts[part])

    def advance(self, engine, part: int = 0) -> float:
        """Emit partition ``part``'s next morsel to every attached pipeline
        with members still owed that shard. Physical read counted once
        (shared scan). Traced as ``scan.advance``, tagged with the rows
        read."""
        tr = _trace.active
        if tr is not None:
            span = tr.open("scan.advance")
        idx = self.cursors[part]
        if self.zone_maps and not self._wave_possible()[idx]:
            engine.counters["morsels_skipped"] += 1
            cost = engine.cost_model["scan"] * 8  # zone check, not a read
            # the morsel still counts toward every member's delivery cycle
            # (zero rows pass their filters by construction)
            for p in list(self.pipelines):
                finished = []
                for m in p.active_members_for(part):
                    m.received += 1
                    if m.part_received is not None:
                        m.part_received[part] += 1
                        if m.part_received[part] >= m.part_need[part]:
                            engine.on_member_part_finished(p, m, part)
                    if m.received >= m.need:
                        m.done = True
                        m.active = False
                        finished.append(m)
                for m in finished:
                    engine.on_member_finished(p, m)
            self._bump_cursor(part)
            if tr is not None:
                tr.close(span)
            return cost
        start = idx * self.morsel_size
        cols = self.table.morsel(start, self.morsel_size)
        n = len(next(iter(cols.values())))
        row_ids = np.arange(start, start + n, dtype=np.int64)
        if tr is not None:
            tr.tag(span, n)

        engine.counters["scan_rows"] += n
        engine.counters["scan_bytes"] += n * self.row_bytes
        cost = engine.cost_model["scan"] * n

        for p in list(self.pipelines):
            cost += p.process(engine, cols, row_ids, part)
        self._bump_cursor(part)
        if tr is not None:
            tr.close(span)
        return cost

    def detach(self, p: Pipeline) -> None:
        if p in self.pipelines:
            self.pipelines.remove(p)
