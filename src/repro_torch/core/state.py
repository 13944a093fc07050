"""Shared operator state: hash-build tables and aggregate accumulators.

State-centric execution (§3.1) treats this state as shared — any compatible
query may observe it through a per-query state lens or contribute to it
through an admitted producer path. A hash-build state records:

* its signature (exact non-predicate identity, descriptors.py),
* an *extent registry*: every producer path that contributes to the state
  registers the canonical predicate extent it delivers; entry-level
  provenance bitmasks record which extents produced/marked each entry,
* coverage = the union of completed extents (this is what makes no-match
  results meaningful, §4.3),
* entries with derivation identifiers, per-query visibility bitmasks, and
  extent provenance masks,
* extent-scoped state-level visibility grants (§4.3: a later query observing
  an already-represented extent does not rewrite existing entries — the lens
  combines extent provenance with a retained-attribute predicate).

Soundness of represented-extent observation (see DESIGN.md): a grant for
query q is (allowed_extents, B_ret) where B_ret is the retained-attribute
part of B_q and allowed_extents are completed extents whose predicate
implies the non-retained part of B_q. The state-readiness gate requires the
allowed extents alone to cover B_q; since insert-or-mark ORs provenance for
every extent that delivers a derivation, every entry of B_q then carries an
allowed bit — matches are complete, and absence is meaningful. When
FV(B_q) ⊆ RetainedAttrs(S) the provenance check degenerates to evaluating
B_q on the entry (allowed = ALL).

Layout is columnar SoA (TPU adaptation — DESIGN.md §2): dense append-only
arrays indexed by two batched hash structures (DESIGN.md §8):

* derivation ids dedup through a vectorized ``HashIndex`` (insert-or-mark
  is one batched lookup/insert plus one ``bitwise_or.at`` pass),
* probes resolve through an *incremental multi-match index*: a ``HashIndex``
  over keycodes routes unique keys in O(batch), while keys with multiple
  entries fall to a sorted duplicate run maintained by delta merge — no
  full re-argsort on growth.

Partition-parallel sharding (DESIGN.md §9): under ``n_partitions > 1`` both
index structures split into P shards routed by ``key_partition`` (splitmix64
of the entry keycode). Entry *storage* stays one global SoA with ids
assigned in batch-stream first-occurrence order, which makes the resident
arrays (and therefore per-partition visibility words: each entry's packed
word belongs to exactly one key shard) bit-identical for every P — only the
index routing shards, so grafting/admission and the 1×1 oracle are
untouched while (fragment × partition) units touch disjoint shards.

The Pallas ``hash_probe`` kernel consumes the same SoA layout; aggregate
group ids and count(distinct) seen-pairs run on ``MultiKeyIndex``.

Lifecycle (DESIGN.md §10): every shared state carries *pin counts* — the
active lenses (attached queries, ``refs``) plus external admission pins
(``pins``, held by the admission controller for queued-but-admissible
lenses). Under the ``epoch`` retention policy a state whose pins drop to
zero is *retired* (stamped with a monotonically increasing retention epoch
and kept observable for later grafts) rather than dropped; the
``StateLifecycle`` evictor reclaims retired states oldest-epoch-first when
their bytes exceed the session's ``memory_budget``. Eviction is safe by
construction — only zero-pin states are evictable, and every observation
path (``probe`` / ``visible_mask`` / ``insert_or_mark`` / ``attach``)
hard-fails on an evicted state, so no lens can ever read reclaimed
fragments.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .descriptors import StateSignature
from .hashindex import HashIndex, MultiKeyIndex, key_partition
from .predicates import Conjunction, Coverage, evaluate_conj
from .visibility import SlotAllocator, bit_of

ALL_EXTENTS = np.uint64(0xFFFFFFFFFFFFFFFF)

_EMPTY_PAIR = (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))

#: Entry count below which ``SharedHashBuildState.probe`` skips the
#: incremental multi-match index (lazy dup-run sync, hash rounds) and uses
#: a direct cached-argsort probe — at small occupancy the full stable sort
#: is cheaper than the incremental machinery's fixed overheads (§8).
DIRECT_PROBE_MAX = 32768

#: Mark-dirty-log cap (DESIGN.md §13): past this many logged re-ORed entry
#: ids the log compacts away and bumps its epoch — one mirror regather then
#: beats replaying an unbounded patch list.
MARK_LOG_LIMIT = 1 << 16


def _bincount_segment_sum(gids, values, n_groups):
    if values is None:
        return np.bincount(gids, minlength=n_groups).astype(np.float64)
    return np.bincount(gids, weights=values, minlength=n_groups)

# ---------------------------------------------------------------------------


class GrowArray:
    """Amortized-append numpy array."""

    __slots__ = ("_buf", "n")

    def __init__(self, dtype, capacity: int = 1024):
        self._buf = np.empty(capacity, dtype=dtype)
        self.n = 0

    def append(self, values: np.ndarray) -> None:
        m = len(values)
        if self.n + m > len(self._buf):
            cap = max(len(self._buf) * 2, self.n + m)
            nb = np.empty(cap, dtype=self._buf.dtype)
            nb[: self.n] = self._buf[: self.n]
            self._buf = nb
        self._buf[self.n : self.n + m] = values
        self.n += m

    @property
    def data(self) -> np.ndarray:
        return self._buf[: self.n]


# ---------------------------------------------------------------------------
# One shard of the incremental multi-match probe index (DESIGN.md §8/§9)
# ---------------------------------------------------------------------------


class _KeyProbeIndex:
    """Incremental multi-match probe index over one key shard.

    Hash index for unique keys + sorted duplicate run with delta merge;
    entry ids are *global* SoA positions, so shards compose without any id
    translation. The unpartitioned state owns exactly one shard — this
    class is the seed implementation moved verbatim."""

    __slots__ = (
        "_kindex",
        "_key_first",
        "_key_dup",
        "_dup_keys",
        "_dup_entries",
        "_dup_pend_keys",
        "_dup_pend_entries",
    )

    def __init__(self, counters: Optional[Dict] = None):
        self._kindex = HashIndex(counters=counters)
        self._key_first = GrowArray(np.int64)  # key id -> first entry idx
        self._key_dup = GrowArray(np.bool_)  # key id -> key has >1 entry
        self._dup_keys = np.empty(0, dtype=np.int64)  # sorted by (key, entry)
        self._dup_entries = np.empty(0, dtype=np.int64)
        self._dup_pend_keys: List[np.ndarray] = []
        self._dup_pend_entries: List[np.ndarray] = []

    def append(self, new_keycodes: np.ndarray, ent: np.ndarray, all_keycodes: np.ndarray) -> None:
        """Register freshly appended entries: unique keys land in the hash
        index; entries of duplicated keys queue for the sorted-run delta
        merge. ``ent`` carries the entries' global SoA positions and
        ``all_keycodes`` the state's full keycode column (for promoting a
        key's first entry when it turns multi-entry)."""
        kids, knew = self._kindex.lookup_or_insert(new_keycodes)
        if knew.any():
            ksel = np.flatnonzero(knew)
            self._key_first.append(ent[ksel])
            self._key_dup.append(np.zeros(len(ksel), dtype=np.bool_))
        dup = ~knew
        if dup.any():
            dsel = np.flatnonzero(dup)
            kd = kids[dsel]
            fresh = np.unique(kd)
            fresh = fresh[~self._key_dup.data[fresh]]
            if len(fresh):
                # key just became multi-entry: its first entry joins the run
                self._key_dup.data[fresh] = True
                first = self._key_first.data[fresh]
                self._dup_pend_keys.append(all_keycodes[first])
                self._dup_pend_entries.append(first)
            self._dup_pend_keys.append(new_keycodes[dsel])
            self._dup_pend_entries.append(ent[dsel])

    def _flush_dups(self) -> None:
        """Merge the pending duplicate delta into the sorted run. Cost is
        O(run + delta) per growth episode, and zero for unique-key states."""
        if not self._dup_pend_keys:
            return
        dk = np.concatenate(self._dup_pend_keys)
        de = np.concatenate(self._dup_pend_entries)
        self._dup_pend_keys = []
        self._dup_pend_entries = []
        order = np.lexsort((de, dk))
        dk, de = dk[order], de[order]
        if len(self._dup_keys):
            # delta entries of an existing key are younger than the run's:
            # side='right' keeps within-key entry order = insertion order
            pos = np.searchsorted(self._dup_keys, dk, side="right")
            self._dup_keys = np.insert(self._dup_keys, pos, dk)
            self._dup_entries = np.insert(self._dup_entries, pos, de)
        else:
            self._dup_keys, self._dup_entries = dk, de

    def probe(self, pk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Match pairs (probe_row_idx, entry_idx) for this shard's keys —
        probe-row-major, entries in insertion order."""
        if self._key_first.n == 0 or len(pk) == 0:
            return _EMPTY_PAIR
        self._flush_dups()
        kids = self._kindex.lookup(pk)
        midx = np.flatnonzero(kids >= 0)
        if len(midx) == 0:
            return _EMPTY_PAIR
        mk = kids[midx]
        isdup = self._key_dup.data[mk]
        single = midx[~isdup]
        dup_rows = midx[isdup]
        counts = np.zeros(len(pk), dtype=np.int64)
        counts[single] = 1
        if len(dup_rows):
            lo = np.searchsorted(self._dup_keys, pk[dup_rows], side="left")
            hi = np.searchsorted(self._dup_keys, pk[dup_rows], side="right")
            counts[dup_rows] = hi - lo
        total = int(counts.sum())
        probe_idx = np.repeat(np.arange(len(pk), dtype=np.int64), counts)
        entry_idx = np.empty(total, dtype=np.int64)
        offs = np.concatenate(([0], np.cumsum(counts)[:-1]))
        entry_idx[offs[single]] = self._key_first.data[mk[~isdup]]
        if len(dup_rows):
            c = hi - lo
            nd = int(c.sum())
            within = np.arange(nd, dtype=np.int64) - np.repeat(
                np.concatenate(([0], np.cumsum(c)[:-1])), c
            )
            dpos = np.repeat(offs[dup_rows], c) + within
            entry_idx[dpos] = self._dup_entries[np.repeat(lo, c) + within]
        return probe_idx, entry_idx


# ---------------------------------------------------------------------------


class SharedHashBuildState:
    """A shared hash-build state (§4.3): signature + coverage + SoA entries.

    Entries are identified by derivation id; insert-or-mark keeps one
    physical entry per derivation and ORs visibility/provenance bits (§4.3
    "GraftDB stores one build entry and records the visibility needed by
    those queries"). Under ``n_partitions > 1`` the did and probe indexes
    shard by key hash (DESIGN.md §9) while entry storage stays one global
    SoA with P-independent entry ids."""

    def __init__(
        self,
        state_id: int,
        sig: StateSignature,
        key_attrs: Tuple[str, ...],
        payload: Tuple[str, ...],
        did_domain: int = 1 << 62,
        counters: Optional[Dict] = None,
        n_partitions: int = 1,
    ):
        self.state_id = state_id
        self.sig = sig
        self.key_attrs = tuple(key_attrs)
        self.payload = tuple(payload)
        self.retained_attrs = frozenset(self.payload) | frozenset(self.key_attrs)
        self.did_domain = did_domain
        self.n_partitions = max(1, int(n_partitions))
        self._counters = counters

        self.keycode = GrowArray(np.int64)
        self.did = GrowArray(np.int64)
        self.vis = GrowArray(np.uint64)
        self.emask = GrowArray(np.uint64)
        self.cols: Dict[str, GrowArray] = {a: GrowArray(np.float64) for a in self.retained_attrs}

        if self.n_partitions == 1:
            self._did_index = HashIndex(counters=counters)
        else:
            # key-hash shards: a derivation's keycode determines its shard
            # (a did always carries one keycode), so per-shard dedup is
            # exact. Shard-dense ids map to global SoA positions.
            self._did_shards = [HashIndex(counters=counters) for _ in range(self.n_partitions)]
            self._did_gid = [GrowArray(np.int64) for _ in range(self.n_partitions)]
        self.slots = SlotAllocator()

        # extent registry: eid -> (conj | None, complete)
        self.extents: Dict[int, Tuple[Optional[Conjunction], bool]] = {}
        self._next_eid = 0
        # per-extent per-scan-partition delivery frontier (§9): which of a
        # producer's scan partitions have fully delivered. Introspection for
        # per-partition gate views; extent *completion* stays all-partitions
        # (probe rows hash across every key shard, so a partial frontier
        # cannot soundly open a lens).
        self.extent_parts: Dict[int, Tuple[int, set]] = {}

        # grants: qid -> list of (allowed_emask, retained_pred_conj)
        self.grants: Dict[int, List[Tuple[np.uint64, Conjunction]]] = {}
        self.refs: set = set()
        # lifecycle (DESIGN.md §10): external admission pins, retirement
        # epoch stamp (None while any lens or pin holds the state), and the
        # evicted tombstone every observation path checks.
        self.pins: set = set()
        self.retired_epoch: Optional[int] = None
        self.evicted = False
        # fault plane (§16): a quarantined state is mid-tombstone — its
        # fragments may be corrupt, so teardown must neither retire it for
        # later grafts nor spill it into the reuse plane.
        self.quarantined = False

        # incremental multi-match probe index shards (DESIGN.md §8/§9),
        # synced lazily at probe time — build-only phases pay nothing.
        self._kidx = [_KeyProbeIndex(counters=counters) for _ in range(self.n_partitions)]
        self._indexed_upto = 0  # entries registered with the probe index
        # small-state direct probe cache: (n, order, sorted_keys, unique)
        self._direct_cache: Optional[tuple] = None

        # counters
        self.rows_inserted = 0
        self.rows_marked = 0

        # device-residency hook (DESIGN.md §13): entry ids whose packed
        # vis/emask words were re-ORed after their initial insert. Device
        # mirrors patch exactly these entries instead of regathering the
        # whole SoA; when the log would outgrow MARK_LOG_LIMIT it is
        # compacted away and the epoch bump tells consumers to regather
        # once. Appends need no log — mirrors track them by entry count.
        self.mark_log = GrowArray(np.int64)
        self.mark_log_epoch = 0
        # detach() clears a slot's bit across ALL vis words without going
        # through insert_or_mark — neither rows_marked nor the mark log sees
        # it. The epoch below is the mirrors' staleness signal for that bulk
        # clear (bump -> consumers regather once).
        self.vis_epoch = 0

    # -- lifecycle guards ----------------------------------------------------
    def _check_live(self) -> None:
        """Eviction-vs-lens soundness (§10): an evicted state's fragments
        are reclaimed — any observation attempt is a lifecycle bug, never a
        silently wrong (empty) answer."""
        if self.evicted:
            raise RuntimeError(
                f"state #{self.state_id} was evicted — no lens may observe it"
            )

    def pin(self, token) -> None:
        """External admission pin: a queued-but-admissible lens holds the
        state out of the evictor's reach until it attaches or withdraws."""
        self._check_live()
        self.pins.add(token)

    def unpin(self, token) -> None:
        self.pins.discard(token)

    @property
    def evictable(self) -> bool:
        """No live lens (refs) and no admission pin observes this state."""
        return not self.refs and not self.pins and not self.evicted

    # -- extent registry -----------------------------------------------------
    def register_extent(self, conj: Optional[Conjunction]) -> int:
        """Register a producer extent; returns its provenance bit id.
        Returns -1 when provenance bits are exhausted (the extent still
        contributes rows via per-query visibility bits — only represented
        attachment against it is lost, never safety)."""
        if self._next_eid >= 64:
            return -1
        eid = self._next_eid
        self._next_eid += 1
        self.extents[eid] = (conj, False)
        return eid

    def complete_extent(self, eid: int) -> None:
        if eid >= 0 and eid in self.extents:  # voided extents (§16) are gone
            conj, _ = self.extents[eid]
            self.extents[eid] = (conj, True)

    def void_extent(self, eid: int) -> None:
        """Seal the state at its last complete extent (§16): a cancelled or
        failed producer with no surviving adopter withdraws its incomplete
        extent from the registry. Sound because provenance bit ids are
        monotonic (``_next_eid`` never reuses a voided bit), coverage and
        grant evaluation iterate the registry (a missing eid simply grants
        nothing), and the producer's partially delivered rows stay physical
        but carry only the voided emask bit + doomed vis bits — invisible
        to every lens."""
        if eid >= 0:
            self.extents.pop(eid, None)
            self.extent_parts.pop(eid, None)

    def complete_extent_partition(self, eid: int, part: int, n_parts: int) -> None:
        """Record one scan partition of a producer extent as fully
        delivered (the per-partition visibility frontier of §9)."""
        if eid < 0:
            return
        total, done = self.extent_parts.get(eid, (n_parts, set()))
        done.add(part)
        self.extent_parts[eid] = (n_parts, done)

    def extent_partition_frontier(self, eid: int) -> Tuple[int, int]:
        """(partitions delivered, partitions total) for one extent."""
        if eid < 0:
            return (0, 0)
        total, done = self.extent_parts.get(eid, (0, set()))
        return (len(done), total)

    # -- device views (DESIGN.md §14) ----------------------------------------
    def device_frontiers(self) -> Dict[int, Tuple[int, int]]:
        """Per-extent delivery frontiers keyed by extent id. Under mesh
        execution scan partitions ARE devices, so this is the replicated
        control plane's per-device commit view of every producer extent —
        `complete_extent_partition` committed per shard."""
        return {eid: self.extent_partition_frontier(eid) for eid in self.extents}

    def shard_entry_counts(self, n_shards: Optional[int] = None) -> np.ndarray:
        """Entries resident on each key shard — the device layout of the
        entry SoA under §14 (shard p of the mesh owns exactly the entries
        whose ``key_partition`` is p; entry ids stay global and
        P-independent)."""
        P = self.n_partitions if n_shards is None else int(n_shards)
        P = max(1, P)
        n = len(self.keycode.data)
        if n == 0:
            return np.zeros(P, np.int64)
        parts = key_partition(self.keycode.data, P)
        return np.bincount(parts, minlength=P).astype(np.int64)

    def device_layout(self) -> Dict:
        """Replicated summary of this state's per-device residency: entry
        counts and (proportional) bytes per shard, plus the frontier view."""
        counts = self.shard_entry_counts()
        total = int(counts.sum())
        nb = self.nbytes()
        bytes_by = (
            [int(nb * c / total) for c in counts] if total else [0] * len(counts)
        )
        return {
            "state_id": self.state_id,
            "n_shards": int(self.n_partitions),
            "entries_by_device": counts.tolist(),
            "bytes_by_device": bytes_by,
            "extent_frontiers": {
                eid: list(f) for eid, f in self.device_frontiers().items()
            },
        }

    def coverage(self) -> Coverage:
        """Coverage metadata = union of completed extents (§4.3)."""
        return Coverage(c for c, done in self.extents.values() if done and c is not None)

    def covers_with(self, conj: Conjunction, allowed_emask: np.uint64) -> bool:
        """Coverage restricted to the allowed provenance extents."""
        cov = Coverage(
            c
            for eid, (c, done) in self.extents.items()
            if done and c is not None and (np.uint64(1) << np.uint64(eid)) & allowed_emask
        )
        return cov.covers(conj)

    def allowed_extents_for(self, nonret: Conjunction) -> np.uint64:
        """Completed extents whose predicate implies the non-retained part of
        a query's build predicate."""
        mask = np.uint64(0)
        for eid, (c, done) in self.extents.items():
            if done and c is not None and c.implies(nonret):
                mask |= np.uint64(1) << np.uint64(eid)
        return mask

    def covers_with_pending(
        self,
        conj: Conjunction,
        allowed_emask: np.uint64,
        pending: List[Conjunction],
    ) -> bool:
        """Coverage proof over completed extents plus ``pending`` — extent
        predicates a cohort-mate's producer registered this decision step but
        has not yet delivered (§15 deferred representation). The admission
        grant gates on those producers, and ``Gate.open`` re-proves coverage
        with ``covers_with`` once they complete, so this predicts exactly the
        post-completion verdict."""
        cov = Coverage(
            [
                c
                for eid, (c, done) in self.extents.items()
                if done
                and c is not None
                and (np.uint64(1) << np.uint64(eid)) & allowed_emask
            ]
            + list(pending)
        )
        return cov.covers(conj)

    # -- producer side -----------------------------------------------------
    def insert_or_mark(
        self,
        dids: np.ndarray,
        keycodes: np.ndarray,
        cols: Dict[str, np.ndarray],
        vismask: np.ndarray,
        emask: np.ndarray,
    ) -> Tuple[int, int]:
        """Insert rows absent by derivation id; OR visibility/provenance on
        present ones. Returns (inserted, marked).

        One batched ``HashIndex.lookup_or_insert`` per shard resolves every
        row's entry position (deduping within the batch in first-occurrence
        order); a single ``bitwise_or.at`` pass then merges visibility and
        provenance for marks, fresh inserts, and in-batch duplicates alike.
        Global entry ids are assigned in batch-stream first-occurrence
        order for every P, so the resident SoA is partition-independent.

        Sharding invariant: a derivation id always arrives with the same
        keycode (the did identifies a row; the keycode is a function of
        that row), so per-shard dedup by did is exact.
        """
        if len(dids) == 0:
            return 0, 0
        self._check_live()
        dids = np.asarray(dids, dtype=np.int64)
        keycodes = np.asarray(keycodes, dtype=np.int64)
        n0 = self.did.n
        if self.n_partitions == 1:
            ids, is_new = self._did_index.lookup_or_insert(dids)
            sel = np.flatnonzero(is_new)  # ids[sel] == n0 + arange(n_inserted)
        else:
            ids, sel = self._sharded_did_resolve(dids, keycodes, n0)
        n_inserted = len(sel)
        marked = ids < n0
        n_marked = int(marked.sum())
        if n_marked:
            if n_marked > MARK_LOG_LIMIT:
                # pathological batch: never logged, consumers regather once
                self.mark_log = GrowArray(np.int64)
                self.mark_log_epoch += 1
            else:
                if self.mark_log.n + n_marked > MARK_LOG_LIMIT:
                    self.mark_log = GrowArray(np.int64)
                    self.mark_log_epoch += 1
                self.mark_log.append(ids[marked])
        if n_inserted:
            self.did.append(dids[sel])
            self.keycode.append(keycodes[sel])
            zeros = np.zeros(n_inserted, dtype=np.uint64)
            self.vis.append(zeros)
            self.emask.append(zeros)
            for a in self.retained_attrs:
                self.cols[a].append(np.asarray(cols[a], dtype=np.float64)[sel])
            self.rows_inserted += n_inserted
        np.bitwise_or.at(self.vis.data, ids, vismask)
        np.bitwise_or.at(self.emask.data, ids, emask)
        self.rows_marked += n_marked
        return n_inserted, n_marked

    def _sharded_did_resolve(
        self, dids: np.ndarray, keycodes: np.ndarray, n0: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Resolve a batch against the key-hash did shards: global entry id
        per row plus the ascending batch positions of new first occurrences
        (identical to the unsharded path's ``flatnonzero(is_new)``)."""
        parts = key_partition(keycodes, self.n_partitions)
        ids = np.empty(len(dids), dtype=np.int64)
        pending: List[Tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
        new_srcs: List[np.ndarray] = []
        for s in range(self.n_partitions):
            sub = np.flatnonzero(parts == s)
            if not len(sub):
                continue
            sids, snew = self._did_shards[s].lookup_or_insert(dids[sub])
            src = sub[np.flatnonzero(snew)]  # ascending batch positions
            pending.append((s, sub, sids, src))
            if len(src):
                new_srcs.append(src)
        if new_srcs:
            allsrc = np.sort(np.concatenate(new_srcs))
        else:
            allsrc = np.empty(0, dtype=np.int64)
        for s, sub, sids, src in pending:
            if len(src):
                # shard-dense new ids were handed out in sub-batch
                # first-occurrence order == ascending src order, matching
                # this append order exactly
                self._did_gid[s].append(n0 + np.searchsorted(allsrc, src))
            ids[sub] = self._did_gid[s].data[sids]
        return ids, allsrc

    # -- grants ---------------------------------------------------------------
    def add_grant(self, qid: int, allowed_emask: np.uint64, retained_conj: Conjunction) -> None:
        self._check_live()
        self.slots.get(qid)
        self.grants.setdefault(qid, []).append((allowed_emask, retained_conj))

    def grant_evaluable(self, conj: Conjunction) -> bool:
        """FV(P) ⊆ RetainedAttrs(S) (§4.2 evaluability)."""
        return conj.attrs() <= self.retained_attrs

    def _granted_mask(self, allowed_emask: np.uint64, retained_conj: Conjunction) -> np.ndarray:
        m = (self.emask.data & allowed_emask) != 0
        if retained_conj.attrs():
            cols = {a: self.cols[a].data for a in retained_conj.attrs()}
            m = m & evaluate_conj(retained_conj, cols)
        return m

    def count_granted(self, allowed_emask: np.uint64, retained_conj: Conjunction) -> int:
        """Entries currently observable through a grant (counters only)."""
        if self.did.n == 0:
            return 0
        return int(self._granted_mask(allowed_emask, retained_conj).sum())

    def count_granted_by_part(
        self, allowed_emask: np.uint64, retained_conj: Conjunction, n_parts: int
    ) -> np.ndarray:
        """Per-key-partition split of ``count_granted`` (EXPLAIN GRAFT's
        per-partition represented accounting)."""
        if self.did.n == 0:
            return np.zeros(n_parts, dtype=np.int64)
        m = self._granted_mask(allowed_emask, retained_conj)
        parts = key_partition(self.keycode.data, n_parts)
        return np.bincount(parts[m], minlength=n_parts).astype(np.int64)

    # -- consumer side -------------------------------------------------------
    def _sync_index(self) -> None:
        """Register entries appended since the last probe (lazy: the probe
        index costs nothing while a state is only being built)."""
        n = self.keycode.n
        if self._indexed_upto < n:
            new = self.keycode.data[self._indexed_upto : n]
            ent = self._indexed_upto + np.arange(len(new), dtype=np.int64)
            allkc = self.keycode.data
            if self.n_partitions == 1:
                self._kidx[0].append(new, ent, allkc)
            else:
                parts = key_partition(new, self.n_partitions)
                for s in range(self.n_partitions):
                    sub = np.flatnonzero(parts == s)
                    if len(sub):
                        self._kidx[s].append(new[sub], ent[sub], allkc)
            self._indexed_upto = n

    def probe(self, probe_keycodes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized probe: returns (probe_row_idx, entry_idx) match pairs
        — before any visibility filtering. Unique keys resolve through the
        hash index in O(batch); multi-entry keys expand from the sorted
        duplicate run. Match pairs are emitted probe-row-major with entries
        in insertion order, independent of the shard count (each probe key
        lives in exactly one shard, so a stable row-major gather of the
        per-shard results reproduces the unsharded order exactly)."""
        self._check_live()
        if self.keycode.n == 0 or len(probe_keycodes) == 0:
            return _EMPTY_PAIR
        pk = np.asarray(probe_keycodes, dtype=np.int64)
        if self.keycode.n <= DIRECT_PROBE_MAX and self._indexed_upto == 0:
            # size/occupancy threshold (§8): small states skip the lazy
            # dup-run sync entirely; once the state outgrows the threshold
            # the incremental index syncs from scratch in one batch append
            return self._probe_direct(pk)
        self._direct_cache = None  # outgrown: drop the small-state cache
        self._sync_index()
        if self.n_partitions == 1:
            return self._kidx[0].probe(pk)
        parts = key_partition(pk, self.n_partitions)
        pidx_parts: List[np.ndarray] = []
        eidx_parts: List[np.ndarray] = []
        for s in range(self.n_partitions):
            sub = np.flatnonzero(parts == s)
            if not len(sub):
                continue
            lp, le = self._kidx[s].probe(pk[sub])
            if len(lp):
                pidx_parts.append(sub[lp])
                eidx_parts.append(le)
        if not pidx_parts:
            return _EMPTY_PAIR
        probe_idx = np.concatenate(pidx_parts)
        entry_idx = np.concatenate(eidx_parts)
        if len(pidx_parts) > 1:
            order = np.argsort(probe_idx, kind="stable")
            probe_idx, entry_idx = probe_idx[order], entry_idx[order]
            if self._counters is not None:
                self._counters["partition_probe_merges"] += 1
        return probe_idx, entry_idx

    def _probe_direct(self, pk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Small-state probe: one cached stable argsort over all keycodes +
        binary search. Pair stream is bit-identical to the incremental
        index for every partition count — probe-row-major with entries in
        insertion order (stable sort) — so the threshold crossing is
        invisible to consumers."""
        n = self.keycode.n
        cache = self._direct_cache
        if cache is None or cache[0] != n:
            keys = self.keycode.data
            order = np.argsort(keys, kind="stable")
            skeys = keys[order]
            unique = not bool((skeys[1:] == skeys[:-1]).any())
            self._direct_cache = cache = (n, order, skeys, unique)
        _, order, skeys, unique = cache
        if unique:
            pos = np.searchsorted(skeys, pk, side="left")
            hit = skeys[np.minimum(pos, n - 1)] == pk
            probe_idx = np.flatnonzero(hit).astype(np.int64)
            return probe_idx, order[pos[probe_idx]]
        lo = np.searchsorted(skeys, pk, side="left")
        hi = np.searchsorted(skeys, pk, side="right")
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return _EMPTY_PAIR
        probe_idx = np.repeat(np.arange(len(pk), dtype=np.int64), counts)
        starts = np.repeat(lo, counts)
        offs = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate(([0], np.cumsum(counts)[:-1])), counts
        )
        return probe_idx, order[starts + offs]

    def visible_mask(self, qid: int, entry_idx: np.ndarray) -> np.ndarray:
        """Per-query state lens on entries: per-entry visibility bit OR an
        extent-scoped grant the entry's provenance+retained attrs satisfy."""
        self._check_live()
        slot = self.slots.peek(qid)
        if slot is None:
            vis = np.zeros(len(entry_idx), dtype=bool)
        else:
            vis = bit_of(self.vis.data[entry_idx], slot)
        for allowed_emask, conj in self.grants.get(qid, ()):
            g = (self.emask.data[entry_idx] & allowed_emask) != 0
            if conj.attrs():
                cols = {a: self.cols[a].data[entry_idx] for a in conj.attrs()}
                g = g & evaluate_conj(conj, cols)
            vis |= g
        return vis

    def entry_cols(self, entry_idx: np.ndarray, attrs: Sequence[str]) -> Dict[str, np.ndarray]:
        return {a: self.cols[a].data[entry_idx] for a in attrs}

    # -- lifecycle ------------------------------------------------------------
    def attach(self, qid: int) -> None:
        self._check_live()
        self.refs.add(qid)
        self.slots.get(qid)

    def detach(self, qid: int) -> None:
        self.refs.discard(qid)
        # Clear the query's visibility bit before its slot recycles: a state
        # that outlives the query (live co-refs, or §10 epoch retention)
        # must not leak its rows to the slot's next owner through a stale
        # bit — the lens of a later query is exactly its own slot + grants.
        slot = self.slots.peek(qid)
        if slot is not None and self.vis.n:
            v = self.vis.data
            v &= ~(np.uint64(1) << np.uint64(slot))
            # bulk mutation outside insert_or_mark: invalidate device/host
            # visibility mirrors stamped on (rows_inserted, rows_marked)
            self.vis_epoch += 1
        self.slots.release(qid)
        self.grants.pop(qid, None)

    @property
    def n_entries(self) -> int:
        return self.did.n

    def nbytes(self) -> int:
        # floored at the fixed per-state overhead (object + index headers):
        # a zero-entry state still occupies memory, which keeps force-evict
        # (budget 0) able to select it
        per_entry = 8 * (3 + len(self.retained_attrs)) + 8
        return 64 + self.did.n * per_entry


# ---------------------------------------------------------------------------


class _AggPartial:
    """One partition's partial accumulators — exactly the seed engine's
    accumulator layout (partition 0 of an unpartitioned state IS the seed
    path; P > 1 states merge partials deterministically in partition-id
    order, DESIGN.md §9).

    Groups that a cohort fold appends (``append_groups``) get their ids
    at once, but enter the group-id index ``_gidx`` later: their key
    batches wait in ``_pending``, in their original dtypes, and every
    reader of ``_gidx`` first flushes them in order, one
    ``lookup_or_insert`` per batch, which hands out exactly the ids the
    appends already gave (``_index``)."""

    __slots__ = (
        "group_keys",
        "aggs",
        "distinct_global",
        "_gidx",
        "_pending",
        "_global_ready",
        "group_cols",
        "_acc",
        "_counts",
    )

    def __init__(self, group_keys, aggs, counters: Optional[Dict] = None, distinct_global=False):
        self.group_keys = group_keys
        self.aggs = aggs
        # distinct-pair keying: the seed path keys on (partial-local gid,
        # value) — bijective with the key tuple inside one partial;
        # partitioned states key on the actual group-key values + value so
        # dedup is global across partials.
        self.distinct_global = distinct_global
        self._gidx = (
            MultiKeyIndex(len(group_keys), counters=counters) if group_keys else None
        )
        # appended groups not yet in _gidx: (first id, key batch) in order
        self._pending: List[Tuple[int, List[np.ndarray]]] = []
        self._global_ready = False  # global aggregate: single group, lazily init
        self.group_cols: List[GrowArray] = [GrowArray(np.float64) for _ in group_keys]
        self._acc: List[GrowArray] = [GrowArray(np.float64) for _ in aggs]
        self._counts = GrowArray(np.float64)

    @staticmethod
    def _init_of(spec) -> float:
        return math.inf if spec.func == "min" else (-math.inf if spec.func == "max" else 0.0)

    def _new_groups(self, n_new: int) -> None:
        for acc, spec in zip(self._acc, self.aggs):
            acc.append(np.full(n_new, self._init_of(spec)))
        self._counts.append(np.zeros(n_new))

    def _add_groups(self, keys: List[np.ndarray]) -> None:
        """Append new groups' key values and fresh accumulators."""
        for gc, col in zip(self.group_cols, keys):
            gc.append(np.asarray(col, dtype=np.float64))
        self._new_groups(len(keys[0]))

    def _index(self) -> MultiKeyIndex:
        """The group-id index, with every appended batch flushed into it."""
        if self._pending:
            pending, self._pending = self._pending, []
            for first, keys in pending:
                gids, is_new = self._gidx.lookup_or_insert(keys)
                assert is_new.all() and np.array_equal(
                    gids, first + np.arange(len(gids))
                ), "a deferred group insert met a group already in the index"
        return self._gidx

    def append_groups(self, keys: List[np.ndarray]) -> np.ndarray:
        """Give groups known to be absent from this partial the next ids, in
        the given row order, without a lookup: keys and fresh accumulators
        are appended now, the index insert waits for ``_index``. The
        caller vouches that no key is already a group here (the cohort
        fold's count invariant, ``Pipeline._agg_fold_cohort``)."""
        first = self._counts.n
        self._add_groups(keys)
        self._pending.append((first, list(keys)))
        return first + np.arange(len(keys[0]), dtype=np.int64)

    def _group_ids(self, keys: List[np.ndarray], n: int) -> np.ndarray:
        if not keys:
            # global aggregate: single group
            if not self._global_ready:
                self._global_ready = True
                self._new_groups(1)
            return np.zeros(n, dtype=np.int64)
        gids, is_new = self._index().lookup_or_insert(keys)
        if is_new.any():
            sel = np.flatnonzero(is_new)  # gids[sel] == old n_groups + arange
            self._add_groups([np.asarray(k)[sel] for k in keys])
        return gids

    def fold_partials(self, gids: np.ndarray, counts, agg_partials) -> None:
        """Scatter pre-reduced per-group partials onto already-assigned
        accumulator ids (§11 cohort steady state: no hashing at all).
        ``gids`` must be distinct (one row per touched group), which lets
        every scatter use buffered fancy indexing instead of ``ufunc.at``."""
        cd = self._counts.data
        cd[gids] += counts
        for acc, spec, partial in zip(self._acc, self.aggs, agg_partials):
            if spec.distinct:
                raise ValueError("distinct aggregates cannot fold from partials")
            ad = acc.data
            if spec.func == "min":
                ad[gids] = np.minimum(ad[gids], partial)
            elif spec.func == "max":
                ad[gids] = np.maximum(ad[gids], partial)
            else:  # sum / avg / count partials add
                ad[gids] += partial

    def update(self, key_cols, agg_values, n, segment_sum, distinct_idx) -> None:
        gids = self._group_ids(key_cols, n)
        ngroups = self._counts.n
        cnt = segment_sum(gids, None, ngroups)
        self._counts.data[:] += cnt
        for j, (acc, spec) in enumerate(zip(self._acc, self.aggs)):
            vals = agg_values[j]
            if spec.distinct:
                # count(distinct expr): one batched lookup flags the
                # never-seen pairs (state-level index: dedup is global
                # across partitions, so merged counts stay exact)
                dkey = list(key_cols) + [vals] if self.distinct_global else [gids, vals]
                _, fresh = distinct_idx[j].lookup_or_insert(dkey)
                if fresh.any():
                    acc.data[:] += np.bincount(gids[fresh], minlength=ngroups)
            elif spec.func == "count":
                acc.data[:] += cnt
            elif spec.func in ("sum", "avg"):
                acc.data[:] += segment_sum(gids, vals, ngroups)
            elif spec.func == "min":
                np.minimum.at(acc.data, gids, vals)
            elif spec.func == "max":
                np.maximum.at(acc.data, gids, vals)
            else:
                raise ValueError(spec.func)

    @property
    def n_groups(self) -> int:
        return self._counts.n


class SharedAggregateState:
    """Shared aggregate state under exact aggregate identity (§4.5).

    Input occurrences collapse into group accumulators, so the state cannot
    be repartitioned under a different predicate/grouping — sharing is
    all-or-nothing per identity, enforced by the signature. Supports
    sum/count/avg/min/max; group-id assignment and the count(distinct expr)
    seen-pairs both run on batched ``MultiKeyIndex`` lookups (DESIGN.md §8).

    Under ``n_partitions > 1`` each scan partition folds into its own
    partial accumulator; ``result()`` merges partials in partition-id order
    (DESIGN.md §9) — deterministic under any worker interleaving because
    each partition's morsel stream is fixed. count(distinct) seen-pairs
    dedup through one state-level index keyed on the actual group-key
    values (not partial-local gids), so cross-partition duplicates count
    once no matter which partial observed them first."""

    def __init__(
        self,
        state_id: int,
        sig: Optional[StateSignature],
        group_keys: Tuple[str, ...],
        aggs,
        counters: Optional[Dict] = None,
        n_partitions: int = 1,
    ):
        self.state_id = state_id
        self.sig = sig
        self.group_keys = tuple(group_keys)
        self.aggs = tuple(aggs)
        self.n_partitions = max(1, int(n_partitions))
        self._counters = counters

        self._parts = [
            _AggPartial(
                self.group_keys, self.aggs, counters, distinct_global=self.n_partitions > 1
            )
            for _ in range(self.n_partitions)
        ]
        if self.n_partitions == 1:
            # seed layout: (partial-local gid, value) pairs — bijective with
            # the key tuple inside one partial
            self._distinct_idx: List[Optional[MultiKeyIndex]] = [
                MultiKeyIndex(2, counters=counters) if a.distinct else None
                for a in self.aggs
            ]
        else:
            self._distinct_idx = [
                MultiKeyIndex(len(self.group_keys) + 1, counters=counters)
                if a.distinct
                else None
                for a in self.aggs
            ]
        self._merge_cache = None  # (stamp, gcols, accs, counts)

        self.complete = False
        self.refs: set = set()
        self.rows_consumed = 0
        # lifecycle (§10): same pin/epoch/tombstone surface as hash states
        self.pins: set = set()
        self.retired_epoch: Optional[int] = None
        self.evicted = False
        # fault plane (§16): a quarantined state is mid-tombstone — its
        # fragments may be corrupt, so teardown must neither retire it for
        # later grafts nor spill it into the reuse plane.
        self.quarantined = False

    def update(
        self,
        key_cols: List[np.ndarray],
        agg_values: List[Optional[np.ndarray]],
        n: int,
        segment_sum=None,
        part: int = 0,
    ) -> None:
        """Fold one morsel of rows into partition ``part``'s accumulators
        (segment reduce).

        ``segment_sum(gids, values_or_None, n_groups)`` lets an execution
        backend (api/backends.py) supply the grouped reduction — e.g. the
        Pallas one-hot MXU kernel; defaults to ``np.bincount``."""
        if n == 0:
            return
        self._check_live()
        self.rows_consumed += n
        if segment_sum is None:
            segment_sum = _bincount_segment_sum
        self._parts[part].update(key_cols, agg_values, n, segment_sum, self._distinct_idx)

    # -- batched multi-member entry points (§11) ------------------------------
    def map_groups(self, key_cols: List[np.ndarray], part: int = 0) -> np.ndarray:
        """Accumulator id per group-key row (one row per group), assigning
        unseen groups new ids *in the given row order* — the caller passes
        a member's unseen groups in its first-occurrence order, which makes
        accumulator layout bit-identical to row-level ``update``. For
        global aggregates (no group keys) returns the single group's id.
        Groups appended by ``append_groups`` enter the index first, in
        their order, so the lookup sees them under the ids they were given."""
        self._check_live()
        part_acc = self._parts[part]
        if not key_cols:
            return part_acc._group_ids([], 1)
        return part_acc._group_ids(list(key_cols), len(key_cols[0]))

    def append_groups(self, key_cols: List[np.ndarray], part: int = 0) -> np.ndarray:
        """New accumulator ids for groups the caller knows partition
        ``part`` does not hold, in the given row order, with no hashing
        (``_AggPartial.append_groups``): the same ids ``map_groups`` would
        give them. Only for states with group keys."""
        self._check_live()
        return self._parts[part].append_groups(list(key_cols))

    def part_groups(self, part: int = 0) -> int:
        """Groups held by partition ``part``'s accumulators."""
        return self._parts[part].n_groups

    def fold_groups(
        self,
        gids: np.ndarray,
        counts: np.ndarray,
        agg_partials: List[np.ndarray],
        n_rows: int,
        part: int = 0,
    ) -> None:
        """Fold pre-reduced per-group partials onto mapped accumulator ids
        (§11 cohort pass): sum/count/avg partials add, min/max merge —
        exactly equivalent to ``update`` over the member's selected rows
        because the partials were accumulated in the same row order.
        Distinct aggregates cannot fold this way (their dedup is
        per-state); the runtime routes them through ``update``."""
        if n_rows == 0:
            return
        self._check_live()
        self.rows_consumed += n_rows
        self._parts[part].fold_partials(gids, counts, agg_partials)

    def update_groups(
        self,
        key_cols: List[np.ndarray],
        counts: np.ndarray,
        agg_partials: List[np.ndarray],
        n_rows: int,
        part: int = 0,
    ) -> None:
        """``map_groups`` + ``fold_groups`` in one call (one row per
        touched group, in the member's first-occurrence order)."""
        if n_rows == 0:
            return
        gids = self.map_groups(key_cols, part=part)
        self.fold_groups(gids, counts, agg_partials, n_rows, part=part)

    # -- deterministic partial merge (DESIGN.md §9) ---------------------------
    def _merged(self):
        """Merge partials in partition-id order; cached by a consumption
        stamp. Only reached when n_partitions > 1."""
        stamp = (self.rows_consumed, tuple(p.n_groups for p in self._parts))
        if self._merge_cache is not None and self._merge_cache[0] == stamp:
            return self._merge_cache[1:]
        K = len(self.group_keys)
        midx = MultiKeyIndex(K) if K else None
        gcols = [GrowArray(np.float64) for _ in range(K)]
        accs = [GrowArray(np.float64) for _ in self.aggs]
        counts = GrowArray(np.float64)
        for p in self._parts:
            npg = p.n_groups
            if npg == 0:
                continue
            if K:
                keys = [gc.data for gc in p.group_cols]
                gids, is_new = midx.lookup_or_insert(keys)
                n_new = int(is_new.sum())
                if n_new:
                    sel = np.flatnonzero(is_new)
                    for k in range(K):
                        gcols[k].append(keys[k][sel])
                    for acc, spec in zip(accs, self.aggs):
                        acc.append(np.full(n_new, _AggPartial._init_of(spec)))
                    counts.append(np.zeros(n_new))
            else:
                gids = np.zeros(1, dtype=np.int64)
                if counts.n == 0:
                    for acc, spec in zip(accs, self.aggs):
                        acc.append(np.full(1, _AggPartial._init_of(spec)))
                    counts.append(np.zeros(1))
            np.add.at(counts.data, gids, p._counts.data)
            for acc, pacc, spec in zip(accs, p._acc, self.aggs):
                if spec.func == "min":
                    np.minimum.at(acc.data, gids, pacc.data)
                elif spec.func == "max":
                    np.maximum.at(acc.data, gids, pacc.data)
                else:  # sum / avg / count / count-distinct partials add
                    np.add.at(acc.data, gids, pacc.data)
        if self._counters is not None:
            self._counters["partition_merges"] += 1
        self._merge_cache = (stamp, gcols, accs, counts)
        return gcols, accs, counts

    def result(self) -> Dict[str, np.ndarray]:
        if self.n_partitions == 1:
            p = self._parts[0]
            gcols, accs, counts = p.group_cols, p._acc, p._counts
        else:
            gcols, accs, counts = self._merged()
        out: Dict[str, np.ndarray] = {}
        for k, name in enumerate(self.group_keys):
            out[name] = gcols[k].data.copy()
        for acc, spec in zip(accs, self.aggs):
            if spec.func == "avg":
                with np.errstate(invalid="ignore", divide="ignore"):
                    out[spec.name] = acc.data / np.maximum(counts.data, 1e-300)
            else:
                out[spec.name] = acc.data.copy()
        return out

    def attach(self, qid: int) -> None:
        self._check_live()
        self.refs.add(qid)

    def detach(self, qid: int) -> None:
        self.refs.discard(qid)

    # -- lifecycle (§10, shared with SharedHashBuildState) -------------------
    def _check_live(self) -> None:
        if self.evicted:
            raise RuntimeError(
                f"aggregate state #{self.state_id} was evicted — no lens may observe it"
            )

    def pin(self, token) -> None:
        self._check_live()
        self.pins.add(token)

    def unpin(self, token) -> None:
        self.pins.discard(token)

    @property
    def evictable(self) -> bool:
        return not self.refs and not self.pins and not self.evicted

    def nbytes(self) -> int:
        """Accumulator footprint estimate: per-group key + agg + count
        columns (float64) summed over partials, plus the fixed per-state
        overhead (floor — keeps empty states selectable by force-evict)."""
        per_group = 8 * (len(self.group_keys) + len(self.aggs) + 1)
        groups = sum(p.n_groups for p in self._parts)
        return 64 + groups * per_group

    @property
    def n_groups(self) -> int:
        if self.n_partitions == 1:
            return self._parts[0].n_groups
        return self._merged()[2].n


# ---------------------------------------------------------------------------
# Retention lifecycle (DESIGN.md §10)
# ---------------------------------------------------------------------------


class StateLifecycle:
    """Retention lifecycle of shared operator state.

    ``refcount`` — the evaluated prototype's policy (paper §6.1): the engine
    drops a state the moment no query references it; the lifecycle manager
    is inert. ``epoch`` — zero-pin states are *retired* instead: stamped
    with the next retention epoch and kept in the shared-state index so
    later arrivals can graft represented extents onto their coverage. A
    memory-budgeted evictor reclaims retired states oldest-epoch-first
    whenever their total bytes exceed ``memory_budget`` (None = retain
    without bound).

    Invariants (asserted throughout):

    * retirement tracks *lenses*: a state retires when its last ref
      detaches, whether or not admission pins are held — pins block
      EVICTION, not retirement (``victims`` skips non-evictable states,
      and a pinned retired state resumes eviction eligibility, at its
      original epoch, the moment its pins drop);
    * pinned ⇒ not evictable: a state with a live lens (``refs``) or an
      admission pin (``pins``) is never handed to the evictor;
    * retired ⇔ ``retired_epoch is not None`` ⇔ present in ``retired``;
    * the budget governs the *evictable* retained bytes: pinned-retired
      bytes belong to the admission-bounded working set (no evictor can
      reclaim what a queued-but-admissible lens may still observe);
    * evicted states are tombstoned (``evicted``) and removed from every
      index — re-observation raises instead of answering from reclaimed
      fragments.
    """

    def __init__(self, policy: str = "refcount", memory_budget: Optional[int] = None,
                 counters: Optional[Dict] = None):
        self.policy = policy
        self.memory_budget = memory_budget
        self.counters = counters if counters is not None else {}
        self._epoch = 0
        # state_id -> state, values ordered by retirement epoch (dicts are
        # insertion-ordered and every retire stamps a fresh epoch)
        self.retired: Dict[int, object] = {}

    @property
    def epoch(self) -> int:
        return self._epoch

    def retire(self, state) -> None:
        """Stamp a zero-ref state with the next retention epoch. Admission
        pins do not block retirement — only eviction (``victims`` skips
        pinned states until their pins drop)."""
        if state.refs or state.evicted:
            raise RuntimeError(
                f"retiring state #{state.state_id} with live lenses: refs={state.refs}"
            )
        if state.retired_epoch is not None:
            return
        self._epoch += 1
        state.retired_epoch = self._epoch
        self.retired[state.state_id] = state

    def revive(self, state) -> None:
        """A new lens attached (or pinned) a retired state: back to live."""
        if state.retired_epoch is not None:
            state.retired_epoch = None
            self.retired.pop(state.state_id, None)
            self.counters["state_revivals"] = self.counters.get("state_revivals", 0) + 1

    def drop(self, state) -> None:
        self.retired.pop(state.state_id, None)
        state.retired_epoch = None

    def retired_bytes(self) -> int:
        """Bytes of *evictable* retained state — the budget's domain.
        Pinned-retired states (a queued-but-admissible lens holds them)
        count toward the admission-bounded working set instead."""
        return sum(s.nbytes() for s in self.retired.values() if s.evictable)

    def victims(self, budget: Optional[int] = None) -> List:
        """Retired states to evict, oldest epoch first, until the evictable
        retained bytes fit ``budget`` (defaults to the configured memory
        budget). Pinned states are skipped — never evicted."""
        budget = self.memory_budget if budget is None else budget
        if budget is None:
            return []
        total = self.retired_bytes()
        out: List = []
        for s in list(self.retired.values()):  # epoch order by construction
            if total <= budget:
                break
            if not s.evictable:
                continue
            out.append(s)
            total -= s.nbytes()
        return out
