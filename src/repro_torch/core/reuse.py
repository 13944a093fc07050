"""Reuse plane: completed operator state as a first-class cached artifact.

GraftDB's folding (§5) only exploits overlap with *live* executions: once
the §10 epoch evictor reclaims a retired state, a repeat arrival recomputes
from scratch even though the identical operator state was just
materialized. The reuse plane closes that gap (DESIGN.md §12):

* **Spill instead of destroy** — when the evictor would reclaim a retired
  zero-pin state, the engine first serializes its SoA into a tiered
  ``ArtifactStore`` (host-memory tier under ``reuse_cache_budget`` bytes,
  plus an optional on-disk tier under a temp dir). The live object is then
  tombstoned exactly as before — §10's invariant that no lens can observe
  an evicted *object* is untouched; only the bytes get a second life.
* **Semantic indexing** — artifacts are keyed by a canonical *plan
  fingerprint*: the state signature (operator class + structural input,
  ``descriptors.py``) extended with the canonical predicate intervals of
  the completed extents (hash builds) or the aggregate identity's input
  condition + group keys (which the aggregate signature already carries).
  Lookups are semantic, never pointer-based: a repeat arrival finds the
  artifact through the same signature selection ``resolve_boundary`` uses
  for live states.
* **Rehydration** — reconstructs a live ``SharedHashBuildState`` /
  ``SharedAggregateState`` that later grafts attach to exactly as if it
  had never left: the SoA columns, extent registry (predicate + completion
  + per-partition delivery frontiers), and provenance masks are restored
  bit-identically; per-query visibility words and slots come back empty
  (every lens that observed the state detached before retirement — §10
  clears its bits), and the did/probe indexes are derived structures that
  rebuild deterministically from the restored columns.
* **Three-way cost decision** — each arrival's boundary is scored across
  graft-onto-live-execution, rehydrate-a-cached-artifact (scan bytes saved
  minus rehydration cost), and isolated recompute (``reuse_scores``); the
  chosen class surfaces in EXPLAIN GRAFT as ``served_from_cache`` with
  represented/residual/unattached still summing exactly to demand.

The same ``ArtifactStore`` backs the serving plane: retired KV prefixes
spill into it and rehydrate as live ``PrefixState``s (serve/folding.py).
"""

from __future__ import annotations

import io
import os
import shutil
import tempfile
import time
import weakref
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .descriptors import StateSignature, aggregate_signature, hash_build_signature
from .plans import collect_subtree_pred
from .predicates import Conjunction, Coverage, evaluate_conj
from .state import ALL_EXTENTS, SharedAggregateState, SharedHashBuildState

#: Modeled per-row rehydration cost (seconds) — bulk SoA copy plus the
#: amortized share of the derived-index rebuild. Used when the engine's
#: cost model predates the ``rehydrate`` key (core/costmodel.py calibrates
#: it against the host).
REHYDRATE_COST_S = 60e-9


# ---------------------------------------------------------------------------
# Canonical plan fingerprints
# ---------------------------------------------------------------------------


def hash_state_fingerprint(sig: StateSignature, extents) -> tuple:
    """Fingerprint of a hash-build artifact: the structural signature key
    (operator class + build subtree skeleton + keys + payload layout)
    extended with the canonical predicate intervals of every *completed*
    extent. Two states with the same skeleton but different delivered
    predicate ranges therefore never collide — a near-miss (same keys,
    different intervals) is a distinct fingerprint, and reuse of it is
    decided by coverage, not by identity."""
    interval_keys = sorted(
        (conj.key() for conj, done in extents if done and conj is not None),
        key=repr,
    )
    return ("hash_build", sig.key, tuple(interval_keys))


def aggregate_fingerprint(sig: StateSignature) -> tuple:
    """Aggregate artifacts are exact identities (§4.5): the signature key
    already canonicalizes the input condition's predicate intervals, the
    group keys, and the aggregate specs."""
    return ("aggregate", sig.key)


def prefix_fingerprint(tokens: Tuple[int, ...]) -> tuple:
    """KV-prefix artifacts (serving plane): the token sequence IS the
    semantic identity; matching is longest-common-prefix at lookup."""
    return ("kv_prefix", tuple(tokens))


# ---------------------------------------------------------------------------
# Artifacts + the tiered store
# ---------------------------------------------------------------------------


class CorruptArtifact(Exception):
    """A disk-tier artifact failed its integrity check (checksum mismatch,
    truncation, or an unreadable archive). Never escapes the store: ``get``
    converts it to a cache miss (§16)."""


class StateArtifact:
    """One spilled state: small always-resident ``meta`` (fingerprint,
    signature, extent registry, scalar counters) plus the bulk ``arrays``
    payload, which the disk tier offloads to an ``.npz`` file."""

    __slots__ = ("fingerprint", "kind", "sig", "nbytes", "meta", "arrays", "seq")

    def __init__(self, fingerprint: tuple, kind: str, sig, nbytes: int,
                 meta: Dict, arrays: Dict[str, np.ndarray]):
        self.fingerprint = fingerprint
        self.kind = kind
        self.sig = sig
        self.nbytes = int(nbytes)
        self.meta = meta
        self.arrays = arrays
        self.seq = 0  # spill order, stamped by the store


class ArtifactStore:
    """Tiered artifact cache with oldest-spill-first eviction.

    * memory tier — artifacts resident in-process, bounded by ``budget``
      bytes. Insertion order is spill order, which under §10 is retirement-
      epoch order, so FIFO eviction preserves the evictor's oldest-first
      semantics.
    * disk tier (optional) — artifacts evicted from the memory tier demote
      to ``.npz`` files under a private temp dir, bounded by
      ``disk_budget`` bytes; metadata stays resident, only the array
      payload pages out. Disk overflow evicts (deletes) oldest-first.

    Counters (written into the shared engine/scheduler counter dict):
    ``cache_spills`` / ``cache_evictions`` increments, ``cache_bytes`` /
    ``cache_disk_bytes`` gauges, and their high-water marks. The budgets
    are enforced structurally — every ``put`` evicts to fit before
    inserting, so the gauges can never exceed them."""

    def __init__(self, budget: int, disk_budget: Optional[int] = None,
                 counters: Optional[Dict] = None):
        self.budget = int(budget)
        self.disk_budget = disk_budget
        self.counters = counters if counters is not None else {}
        self._mem: "OrderedDict[tuple, StateArtifact]" = OrderedDict()
        self._disk: "OrderedDict[tuple, StateArtifact]" = OrderedDict()  # arrays=None
        self._paths: Dict[tuple, str] = {}
        self._by_sig: Dict[tuple, List[tuple]] = {}  # (kind, sig.key) -> [fingerprint]
        self._dir: Optional[str] = None
        self._finalizer = None  # rmtree-on-GC guard for the temp dir
        self._sums: Dict[tuple, int] = {}  # fingerprint -> crc32 of the .npz bytes
        self._seq = 0
        self.mem_bytes = 0
        self.disk_bytes = 0
        self.closed = False
        if disk_budget is not None:
            self._sweep_stale()

    # -- bookkeeping ---------------------------------------------------------
    def _bump(self, key: str, v: float) -> None:
        self.counters[key] = self.counters.get(key, 0) + v

    def _gauge(self) -> None:
        c = self.counters
        c["cache_bytes"] = self.mem_bytes
        if self.mem_bytes > c.get("cache_high_water_bytes", 0):
            c["cache_high_water_bytes"] = self.mem_bytes
        c["cache_disk_bytes"] = self.disk_bytes
        if self.disk_bytes > c.get("cache_disk_high_water_bytes", 0):
            c["cache_disk_high_water_bytes"] = self.disk_bytes

    def _sig_key(self, fp: tuple) -> tuple:
        return (fp[0], fp[1])

    def _index_add(self, fp: tuple) -> None:
        self._by_sig.setdefault(self._sig_key(fp), []).append(fp)

    def _index_drop(self, fp: tuple) -> None:
        lst = self._by_sig.get(self._sig_key(fp))
        if lst and fp in lst:
            lst.remove(fp)
            if not lst:
                self._by_sig.pop(self._sig_key(fp), None)

    # -- disk tier -----------------------------------------------------------
    @staticmethod
    def _sweep_stale() -> None:
        """Best-effort reclamation of ``graftdb-torch-reuse-*`` temp dirs whose
        owning process is gone (crashed or SIGKILLed before its finalizer
        ran). Each dir carries an ``owner.pid`` marker; a dir with no
        marker is only swept once comfortably stale, so a sibling store
        mid-``mkdtemp`` is never raced."""
        root = tempfile.gettempdir()
        try:
            names = os.listdir(root)
        except OSError:
            return
        for name in sorted(names):
            if not name.startswith("graftdb-torch-reuse-"):
                continue
            d = os.path.join(root, name)
            if not os.path.isdir(d):
                continue
            try:
                with open(os.path.join(d, "owner.pid")) as f:
                    pid = int(f.read().strip())
            except (OSError, ValueError):
                try:
                    stale = time.time() - os.path.getmtime(d) > 3600.0
                except OSError:
                    continue
                if stale:
                    shutil.rmtree(d, ignore_errors=True)
                continue
            if pid == os.getpid():
                continue
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                shutil.rmtree(d, ignore_errors=True)
            except OSError:
                continue  # alive but not ours (EPERM) — leave it

    def _disk_path(self, art: StateArtifact) -> str:
        if self._dir is None:
            self._dir = tempfile.mkdtemp(prefix="graftdb-torch-reuse-")
            with open(os.path.join(self._dir, "owner.pid"), "w") as f:
                f.write(str(os.getpid()))
            # the dir dies with the store even when close() is never
            # called (interpreter exit, store dropped without flush)
            self._finalizer = weakref.finalize(
                self, shutil.rmtree, self._dir, True
            )
        return os.path.join(self._dir, f"art{art.seq}.npz")

    def _demote(self, art: StateArtifact) -> bool:
        """Move one memory-tier artifact's payload to disk. Returns False
        (drop it instead) when the disk tier is off or cannot fit it."""
        if self.disk_budget is None or art.nbytes > self.disk_budget:
            return False
        while self.disk_bytes + art.nbytes > self.disk_budget and self._disk:
            self._evict_disk_oldest()
        path = self._disk_path(art)
        np.savez(path, **art.arrays)
        with open(path, "rb") as f:
            self._sums[art.fingerprint] = zlib.crc32(f.read())
        shadow = StateArtifact(art.fingerprint, art.kind, art.sig, art.nbytes,
                               art.meta, arrays=None)
        shadow.seq = art.seq
        self._disk[art.fingerprint] = shadow
        self._paths[art.fingerprint] = path
        self.disk_bytes += art.nbytes
        return True

    def _evict_disk_oldest(self) -> None:
        fp, art = next(iter(self._disk.items()))
        self._disk.pop(fp)
        self._remove_file(fp)
        self._index_drop(fp)
        self.disk_bytes -= art.nbytes
        self._bump("cache_evictions", 1)

    def _remove_file(self, fp: tuple) -> None:
        self._sums.pop(fp, None)
        path = self._paths.pop(fp, None)
        if path is not None and os.path.exists(path):
            os.unlink(path)

    def _load_arrays(self, fp: tuple) -> Dict[str, np.ndarray]:
        """Read one disk-tier payload, verified against its spill-time
        crc32. Truncation, bit flips, or an unreadable archive raise
        ``CorruptArtifact`` — callers convert that to a cache miss."""
        path = self._paths[fp]
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise CorruptArtifact(f"unreadable artifact {path}: {e}") from None
        want = self._sums.get(fp)
        if want is not None and zlib.crc32(raw) != want:
            raise CorruptArtifact(f"checksum mismatch for {path}")
        try:
            with np.load(io.BytesIO(raw)) as z:
                return {k: z[k] for k in z.files}
        except Exception as e:
            raise CorruptArtifact(f"undecodable artifact {path}: {e}") from None

    def _drop_corrupt(self, fp: tuple, shadow: StateArtifact) -> None:
        """Integrity failure ⇒ cache miss (§16): the entry leaves both
        tiers and the miss falls through to recompute — never an error on
        the arrival path."""
        self._disk.pop(fp, None)
        self.disk_bytes -= shadow.nbytes
        self._remove_file(fp)
        self._index_drop(fp)
        self._bump("cache_corrupt", 1)
        self._gauge()

    # -- public surface ------------------------------------------------------
    def put(self, art: StateArtifact) -> bool:
        """Admit one artifact, evicting oldest-first to fit the memory
        budget (overflow demotes to the disk tier when enabled). Returns
        False when the store is closed or the artifact fits no tier."""
        if self.closed:
            return False
        self.remove(art.fingerprint)  # a re-spill replaces, never duplicates
        if art.nbytes > self.budget:
            self._seq += 1
            art.seq = self._seq
            if self._demote(art):
                self._index_add(art.fingerprint)
                self._bump("cache_spills", 1)
                self._gauge()
                return True
            self._bump("cache_evictions", 1)  # nowhere to keep it
            self._gauge()
            return False
        while self.mem_bytes + art.nbytes > self.budget and self._mem:
            old_fp, old = next(iter(self._mem.items()))
            self._mem.pop(old_fp)
            self.mem_bytes -= old.nbytes
            if self._demote(old):
                continue  # stays findable through the disk tier
            self._index_drop(old_fp)
            self._bump("cache_evictions", 1)
        self._seq += 1
        art.seq = self._seq
        self._mem[art.fingerprint] = art
        self.mem_bytes += art.nbytes
        self._index_add(art.fingerprint)
        self._bump("cache_spills", 1)
        self._gauge()
        return True

    def get(self, fp: tuple) -> Optional[StateArtifact]:
        """Artifact by exact fingerprint, payload loaded (the disk tier
        reads its file without promoting)."""
        art = self._mem.get(fp)
        if art is not None:
            return art
        shadow = self._disk.get(fp)
        if shadow is None:
            return None
        try:
            arrays = self._load_arrays(fp)
        except CorruptArtifact:
            self._drop_corrupt(fp, shadow)
            return None
        art = StateArtifact(shadow.fingerprint, shadow.kind, shadow.sig,
                            shadow.nbytes, shadow.meta, arrays)
        art.seq = shadow.seq
        return art

    def take(self, fp: tuple) -> Optional[StateArtifact]:
        """``get`` + remove — rehydration consumes the artifact (the state
        is live again; it will re-spill with fresh coverage when it next
        retires and ages out)."""
        art = self.get(fp)
        if art is not None:
            self.remove(fp)
        return art

    def remove(self, fp: tuple) -> None:
        art = self._mem.pop(fp, None)
        if art is not None:
            self.mem_bytes -= art.nbytes
            self._index_drop(fp)
        shadow = self._disk.pop(fp, None)
        if shadow is not None:
            self.disk_bytes -= shadow.nbytes
            self._remove_file(fp)
            self._index_drop(fp)
        if art is not None or shadow is not None:
            self._gauge()

    def by_sig(self, kind: str, sig_key) -> List[StateArtifact]:
        """Every cached artifact under one structural signature (both
        tiers; disk entries come back as metadata shadows — load on
        demand via ``get``). Order is spill order: deterministic."""
        out = []
        for fp in self._by_sig.get((kind, sig_key), ()):
            art = self._mem.get(fp) or self._disk.get(fp)
            if art is not None:
                out.append(art)
        out.sort(key=lambda a: a.seq)
        return out

    def iter_kind(self, kind: str):
        """All artifacts of one kind, metadata view, spill order."""
        arts = [a for a in self._mem.values() if a.kind == kind]
        arts += [a for a in self._disk.values() if a.kind == kind]
        arts.sort(key=lambda a: a.seq)
        return arts

    def __len__(self) -> int:
        return len(self._mem) + len(self._disk)

    def flush(self) -> None:
        """Drop every artifact (both tiers) and reset the gauges. The temp
        dir is removed here, not left for interpreter exit."""
        self._mem.clear()
        self._disk.clear()
        self._by_sig.clear()
        self._sums.clear()
        for fp in list(self._paths):
            self._remove_file(fp)
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None
        if self._dir is not None and os.path.isdir(self._dir):
            shutil.rmtree(self._dir, ignore_errors=True)
        self._dir = None
        self.mem_bytes = 0
        self.disk_bytes = 0
        self.counters["cache_bytes"] = 0
        self.counters["cache_disk_bytes"] = 0

    def close(self) -> None:
        """Flush and refuse further spills (Session.close)."""
        self.flush()
        self.closed = True


# ---------------------------------------------------------------------------
# Three-way cost scoring (graft / rehydrate / recompute)
# ---------------------------------------------------------------------------


def reuse_scores(cost_model: Dict[str, float], demand_rows: int,
                 covered_rows: int, artifact_entries: int) -> Dict[str, float]:
    """Modeled seconds of the three ways one boundary's build work can be
    served: ``recompute_s`` (isolated: scan + filter + insert every demand
    row), ``saved_s`` (build bytes a lens over the artifact's coverage
    would not re-produce), and ``rehydrate_s`` (bulk SoA restore of the
    artifact's entries). Reuse wins when the savings exceed the
    rehydration cost; grafting onto *live* state has no rehydration term
    and therefore always dominates when a live candidate exists."""
    row = cost_model["scan"] + cost_model["filter"] + cost_model["insert"]
    rehydrate = cost_model.get("rehydrate", REHYDRATE_COST_S)
    return {
        "recompute_s": demand_rows * row,
        "saved_s": covered_rows * row,
        "rehydrate_s": artifact_entries * rehydrate,
    }


def rehydrate_wins(cost_model: Dict[str, float], demand_rows: int,
                   covered_rows: int, artifact_entries: int) -> bool:
    if covered_rows <= 0:
        return False
    s = reuse_scores(cost_model, demand_rows, covered_rows, artifact_entries)
    return s["saved_s"] > s["rehydrate_s"]


# ---------------------------------------------------------------------------
# The reuse plane: spill / select / rehydrate
# ---------------------------------------------------------------------------


class ReusePlane:
    """Engine-side facade over the ArtifactStore: serializes victims on
    eviction, selects + cost-gates artifacts at admission, and rebuilds
    live states on a hit. All selection is deterministic (spill-order
    iteration, pure cost arithmetic), so admission verdicts stay a
    function of engine state alone — the scheduler's drain memoization
    and the PoolClock determinism argument both survive unchanged."""

    def __init__(self, cost_model: Dict[str, float], budget: int,
                 disk_budget: Optional[int] = None, counters: Optional[Dict] = None,
                 faults=None):
        self.cost_model = cost_model
        self.counters = counters if counters is not None else {}
        self.faults = faults  # engine's FaultPlane (rehydrate site), or None
        self.store = ArtifactStore(budget, disk_budget, counters=self.counters)
        # (fingerprint, b_q.key()) -> (fully_covered, granted_entries);
        # artifacts are immutable once spilled, so entries never go stale —
        # removal just orphans them (bounded by store size x predicates).
        self._covered_memo: Dict[tuple, Tuple[bool, int]] = {}

    # -- spill (called by GraftEngine._evict) --------------------------------
    def spill(self, state) -> bool:
        if isinstance(state, SharedHashBuildState):
            return self._spill_hash(state)
        if isinstance(state, SharedAggregateState):
            return self._spill_agg(state)
        return False

    def _spill_hash(self, st: SharedHashBuildState) -> bool:
        extents = [st.extents[eid] for eid in sorted(st.extents)]
        fp = hash_state_fingerprint(st.sig, extents)
        n = st.did.n
        arrays = {
            "did": st.did.data.copy(),
            "keycode": st.keycode.data.copy(),
            "emask": st.emask.data.copy(),
        }
        for a in st.retained_attrs:
            arrays[f"col::{a}"] = st.cols[a].data.copy()
        meta = {
            "state_id": st.state_id,
            "key_attrs": st.key_attrs,
            "payload": st.payload,
            "did_domain": st.did_domain,
            "extents": extents,  # (conj | None, complete) in eid order
            "extent_parts": {
                eid: (total, tuple(sorted(done)))
                for eid, (total, done) in st.extent_parts.items()
            },
            "n_entries": n,
        }
        return self.store.put(
            StateArtifact(fp, "hash_build", st.sig, st.nbytes(), meta, arrays)
        )

    def _spill_agg(self, st: SharedAggregateState) -> bool:
        # Only completed identities are reusable: an attaching lens reads
        # the merged result; incomplete accumulators would need their
        # producer (gone) and distinct seen-pair indexes (not serialized).
        if st.sig is None or not st.complete:
            return False
        fp = aggregate_fingerprint(st.sig)
        arrays: Dict[str, np.ndarray] = {}
        part_groups = []
        for i, p in enumerate(st._parts):
            part_groups.append(p.n_groups)
            for k, gc in enumerate(p.group_cols):
                arrays[f"p{i}_g{k}"] = gc.data.copy()
            for j, acc in enumerate(p._acc):
                arrays[f"p{i}_acc{j}"] = acc.data.copy()
            arrays[f"p{i}_counts"] = p._counts.data.copy()
        meta = {
            "state_id": st.state_id,
            "group_keys": st.group_keys,
            "aggs": st.aggs,
            "n_partitions": st.n_partitions,
            "rows_consumed": st.rows_consumed,
            "part_groups": part_groups,
        }
        return self.store.put(
            StateArtifact(fp, "aggregate", st.sig, st.nbytes(), meta, arrays)
        )

    # -- selection (shared by admission, EXPLAIN, and the controller) --------
    def _artifact_covered(self, art: StateArtifact, b_q: Optional[Conjunction],
                          demand: int) -> int:
        """Demand rows the artifact's coverage would serve as represented
        for build predicate ``b_q`` — the exact mirror of the live
        represented-extent check (§4.3) evaluated on the artifact."""
        if b_q is None:
            return 0
        memo_key = (art.fingerprint, b_q.key())
        hit = self._covered_memo.get(memo_key)
        if hit is not None:
            full, granted = hit
            return demand if full else min(granted, demand)
        retained = frozenset(art.meta["payload"]) | frozenset(art.meta["key_attrs"])
        b_ret = Conjunction({a: c for a, c in b_q.constraints.items() if a in retained})
        b_nonret = Conjunction(
            {a: c for a, c in b_q.constraints.items() if a not in retained}
        )
        completed = [
            (eid, conj)
            for eid, (conj, done) in enumerate(art.meta["extents"])
            if done and conj is not None
        ]
        if not b_nonret.constraints:
            allowed = ALL_EXTENTS
        else:
            allowed = np.uint64(0)
            for eid, conj in completed:
                if conj.implies(b_nonret):
                    allowed |= np.uint64(1) << np.uint64(eid)
        if not allowed:
            self._covered_memo[memo_key] = (False, 0)
            return 0
        cov = Coverage(
            conj for eid, conj in completed
            if (np.uint64(1) << np.uint64(eid)) & allowed
        )
        if cov.covers(b_q):
            self._covered_memo[memo_key] = (True, 0)
            return demand
        arrays = art.arrays
        if arrays is None:  # disk shadow: load for the count, don't promote
            loaded = self.store.get(art.fingerprint)
            arrays = loaded.arrays if loaded is not None else None
        if arrays is None or art.meta["n_entries"] == 0:
            self._covered_memo[memo_key] = (False, 0)
            return 0
        m = (arrays["emask"] & allowed) != 0
        if b_ret.attrs():
            cols = {a: arrays[f"col::{a}"] for a in b_ret.attrs()}
            m = m & evaluate_conj(b_ret, cols)
        granted = int(m.sum())
        self._covered_memo[memo_key] = (False, granted)
        return min(granted, demand)

    def select_hash(self, engine, sig: StateSignature, b_q: Optional[Conjunction],
                    demand: int) -> Optional[Tuple[StateArtifact, int]]:
        """Best cached hash-build artifact for one boundary, or None when
        no artifact passes the three-way cost gate. Deterministic: max
        covered rows, ties to the oldest spill."""
        best: Optional[Tuple[StateArtifact, int]] = None
        for art in self.store.by_sig("hash_build", sig.key):
            covered = self._artifact_covered(art, b_q, demand)
            if covered <= 0:
                continue
            if best is None or covered > best[1]:
                best = (art, covered)
        if best is None:
            return None
        art, covered = best
        if not rehydrate_wins(self.cost_model, demand, covered, art.meta["n_entries"]):
            return None
        return best

    def _agg_saved_rows(self, engine, plan, agg) -> int:
        """Rows an isolated execution of ``plan`` would process that an
        aggregate-identity cache hit eliminates: the aggregate's input
        cardinality plus every boundary's build demand."""
        from .grafting import all_boundaries, estimate_demand

        saved = 0
        # the full-plan input count is only estimable when probe keys live
        # on the spine scan; fall back to the boundary demands alone (a
        # lower bound on saved work, so the gate stays conservative)
        try:
            saved += estimate_demand(engine, agg.input)
        except (TypeError, KeyError):
            pass
        for b in all_boundaries(plan):
            try:
                saved += estimate_demand(engine, b.build)
            except (TypeError, KeyError):
                pass
        return saved

    def peek_agg(self, engine, plan, agg, agg_sig: StateSignature
                 ) -> Optional[StateArtifact]:
        """Cost-gated aggregate artifact peek (read-only; EXPLAIN + the
        admission controller's reuse potential)."""
        art = self.store.get(aggregate_fingerprint(agg_sig))
        if art is None or art.meta["n_partitions"] != engine.n_partitions:
            return None
        saved = self._agg_saved_rows(engine, plan, agg)
        entries = sum(art.meta["part_groups"])
        if not rehydrate_wins(self.cost_model, saved, saved, entries):
            return None
        return art

    # -- rehydration ---------------------------------------------------------
    def _build_hash(self, state_id: int, art: StateArtifact, n_partitions: int,
                    counters, index: bool = True) -> SharedHashBuildState:
        meta = art.meta
        st = SharedHashBuildState(
            state_id,
            art.sig,
            meta["key_attrs"],
            meta["payload"],
            did_domain=meta["did_domain"],
            counters=counters,
            n_partitions=n_partitions,
        )
        arrays = art.arrays
        n = meta["n_entries"]
        if n:
            dids = np.asarray(arrays["did"], dtype=np.int64)
            kcs = np.asarray(arrays["keycode"], dtype=np.int64)
            st.did.append(dids)
            st.keycode.append(kcs)
            st.vis.append(np.zeros(n, dtype=np.uint64))  # no lens survives retirement
            st.emask.append(np.asarray(arrays["emask"], dtype=np.uint64))
            for a in st.retained_attrs:
                st.cols[a].append(np.asarray(arrays[f"col::{a}"], dtype=np.float64))
            if index:
                # derived structure: ids assign 0..n-1 in array order (dids
                # are unique per entry), matching the original exactly
                if st.n_partitions == 1:
                    st._did_index.lookup_or_insert(dids)
                else:
                    st._sharded_did_resolve(dids, kcs, 0)
            st.rows_inserted = n
        for conj, done in meta["extents"]:
            eid = st.register_extent(conj)
            if done:
                st.complete_extent(eid)
        st.extent_parts = {
            eid: (total, set(parts))
            for eid, (total, parts) in meta["extent_parts"].items()
        }
        return st

    def ghost_hash(self, art: StateArtifact) -> Optional[SharedHashBuildState]:
        """Unregistered rehydration for EXPLAIN: a throwaway state object
        carrying the artifact's coverage + entries so the read-only
        decision ladder can score it exactly like a live candidate. Never
        touches the engine (fresh ids, no counters, no did index). None
        when the artifact turns out corrupt at load."""
        if art.arrays is None:
            art = self.store.get(art.fingerprint)
            if art is None:
                return None
        return self._build_hash(art.meta["state_id"], art, 1, None, index=False)

    def _rehydrate_faulted(self, fp: tuple) -> bool:
        """§16 ``rehydrate`` fault site: one draw per rehydration attempt.
        A hit simulates artifact corruption — the entry is dropped and
        counted exactly as a failed integrity check, and the caller falls
        through to recompute."""
        if self.faults is None or not self.faults.fire("rehydrate"):
            return False
        self.store.remove(fp)
        self.counters["cache_corrupt"] = self.counters.get("cache_corrupt", 0) + 1
        return True

    def try_rehydrate_hash(self, engine, handle, sig: StateSignature,
                           b_q: Optional[Conjunction], demand: int
                           ) -> Optional[SharedHashBuildState]:
        """Admission-time rehydration: on a cost-model win, rebuild the
        artifact as a live shared state and register it under its
        signature — ``resolve_boundary``'s ladder then attaches to it
        exactly as to a never-evicted retained state."""
        if not engine.mode.allow_represented:
            return None
        sel = self.select_hash(engine, sig, b_q, demand)
        if sel is None:
            return None
        art, _covered = sel
        if self._rehydrate_faulted(art.fingerprint):
            return None
        if art.arrays is None:
            art = self.store.get(art.fingerprint)
            if art is None:
                return None
        engine._next_state_id += 1
        st = self._build_hash(
            engine._next_state_id, art, engine.n_partitions, engine.counters
        )
        self.store.take(art.fingerprint)
        engine.state_index.setdefault(sig, []).append(st)
        c = engine.counters
        c["cache_hits"] += 1
        c["rehydrate_bytes"] += art.nbytes
        if handle is not None:
            handle.cache_hits += 1
        return st

    def try_rehydrate_agg(self, engine, handle, plan, agg,
                          agg_sig: StateSignature) -> Optional[SharedAggregateState]:
        """Aggregate-identity rehydration: rebuild the completed
        accumulator state and re-register it under its signature; the
        caller's attach path then collapses the whole plan onto it."""
        art = self.peek_agg(engine, plan, agg, agg_sig)
        if art is None:
            return None
        if self._rehydrate_faulted(art.fingerprint):
            return None
        if art.arrays is None:
            art = self.store.get(art.fingerprint)
            if art is None:
                return None
        meta = art.meta
        engine._next_state_id += 1
        st = SharedAggregateState(
            engine._next_state_id,
            agg_sig,
            meta["group_keys"],
            meta["aggs"],
            counters=engine.counters,
            n_partitions=meta["n_partitions"],
        )
        K = len(st.group_keys)
        for i, p in enumerate(st._parts):
            ng = meta["part_groups"][i]
            if ng == 0:
                continue
            for k in range(K):
                p.group_cols[k].append(np.asarray(art.arrays[f"p{i}_g{k}"]))
            for j in range(len(st.aggs)):
                p._acc[j].append(np.asarray(art.arrays[f"p{i}_acc{j}"]))
            p._counts.append(np.asarray(art.arrays[f"p{i}_counts"]))
            if K:
                # rebuild the derived group-id index in stored gid order
                p._index().lookup_or_insert([gc.data for gc in p.group_cols])
            else:
                p._global_ready = True
        st.rows_consumed = meta["rows_consumed"]
        st.complete = True
        self.store.take(art.fingerprint)
        engine.agg_index[agg_sig] = st
        c = engine.counters
        c["cache_hits"] += 1
        c["rehydrate_bytes"] += art.nbytes
        if handle is not None:
            handle.cache_hits += 1
        return st

    def close(self) -> None:
        self.store.close()
        self._covered_memo.clear()


# ---------------------------------------------------------------------------
# Admission-controller signal
# ---------------------------------------------------------------------------


def reuse_potential(engine, query) -> float:
    """Demand-weighted share of the query's plan a *cached artifact* would
    serve — the cache-side companion of ``grafting.graft_potential``
    (which scores live/retained state). 1.0 when the whole plan collapses
    onto a cached aggregate identity; otherwise the share of stateful
    boundaries with no live candidate but a cost-winning artifact.
    Read-only and deterministic."""
    reuse = getattr(engine, "reuse", None)
    if reuse is None:
        return 0.0
    from .grafting import all_boundaries, estimate_demand, plan_spine

    mode = engine.mode
    _, _, agg, _ = plan_spine(query.plan)
    agg_sig = aggregate_signature(agg)
    if agg_sig is not None and mode.agg_share == "full":
        if engine.agg_index.get(agg_sig) is None:
            if reuse.peek_agg(engine, query.plan, agg, agg_sig) is not None:
                return 1.0
    if not (mode.share_state and mode.allow_represented):
        return 0.0
    total = cached = 0
    for j in all_boundaries(query.plan):
        d = estimate_demand(engine, j.build)
        total += d
        sig = hash_build_signature(j)
        if engine.state_index.get(sig):
            continue  # live candidate: graft_potential already counts it
        b_q = Conjunction.from_pred(collect_subtree_pred(j.build))
        if reuse.select_hash(engine, sig, b_q, d) is not None:
            cached += d
    return cached / total if total else 0.0
