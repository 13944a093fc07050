"""Vectorized open-addressing hash index: the shared-state data plane core.

Every shared-state hot path that used to walk a Python ``dict`` per row —
derivation-id dedup in ``SharedHashBuildState.insert_or_mark``, group-id
assignment in ``SharedAggregateState``, count(distinct) seen-sets, and the
probe-side key index — runs on this primitive instead (DESIGN.md §8).

``HashIndex`` maps int64 keys to dense ids (0, 1, 2, ... in first-insertion
order) with batched, fully vectorized ``lookup`` / ``lookup_or_insert``:

* triangular (quadratic) probing over a power-of-two table at ≤ 25% load
  — offsets 0, 1, 3, 6, ... visit every slot of a power-of-two table, and
  the low load plus secondary-cluster avoidance keep the longest probe
  chain (= the number of batched rounds) in the single digits,
* splitmix64 finalizer hash (avalanches the mixed-radix keycodes the
  engine produces, which are highly structured in their low bits),
* batch insertion by optimistic per-slot claims: each round, every still
  unplaced key writes itself into its slot if empty (numpy fancy
  assignment, last writer wins), re-reads to learn whether it survived,
  and the losers advance.  Rounds are whole-batch numpy operations — the
  number of rounds is the longest probe chain, not the batch size,
* amortized capacity doubling (a rehash is itself one batched insert of
  the resident keys), counted via the ``index_rebuilds`` perf counter.

``MultiKeyIndex`` lifts the primitive to tuples of columns (group keys,
(group, value) distinct pairs): each column is compacted to dense ids
through its own ``HashIndex``, adjacent id columns are folded pairwise into
``hi * 2^32 + lo`` codes and re-compacted, so arbitrarily many columns
reduce to one int64 stream with no collision risk (dense ids stay far below
2^32).  Float columns are keyed by their exact bit patterns (with -0.0
canonicalized to +0.0 so numpy float equality and bit equality agree).

The core is NumPy-only; the Pallas batch-insert path for the probe-table
mirror lives in ``kernels/hash_probe.py`` (``hash_build_insert``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

EMPTY_KEY = np.int64(np.iinfo(np.int64).min)  # reserved slot sentinel

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_FOLD = np.int64(1) << np.int64(32)


def _mix64(keys: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over int64 keys -> uint64 hash values."""
    h = keys.astype(np.uint64)
    h = (h ^ (h >> np.uint64(30))) * _M1
    h = (h ^ (h >> np.uint64(27))) * _M2
    return h ^ (h >> np.uint64(31))


def key_partition(keys: np.ndarray, n_partitions: int) -> np.ndarray:
    """Key-hash partition id per int64 key: ``splitmix64(key) % P``.

    This is the one partitioning function of the sharded state plane
    (DESIGN.md §9): shared hash-build states route derivations, probe keys,
    and index shards through it, so a key's shard is stable across the
    producer and consumer sides of every boundary. P == 1 short-circuits to
    an all-zeros vector (the unpartitioned engine never hashes)."""
    keys = np.asarray(keys, dtype=np.int64)
    if n_partitions <= 1:
        return np.zeros(len(keys), dtype=np.int64)
    return (_mix64(keys) % np.uint64(n_partitions)).astype(np.int64)


def float_key_codes(col: np.ndarray) -> np.ndarray:
    """Exact int64 key codes for a float64 column (bit pattern, with -0.0
    canonicalized to +0.0 so float equality matches code equality)."""
    c = np.asarray(col, dtype=np.float64) + 0.0  # -0.0 -> +0.0
    return c.view(np.int64)


class HashIndex:
    """int64 keys -> dense ids in first-insertion order, batch-oriented."""

    __slots__ = ("_keys", "_vals", "n", "rebuilds", "_counters")

    def __init__(self, capacity: int = 256, counters: Optional[Dict] = None):
        cap = 8
        while cap < capacity:
            cap *= 2
        self._keys = np.full(cap, EMPTY_KEY, dtype=np.int64)
        self._vals = np.zeros(cap, dtype=np.int64)
        self.n = 0  # dense ids handed out
        self.rebuilds = 0
        self._counters = counters  # engine counter sink (index_rebuilds)

    # -- queries ----------------------------------------------------------
    def lookup(self, keys: np.ndarray, _hash: Optional[np.ndarray] = None) -> np.ndarray:
        """Dense id per key, -1 where absent. O(batch) whole-batch rounds."""
        keys = np.asarray(keys, dtype=np.int64)
        out = np.full(len(keys), -1, dtype=np.int64)
        if self.n == 0 or len(keys) == 0:
            return out
        tkeys, tvals = self._keys, self._vals
        mask = np.int64(len(tkeys) - 1)
        h = _mix64(keys) if _hash is None else _hash
        pos = (h & np.uint64(mask)).astype(np.int64)
        pend: Optional[np.ndarray] = None  # None = all keys still probing
        cur_keys = keys
        r = np.int64(0)
        while len(pos):
            sk = tkeys[pos]
            hit = sk == cur_keys
            if hit.any():
                tgt = np.flatnonzero(hit) if pend is None else pend[hit]
                out[tgt] = tvals[pos[hit]]
            live = ~hit & (sk != EMPTY_KEY)
            if not live.any():
                break
            pend = np.flatnonzero(live) if pend is None else pend[live]
            r += 1  # triangular offsets: home, +1, +3, +6, ...
            pos = (pos[live] + r) & mask
            cur_keys = keys[pend]
        return out

    def lookup_or_insert(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Dense id per key, inserting absent keys in first-occurrence order.

        Returns ``(ids, is_new)`` — ``is_new[i]`` is True exactly where a
        Python ``dict.setdefault(k, len(dict))`` over the same stream would
        have inserted (first occurrence of a previously absent key)."""
        keys = np.asarray(keys, dtype=np.int64)
        n_in = len(keys)
        is_new = np.zeros(n_in, dtype=bool)
        if n_in == 0:
            return np.empty(0, dtype=np.int64), is_new
        if (keys == EMPTY_KEY).any():
            raise ValueError("int64 min is reserved as the empty-slot sentinel")
        h = _mix64(keys)
        found = self.lookup(keys, _hash=h)
        absent = found < 0
        if absent.any():
            # dedupe only the absent subset (usually far smaller than the
            # batch), in first-occurrence order for dict parity
            aidx = np.flatnonzero(absent)
            uniq, first, inv = np.unique(keys[aidx], return_index=True, return_inverse=True)
            order = np.argsort(first, kind="stable")
            rank = np.empty(len(uniq), dtype=np.int64)
            rank[order] = np.arange(len(uniq), dtype=np.int64)
            n_new = len(uniq)
            self._reserve(self.n + n_new)
            new_ids = self.n + np.arange(n_new, dtype=np.int64)
            src = aidx[first[order]]  # first occurrence of each new key
            self._insert_unique(keys[src], new_ids, _hash=h[src])
            self.n += n_new
            found[aidx] = new_ids[rank[np.asarray(inv).ravel()]]
            is_new[src] = True
        return found, is_new

    # -- internals --------------------------------------------------------
    def _reserve(self, target: int) -> None:
        cap = len(self._keys)
        if 4 * target <= cap:
            return
        while cap < 4 * target:
            cap *= 2
        old_keys, old_vals = self._keys, self._vals
        live = old_keys != EMPTY_KEY
        self._keys = np.full(cap, EMPTY_KEY, dtype=np.int64)
        self._vals = np.zeros(cap, dtype=np.int64)
        self._insert_unique(old_keys[live], old_vals[live])
        self.rebuilds += 1
        if self._counters is not None:
            self._counters["index_rebuilds"] += 1

    def _insert_unique(
        self, keys: np.ndarray, vals: np.ndarray, _hash: Optional[np.ndarray] = None
    ) -> None:
        """Batch-insert keys known to be distinct and absent: optimistic
        claims (fancy assignment, last writer per slot wins), survival
        check by re-read, then an unconditional value write for the
        survivors so the key/value pairing never depends on numpy's
        duplicate-index write order. Non-winners advance."""
        tkeys, tvals = self._keys, self._vals
        mask = np.int64(len(tkeys) - 1)
        h = _mix64(keys) if _hash is None else _hash
        pos = (h & np.uint64(mask)).astype(np.int64)
        pend: Optional[np.ndarray] = None
        cur_keys = keys
        r = np.int64(0)
        while len(pos):
            free = tkeys[pos] == EMPTY_KEY
            if free.any():
                pf = pos[free]
                tkeys[pf] = cur_keys[free]  # optimistic claim
                won = free & (tkeys[pos] == cur_keys)  # survived the write?
                wp = pos[won]
                tvals[wp] = vals[won] if pend is None else vals[pend[won]]
                live = ~won
            else:
                live = np.ones(len(pos), dtype=bool)
            if not live.any():
                break
            pend = np.flatnonzero(live) if pend is None else pend[live]
            r += 1  # triangular offsets, matching lookup()
            pos = (pos[live] + r) & mask
            cur_keys = keys[pend]

    def __len__(self) -> int:
        return self.n

    def __contains__(self, key: int) -> bool:
        return int(self.lookup(np.asarray([key], dtype=np.int64))[0]) >= 0


class MultiKeyIndex:
    """Dense ids for tuples of column values (group keys, distinct pairs).

    Columns may be float64 (keyed by exact bit pattern) or any integer
    dtype (keyed by value). Dense ids are assigned in first-occurrence
    order of the full tuple, matching a ``dict`` over tuple keys."""

    __slots__ = ("_cols", "_folds", "n")

    def __init__(self, n_cols: int, counters: Optional[Dict] = None):
        if n_cols < 1:
            raise ValueError("MultiKeyIndex needs at least one key column")
        self._cols = [HashIndex(counters=counters) for _ in range(n_cols)]
        self._folds = [HashIndex(counters=counters) for _ in range(n_cols - 1)]
        self.n = 0

    @staticmethod
    def _codes(col: np.ndarray) -> np.ndarray:
        col = np.asarray(col)
        if col.dtype.kind == "f":
            return float_key_codes(col)
        return col.astype(np.int64)

    def lookup_or_insert(self, cols: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        if len(cols) != len(self._cols):
            raise ValueError("column count mismatch")
        ids, is_new = self._cols[0].lookup_or_insert(self._codes(cols[0]))
        for k in range(1, len(cols)):
            nxt, _ = self._cols[k].lookup_or_insert(self._codes(cols[k]))
            ids, is_new = self._folds[k - 1].lookup_or_insert(ids * _FOLD + nxt)
        self.n = (self._folds[-1] if self._folds else self._cols[0]).n
        return ids, is_new
