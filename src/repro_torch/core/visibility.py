"""Per-query visibility metadata (§4.2) and packed-mask primitives (§11).

Rows and state entries carry per-query visibility as packed uint64 bitmasks.
A per-state slot allocator maps attached query ids to bit positions; slots
are recycled on query completion. One physical row/entry therefore serves
every attached query whose bit (or extent-scoped grant, see state.py) is set
— the runtime never materializes per-query copies.

The member-major data plane (DESIGN.md §11) additionally needs two
member-count-independent bulk operations on packed word columns:

* ``translate_bits`` — map each row's word through an arbitrary
  slot -> uint64 target table (state-slot lens words to pipeline ownership
  bits, pipeline bits to beneficiary visibility masks). Implemented as
  byte-wise table lookups: 8 gathers per row regardless of how many slots
  are live, with empty byte lanes skipped so small waves pay ~1 gather.
* ``slot_popcounts`` — per-slot set-bit counts of a word column via byte
  histograms × a bit matrix, replacing one popcount pass per member.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np

MAX_SLOTS = 64

U64_0 = np.uint64(0)
_U8_MASK = np.uint64(0xFF)

#: [256, 8] — bit i of byte value v (shared by the translate/popcount passes)
_BYTE_BITS = ((np.arange(256, dtype=np.int64)[:, None] >> np.arange(8)) & 1)
_BYTE_BITS_BOOL = _BYTE_BITS.astype(bool)


def translation_table(target: np.ndarray) -> np.ndarray:
    """Byte-lookup tables for :func:`translate_bits`.

    ``target`` is a ``uint64[64]`` map from slot to an arbitrary output
    word; the result ``tables[b][v]`` ORs ``target[8b + i]`` over the bits
    ``i`` set in byte value ``v``, so a full 64-bit word translates in 8
    byte gathers. Build cost is O(8 × 256), paid once per member wave."""
    tables = np.zeros((8, 256), dtype=np.uint64)
    for b in range(8):
        seg = target[8 * b : 8 * b + 8]
        if not seg.any():
            continue
        tables[b] = np.bitwise_or.reduce(
            np.where(_BYTE_BITS_BOOL, seg[None, :], U64_0), axis=1
        )
    return tables


def translate_bits(words: np.ndarray, tables: np.ndarray) -> np.ndarray:
    """Per-row OR of the targets of every bit set in ``words``.

    One byte-table gather per non-empty lane — member-count independent
    (the per-member alternative is one shift/AND/OR triple per member)."""
    out = None
    for b in range(8):
        lane = tables[b]
        if not lane.any():
            continue
        idx = ((words >> np.uint64(8 * b)) & _U8_MASK).astype(np.intp)
        out = lane[idx] if out is None else out | lane[idx]
    if out is None:
        return np.zeros(len(words), dtype=np.uint64)
    return out


_LITTLE_ENDIAN = sys.byteorder == "little"


def unpack_slots(words: np.ndarray, slots: np.ndarray) -> np.ndarray:
    """Bool matrix [len(slots), len(words)] of the selected slot bits —
    one byte-unpack pass regardless of how many slots are asked for
    (big-endian hosts fall back to one shift pass per slot)."""
    if _LITTLE_ENDIAN:
        unpacked = np.unpackbits(
            words.view(np.uint8).reshape(-1, 8), axis=1, bitorder="little"
        )  # [rows, 64], column j = bit j of the uint64 word
        return unpacked.T[slots] != 0
    out = np.empty((len(slots), len(words)), dtype=bool)
    for i, s in enumerate(slots):
        out[i] = (words >> np.uint64(s)) & np.uint64(1) != 0
    return out


def slot_popcounts(words: np.ndarray) -> np.ndarray:
    """Set-bit count per slot over a packed word column, in one
    member-count-independent pass (byte histograms × bit matrix)."""
    out = np.zeros(MAX_SLOTS, dtype=np.int64)
    for b in range(8):
        vals = ((words >> np.uint64(8 * b)) & _U8_MASK).astype(np.intp)
        hist = np.bincount(vals, minlength=256)
        out[8 * b : 8 * b + 8] = hist @ _BYTE_BITS
    return out


class SlotAllocator:
    """query id -> bit slot, with recycling. Capacity 64 concurrent queries
    per state; the engine serializes admission beyond that (never reached in
    the evaluated workloads — 32 clients max)."""

    def __init__(self):
        self._slot_of: Dict[int, int] = {}
        self._free: List[int] = list(range(MAX_SLOTS - 1, -1, -1))

    def get(self, qid: int) -> int:
        s = self.try_get(qid)
        if s is None:
            raise RuntimeError("visibility slots exhausted (>64 concurrent queries on one state)")
        return s

    def try_get(self, qid: int) -> Optional[int]:
        """Slot if one is available, else None — the packed-word overflow
        signal: the caller must route the owner through a slow lane that
        never drops rows (runtime.py overflow members, §11)."""
        if qid in self._slot_of:
            return self._slot_of[qid]
        if not self._free:
            return None
        s = self._free.pop()
        self._slot_of[qid] = s
        return s

    def peek(self, qid: int):
        return self._slot_of.get(qid)

    def release(self, qid: int) -> None:
        s = self._slot_of.pop(qid, None)
        if s is not None:
            self._free.append(s)

    def mask(self, qid: int) -> np.uint64:
        return np.uint64(1) << np.uint64(self.get(qid))

    def attached(self) -> List[int]:
        return list(self._slot_of)


def split_words(words: np.ndarray):
    """Split packed uint64 words into (lo, hi) uint32 halves.

    The device data plane (DESIGN.md §13) carries every 64-bit lens /
    ownership / provenance word as two uint32 lanes — TPU-native width, no
    64-bit integer support required in-kernel — so the full 64-slot
    ``SlotAllocator`` space fits the kernel path."""
    w = np.asarray(words, dtype=np.uint64)
    lo = (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (w >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def join_words(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Inverse of :func:`split_words`."""
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)


def bit_of(mask: np.ndarray, slot: int) -> np.ndarray:
    """Extract one query's visibility bit from a packed mask array."""
    return (mask >> np.uint64(slot)) & np.uint64(1) != 0


def or_bit(mask: np.ndarray, rows: np.ndarray, slot: int) -> None:
    """Set one query's bit on the selected rows, in place."""
    np.bitwise_or.at(mask, rows, np.uint64(1) << np.uint64(slot))
