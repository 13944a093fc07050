"""Hash-join probe with a fused per-query state lens (paper §4.3).

Probe a shared open-addressing hash-build state and emit, per probe key,
the matching table slot — only when the entry is visible to the probing
query (visibility word AND query mask), i.e. the state lens is fused into
the probe. The three entry points port the reference's Pallas kernels
(``src/repro/kernels/hash_probe.py``) to hand-written CUDA
(``csrc/hash_probe.cu``; the note at its top says what bounds them on the
H100 and what the design does about it):

* ``hash_probe_lens``         — slot-indexed 32-bit lens (``_probe_kernel``);
* ``hash_probe_lens64``       — entry-indexed 64-bit lens
  (``_probe_lens64_kernel``);
* ``hash_probe_lens_multi64`` — pre-visibility slot plus the matched
  entry's 64-bit word (``_probe_multi64_kernel``).

Every uint32 word (visibility halves, query masks) travels as an int32
tensor holding the same bits: torch has no full uint32 arithmetic, and
AND / OR / equality are bit-identical either way. A wrapper runs its CUDA
kernel for CUDA tensors and its plain PyTorch version (``*_plain``) for
CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import torch

from . import _build

MAX_PROBE = 16
EMPTY = -0x7FFFFFFF
MULT = 2654435761

_LO32 = 0xFFFFFFFF


def _hash(keys: torch.Tensor, cap: int) -> torch.Tensor:
    """``uint32(key) * MULT`` wrapped to 32 bits, ``& (cap - 1)``.

    The int64 product of a masked key can pass 2^63; torch's int64
    multiply wraps, and the low 32 bits — all the mask keeps — are exact
    under wraparound."""
    return ((keys.to(torch.int64) & _LO32) * MULT) & (cap - 1)


def _check(name, device, *tensors):
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: every operand must be on {device}, got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: operands are int32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _check_cap(name, cap):
    if cap < 1 or cap & (cap - 1):
        raise ValueError(f"{name}: table capacity must be a power of two, got {cap}")


# -- B4: slot-indexed 32-bit lens --------------------------------------------
def hash_probe_lens_plain(probe_keys, table_keys, table_vis, query_mask):
    keys = probe_keys.to(torch.int64)
    cap = table_keys.shape[0]
    pos = _hash(probe_keys, cap)
    found = torch.full(keys.shape, -1, dtype=torch.int64, device=keys.device)
    done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    qmask = query_mask[0]
    for _ in range(MAX_PROBE):
        slot_keys = table_keys[pos]
        hit = (slot_keys == keys) & ~done
        empty = (slot_keys == EMPTY) & ~done
        vis = (table_vis[pos] & qmask) != 0
        found = torch.where(hit & vis, pos, found)
        done = done | hit | empty
        pos = (pos + 1) & (cap - 1)
    return found.to(torch.int32)


def hash_probe_lens(probe_keys, table_keys, table_vis, query_mask):
    """Per probe key the matched slot if ``table_vis[slot] & query_mask[0]``
    is non-zero, else -1. A key hit ends the search even when it is not
    visible. ``probe_keys``/``table_keys`` int32 ``[N]``/``[T]`` (T a power
    of two, EMPTY sentinel), ``table_vis`` ``[T]`` and ``query_mask``
    ``[1]`` uint32 bits as int32. Returns int32 ``[N]``."""
    name = "hash_probe_lens"
    _check(name, probe_keys.device, probe_keys, table_keys, table_vis, query_mask)
    _check_cap(name, table_keys.shape[0])
    if probe_keys.device.type == "cpu":
        return hash_probe_lens_plain(probe_keys, table_keys, table_vis, query_mask)
    out = torch.empty_like(probe_keys)
    fn = _build.bind("hash_probe", "hp_probe_lens", 5, 2, 1)
    err = fn(
        probe_keys.data_ptr(), table_keys.data_ptr(), table_vis.data_ptr(),
        query_mask.data_ptr(), out.data_ptr(),
        probe_keys.shape[0], table_keys.shape[0], _build.stream_ptr(probe_keys.device),
    )
    _build.check(err, name)
    _build.count_launch(name)
    return out


# -- B2: entry-indexed 64-bit lens, one query ----------------------------------
def hash_probe_lens64_plain(probe_keys, table_keys, table_entry, evis_lo, evis_hi, query_mask):
    keys = probe_keys.to(torch.int64)
    cap = table_keys.shape[0]
    pos = _hash(probe_keys, cap)
    found = torch.full(keys.shape, -1, dtype=torch.int64, device=keys.device)
    done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    qlo, qhi = query_mask[0], query_mask[1]
    for _ in range(MAX_PROBE):
        slot_keys = table_keys[pos]
        hit = (slot_keys == keys) & ~done
        empty = (slot_keys == EMPTY) & ~done
        entry = torch.where(hit, table_entry[pos], 0).to(torch.int64)
        vis = ((evis_lo[entry] & qlo) | (evis_hi[entry] & qhi)) != 0
        found = torch.where(hit & vis, pos, found)
        done = done | hit | empty
        pos = (pos + 1) & (cap - 1)
    return found.to(torch.int32)


def hash_probe_lens64(probe_keys, table_keys, table_entry, evis_lo, evis_hi, query_mask):
    """Single-query fused-lens probe over the full 64-slot space: the
    visibility words are entry-indexed (lo, hi) halves, so any slot 0..63
    resolves in-kernel and table rebuilds leave the mirrors untouched.
    ``query_mask`` is the (lo, hi) lens mask, int32 ``[2]``. Returns the
    matched slot per key (-1 = no visible match), int32 ``[N]``."""
    name = "hash_probe_lens64"
    _check(name, probe_keys.device, probe_keys, table_keys, table_entry,
           evis_lo, evis_hi, query_mask)
    _check_cap(name, table_keys.shape[0])
    if probe_keys.device.type == "cpu":
        return hash_probe_lens64_plain(
            probe_keys, table_keys, table_entry, evis_lo, evis_hi, query_mask
        )
    out = torch.empty_like(probe_keys)
    fn = _build.bind("hash_probe", "hp_probe_lens64", 7, 3, 1)
    err = fn(
        probe_keys.data_ptr(), table_keys.data_ptr(), table_entry.data_ptr(),
        evis_lo.data_ptr(), evis_hi.data_ptr(), query_mask.data_ptr(), out.data_ptr(),
        probe_keys.shape[0], table_keys.shape[0], evis_lo.shape[0],
        _build.stream_ptr(probe_keys.device),
    )
    _build.check(err, name)
    _build.count_launch(name)
    return out


# -- B3: pre-visibility slot + the matched entry's 64-bit word -----------------
def hash_probe_lens_multi64_plain(probe_keys, table_keys, table_entry, evis_lo, evis_hi):
    keys = probe_keys.to(torch.int64)
    cap = table_keys.shape[0]
    pos = _hash(probe_keys, cap)
    found = torch.full(keys.shape, -1, dtype=torch.int64, device=keys.device)
    done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    for _ in range(MAX_PROBE):
        slot_keys = table_keys[pos]
        hit = (slot_keys == keys) & ~done
        empty = (slot_keys == EMPTY) & ~done
        found = torch.where(hit, pos, found)
        done = done | hit | empty
        pos = (pos + 1) & (cap - 1)
    matched = found >= 0
    entry = torch.where(matched, table_entry[torch.where(matched, found, 0)], 0)
    entry = entry.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int32, device=keys.device)
    wlo = torch.where(matched, evis_lo[entry], zero)
    whi = torch.where(matched, evis_hi[entry], zero)
    return found.to(torch.int32), wlo, whi


def hash_probe_lens_multi64(probe_keys, table_keys, table_entry, evis_lo, evis_hi):
    """Multi-member probe: per key the matched slot (-1 = no match,
    pre-visibility — the pair stream equals a plain probe's) and the
    matched entry's full 64-bit lens word as (lo, hi) halves (zero on a
    miss). One launch serves every probing member; the host translates the
    word to pipeline ownership bits."""
    name = "hash_probe_lens_multi64"
    _check(name, probe_keys.device, probe_keys, table_keys, table_entry, evis_lo, evis_hi)
    _check_cap(name, table_keys.shape[0])
    if probe_keys.device.type == "cpu":
        return hash_probe_lens_multi64_plain(
            probe_keys, table_keys, table_entry, evis_lo, evis_hi
        )
    found = torch.empty_like(probe_keys)
    wlo = torch.empty_like(probe_keys)
    whi = torch.empty_like(probe_keys)
    fn = _build.bind("hash_probe", "hp_probe_multi64", 8, 3, 1)
    err = fn(
        probe_keys.data_ptr(), table_keys.data_ptr(), table_entry.data_ptr(),
        evis_lo.data_ptr(), evis_hi.data_ptr(), found.data_ptr(), wlo.data_ptr(),
        whi.data_ptr(), probe_keys.shape[0], table_keys.shape[0], evis_lo.shape[0],
        _build.stream_ptr(probe_keys.device),
    )
    _build.check(err, name)
    _build.count_launch(name)
    return found, wlo, whi
