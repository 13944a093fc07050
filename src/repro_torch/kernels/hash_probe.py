"""Hash-join probe with a fused per-query state lens (paper §4.3), and the
batch insert that builds the probed table.

Probe a shared open-addressing hash-build state and emit, per probe key,
the matching table slot — only when the entry is visible to the probing
query (visibility word AND query mask), i.e. the state lens is fused into
the probe. The three entry points port the reference's Pallas kernels
(``src/repro/kernels/hash_probe.py``) to hand-written CUDA
(``csrc/hash_probe.cu``; the note at its top says what bounds them on the
H100 and what the design does about it):

* ``hash_probe_lens``         — slot-indexed 32-bit lens (``_probe_kernel``);
* ``hash_probe_lens_multi``   — pre-visibility slot plus the slot's 32-bit
  word (``_probe_multi_kernel``);
* ``hash_probe_lens64``       — entry-indexed 64-bit lens
  (``_probe_lens64_kernel``);
* ``hash_probe_lens_multi64`` — pre-visibility slot plus the matched
  entry's 64-bit word (``_probe_multi64_kernel``);
* ``hash_build_insert``       — a fresh table built from a key batch in
  batch order (``_insert_kernel``).

Every uint32 word (visibility halves, query masks) travels as an int32
tensor holding the same bits: torch has no full uint32 arithmetic, and
AND / OR / equality are bit-identical either way. The query masks of
``hash_probe_lens`` and ``hash_probe_lens64`` are held on the host and go
to the kernel by value; ``hash_probe_lens_multi64`` returns its three
outputs as the rows of one ``[3, N]`` tensor, ``hash_probe_lens_multi`` its
two as the rows of one ``[2, N]`` tensor. A wrapper runs its CUDA
kernel for CUDA tensors and its plain PyTorch version (``*_plain``) for
CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

MAX_PROBE = 16
EMPTY = -0x7FFFFFFF
MULT = 2654435761
MULT_INV = pow(MULT, -1, 1 << 32)

_LO32 = 0xFFFFFFFF


def _hash(keys: torch.Tensor, cap: int) -> torch.Tensor:
    """``uint32(key) * MULT`` wrapped to 32 bits, ``& (cap - 1)``.

    The int64 product of a masked key can pass 2^63; torch's int64
    multiply wraps, and the low 32 bits — all the mask keeps — are exact
    under wraparound."""
    return ((keys.to(torch.int64) & _LO32) * MULT) & (cap - 1)


def keys_at(homes, cap, start=0):
    """int32 keys whose home slots in a table of ``cap`` slots are ``homes``
    (numpy), for building tables with chosen clusters: MULT is odd, so x =
    home + cap r times its inverse modulo 2^32 hashes to home. r runs on
    from ``start``, so the keys of one home are distinct."""
    span = (1 << 32) // cap
    r = ((int(start) + np.arange(len(homes))) % span).astype(np.uint64)
    x = (np.asarray(homes, np.uint64) + np.uint64(cap) * r) & np.uint64(_LO32)
    return ((x * np.uint64(MULT_INV)) & np.uint64(_LO32)).astype(np.uint32).view(np.int32)


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
def mask_word(query_mask):
    """A 32-bit lens mask held on the host — a CPU int32 ``[1]`` tensor or
    an integer — as an unsigned 32-bit Python int (the 32-bit counterpart
    of :func:`mask_words`). A mask on the card is refused: reading it would
    wait for the card."""
    if isinstance(query_mask, torch.Tensor):
        if query_mask.device.type != "cpu" or query_mask.dtype != torch.int32 \
                or tuple(query_mask.shape) != (1,):
            raise TypeError("query_mask is a CPU int32 [1] tensor or an int, got "
                            f"{query_mask.dtype} {tuple(query_mask.shape)} on {query_mask.device}")
        query_mask = query_mask.item()
    elif not isinstance(query_mask, (int, np.integer)):
        raise TypeError(f"query_mask is a CPU int32 [1] tensor or an int, got {type(query_mask)}")
    return int(query_mask) & _LO32


def hash_probe_lens_plain(probe_keys, table_keys, table_vis, query_mask):
    keys = probe_keys.to(torch.int64)
    cap = table_keys.shape[0]
    pos = _hash(probe_keys, cap)
    found = torch.full(keys.shape, -1, dtype=torch.int64, device=keys.device)
    done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    qmask = _signed(mask_word(query_mask))
    for _ in range(MAX_PROBE):
        slot_keys = table_keys[pos]
        hit = (slot_keys == keys) & ~done
        empty = (slot_keys == EMPTY) & ~done
        vis = (table_vis[pos] & qmask) != 0
        found = torch.where(hit & vis, pos, found)
        done = done | hit | empty
        pos = (pos + 1) & (cap - 1)
    return found.to(torch.int32)


@functools.cache
def _hp_probe_lens():
    return _build.bind("hash_probe", "hp_probe_lens", 4, 3, 1)


def hash_probe_lens(probe_keys, table_keys, table_vis, query_mask):
    """Per probe key the matched slot if ``table_vis[slot] & query_mask``
    is non-zero, else -1. A key hit ends the search even when it is not
    visible. ``probe_keys``/``table_keys`` int32 ``[N]``/``[T]`` (T a power
    of two, EMPTY sentinel) and ``table_vis`` ``[T]`` uint32 bits as int32;
    ``query_mask`` is the 32-bit lens mask held on the host
    (:func:`mask_word`), which the kernel takes by value. Returns int32
    ``[N]``."""
    name = "hash_probe_lens"
    qmask = mask_word(query_mask)
    _check(name, probe_keys.device, probe_keys, table_keys, table_vis)
    _check_cap(name, table_keys.shape[0])
    if probe_keys.device.type == "cpu":
        return hash_probe_lens_plain(probe_keys, table_keys, table_vis, qmask)
    out = torch.empty_like(probe_keys)
    err = _hp_probe_lens()(
        probe_keys.data_ptr(), table_keys.data_ptr(), table_vis.data_ptr(), out.data_ptr(),
        probe_keys.shape[0], table_keys.shape[0], qmask, _build.stream_ptr(probe_keys.device),
    )
    _build.check(err, name)
    _build.count_launch(name)
    return out


# -- B5: pre-visibility slot + the slot's 32-bit word -------------------------
def hash_probe_lens_multi_plain(probe_keys, table_keys, table_vis):
    """The kernel's function, into the same rows of one ``[2, N]`` tensor."""
    keys = probe_keys.to(torch.int64)
    cap = table_keys.shape[0]
    pos = _hash(probe_keys, cap)
    found = torch.full(keys.shape, -1, dtype=torch.int64, device=keys.device)
    vis = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    for _ in range(MAX_PROBE):
        slot_keys = table_keys[pos]
        hit = (slot_keys == keys) & ~done
        empty = (slot_keys == EMPTY) & ~done
        found = torch.where(hit, pos, found)
        vis = torch.where(hit, table_vis[pos], vis)
        done = done | hit | empty
        pos = (pos + 1) & (cap - 1)
    out = torch.empty((2, keys.shape[0]), dtype=torch.int32, device=keys.device)
    out[0] = found
    out[1] = vis
    return out.unbind(0)


@functools.cache
def _hp_probe_multi():
    return _build.bind("hash_probe", "hp_probe_multi", 4, 2, 1)


def hash_probe_lens_multi(probe_keys, table_keys, table_vis):
    """Multi-member probe over slot-indexed 32-bit words: per key the
    matched slot (-1 = no match, pre-visibility) and that slot's packed
    visibility word (zero on a miss). ``table_vis`` ``[T]`` holds uint32
    bits as int32. The two come back as the rows of one int32 ``[2, N]``
    tensor (``found._base``), on either device."""
    name = "hash_probe_lens_multi"
    _check(name, probe_keys.device, probe_keys, table_keys, table_vis)
    _check_cap(name, table_keys.shape[0])
    if probe_keys.device.type == "cpu":
        return hash_probe_lens_multi_plain(probe_keys, table_keys, table_vis)
    out = torch.empty((2, probe_keys.shape[0]), dtype=torch.int32, device=probe_keys.device)
    err = _hp_probe_multi()(
        probe_keys.data_ptr(), table_keys.data_ptr(), table_vis.data_ptr(), out.data_ptr(),
        probe_keys.shape[0], table_keys.shape[0], _build.stream_ptr(probe_keys.device),
    )
    _build.check(err, name)
    _build.count_launch(name)
    return out.unbind(0)


# -- B2: entry-indexed 64-bit lens, one query ----------------------------------
def mask_words(query_mask):
    """The (lo, hi) halves of a 64-bit lens mask held on the host — a CPU
    int32 ``[2]`` tensor or a ``(lo, hi)`` pair of integers — as unsigned
    32-bit Python ints. A mask on the card is refused: reading it would
    wait for the card."""
    if isinstance(query_mask, torch.Tensor):
        if query_mask.device.type != "cpu" or query_mask.dtype != torch.int32 \
                or tuple(query_mask.shape) != (2,):
            raise TypeError("query_mask is a CPU int32 [2] tensor or a (lo, hi) pair, got "
                            f"{query_mask.dtype} {tuple(query_mask.shape)} on {query_mask.device}")
        query_mask = query_mask.tolist()
    lo, hi = query_mask
    return int(lo) & _LO32, int(hi) & _LO32


def _signed(word):
    """An unsigned 32-bit value as the int32 with the same bits."""
    return word - (1 << 32) if word >= 1 << 31 else word


def hash_probe_lens64_plain(probe_keys, table_keys, table_entry, evis_lo, evis_hi, query_mask):
    keys = probe_keys.to(torch.int64)
    cap = table_keys.shape[0]
    pos = _hash(probe_keys, cap)
    found = torch.full(keys.shape, -1, dtype=torch.int64, device=keys.device)
    done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    qlo, qhi = (_signed(w) for w in mask_words(query_mask))
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


@functools.cache
def _hp_probe_lens64():
    return _build.bind("hash_probe", "hp_probe_lens64", 6, 5, 1)


def hash_probe_lens64(probe_keys, table_keys, table_entry, evis_lo, evis_hi, query_mask):
    """Single-query fused-lens probe over the full 64-slot space: the
    visibility words are entry-indexed (lo, hi) halves, so any slot 0..63
    resolves in-kernel and table rebuilds leave the mirrors untouched.
    ``query_mask`` is the (lo, hi) lens mask held on the host
    (:func:`mask_words`); the kernel takes it by value. Returns the
    matched slot per key (-1 = no visible match), int32 ``[N]``."""
    name = "hash_probe_lens64"
    qlo, qhi = mask_words(query_mask)
    _check(name, probe_keys.device, probe_keys, table_keys, table_entry, evis_lo, evis_hi)
    _check_cap(name, table_keys.shape[0])
    if probe_keys.device.type == "cpu":
        return hash_probe_lens64_plain(
            probe_keys, table_keys, table_entry, evis_lo, evis_hi, (qlo, qhi)
        )
    out = torch.empty_like(probe_keys)
    err = _hp_probe_lens64()(
        probe_keys.data_ptr(), table_keys.data_ptr(), table_entry.data_ptr(),
        evis_lo.data_ptr(), evis_hi.data_ptr(), out.data_ptr(),
        probe_keys.shape[0], table_keys.shape[0], evis_lo.shape[0], qlo, qhi,
        _build.stream_ptr(probe_keys.device),
    )
    _build.check(err, name)
    _build.count_launch(name)
    return out


# -- B3: pre-visibility slot + the matched entry's 64-bit word -----------------
def hash_probe_lens_multi64_plain(probe_keys, table_keys, table_entry, evis_lo, evis_hi):
    """The kernel's function, into the same rows of one ``[3, N]`` tensor."""
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
    out = torch.empty((3, keys.shape[0]), dtype=torch.int32, device=keys.device)
    out[0] = found
    out[1] = torch.where(matched, evis_lo[entry], 0)
    out[2] = torch.where(matched, evis_hi[entry], 0)
    return out.unbind(0)


@functools.cache
def _hp_probe_multi64():
    return _build.bind("hash_probe", "hp_probe_multi64", 6, 3, 1)


def hash_probe_lens_multi64(probe_keys, table_keys, table_entry, evis_lo, evis_hi):
    """Multi-member probe: per key the matched slot (-1 = no match,
    pre-visibility — the pair stream equals a plain probe's) and the
    matched entry's full 64-bit lens word as (lo, hi) halves (zero on a
    miss). One launch serves every probing member; the host translates the
    word to pipeline ownership bits. The three come back as the rows of
    one int32 ``[3, N]`` tensor (``found._base``), on either device, so a
    caller brings them to the host with one copy."""
    name = "hash_probe_lens_multi64"
    _check(name, probe_keys.device, probe_keys, table_keys, table_entry, evis_lo, evis_hi)
    _check_cap(name, table_keys.shape[0])
    if probe_keys.device.type == "cpu":
        return hash_probe_lens_multi64_plain(
            probe_keys, table_keys, table_entry, evis_lo, evis_hi
        )
    out = torch.empty((3, probe_keys.shape[0]), dtype=torch.int32, device=probe_keys.device)
    err = _hp_probe_multi64()(
        probe_keys.data_ptr(), table_keys.data_ptr(), table_entry.data_ptr(),
        evis_lo.data_ptr(), evis_hi.data_ptr(), out.data_ptr(), probe_keys.shape[0],
        table_keys.shape[0], evis_lo.shape[0], _build.stream_ptr(probe_keys.device),
    )
    _build.check(err, name)
    _build.count_launch(name)
    return out.unbind(0)


# -- B6: batch insert into a fresh table ---------------------------------------
def hash_build_insert_plain(keys, capacity):
    """The reference's sequential insert, key by key in batch order, on
    host integers (a loop of small tensor ops would cost microseconds per
    key). Unlike the kernel it goes on past a failure, as the reference
    does, so its tables equal the reference's also where ``ok`` is 0. A
    key equal to EMPTY, which the reference's contract excludes, clears
    ``ok``: its slot could not be told from an empty one."""
    mask = capacity - 1
    tk = [EMPTY] * capacity
    te = [-1] * capacity
    ok = 1
    for i, key in enumerate(keys.tolist()):
        if key == EMPTY:
            ok = 0
        home = ((key & _LO32) * MULT) & mask
        for h in range(MAX_PROBE):
            slot = (home + h) & mask
            cur = tk[slot]
            if cur == EMPTY:
                tk[slot] = key
                te[slot] = i
                break
            if cur == key:
                ok = 0
                break
        else:
            ok = 0
    dev = keys.device
    return (
        torch.tensor(tk, dtype=torch.int32, device=dev),
        torch.tensor(te, dtype=torch.int32, device=dev),
        torch.tensor([ok], dtype=torch.int32, device=dev),
    )


def hash_build_insert(keys, capacity):
    """Build a fresh open-addressing table from ``keys`` (int32 ``[N]``, no
    EMPTY values) with ``capacity`` slots (a power of two, >= 2N), placing
    key i at the first EMPTY slot of its probe window in batch order.
    Returns ``(table_keys, table_entry, ok)``: int32 ``[capacity]`` keys and
    slot -> batch index, and int32 ``[1]`` ``ok``, 0 when a duplicate key,
    an EMPTY key or a window with no EMPTY slot makes the table unservable.
    The CUDA kernel sweeps the slots in parallel and builds the sequential
    table exactly (the note in ``csrc/hash_probe.cu`` has the proof); it
    stops a segment at its first failure, so where ``ok`` is 0 its table is
    not the plain version's, and callers discard such a table."""
    name = "hash_build_insert"
    _check(name, keys.device, keys)
    _check_cap(name, capacity)
    if keys.device.type == "cpu":
        return hash_build_insert_plain(keys, capacity)
    n = keys.shape[0]
    tkeys = torch.empty(capacity, dtype=torch.int32, device=keys.device)
    tentry = torch.empty(capacity, dtype=torch.int32, device=keys.device)
    ok = torch.empty(1, dtype=torch.int32, device=keys.device)
    words = _build.bind("hash_probe", "hp_build_insert_scratch", 0, 2, restype="longlong")
    scratch = torch.empty(words(n, capacity), dtype=torch.int32, device=keys.device)
    fn = _build.bind("hash_probe", "hp_build_insert", 5, 2, 1)
    err = fn(
        keys.data_ptr(), tkeys.data_ptr(), tentry.data_ptr(), ok.data_ptr(),
        scratch.data_ptr(), n, capacity, _build.stream_ptr(keys.device),
    )
    _build.check(err, name)
    _build.count_launch(name)
    return tkeys, tentry, ok
