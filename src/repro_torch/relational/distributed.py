"""Distributed relational data plane over a data mesh (DESIGN.md §4, §14).

Base tables are row-partitioned over the mesh's 'data' axis; equi-joins
repartition both sides by join-key hash with a fixed-capacity bucketed
exchange (dense ``[P, C, W]`` buffers, no ragged communication);
aggregations sum shard-local one-hot segment sums over the shards. The
control plane (grafting admission) stays replicated and deterministic;
only the data plane moves rows.

This is the port of the reference's ``relational/distributed.py``, whose
operators are ``jnp`` code inside ``shard_map`` (none is a Pallas kernel),
so here they are plain torch operations on each shard's device
(``launch.mesh``): shard p's rows live on ``shard_devices(mesh)[p]``, and
the all_to_all is a transpose of the stacked buckets, ``[P_src, P_dst, C,
·]`` -> ``[P_dst, P_src, C, ·]``, each block moved with ``.to(device)``
when two shards are on different cards. The output layout is the
reference's: shard q's receive buffer is ``[P_src, C]``, and a global
output is the shards' buffers in shard order, ``[P·P·C]``. Global inputs
split into contiguous shards, as ``shard_map`` splits them, and global
outputs come back on the first shard's device.

Where the port differs from the reference, deliberately:

* **Exact fill.** The reference scatters every row it does not keep,
  padding rows included, into the in-bounds cell ``(0, C - 1)``, so when
  bucket 0 fills exactly to capacity and the shard also holds a ``FILL``
  row, the last kept row is overwritten and lost with overflow 0. The port
  writes only kept rows (the others go to a scratch cell past the buffer's
  end), so no valid row is ever lost without being counted.
* **Slots without a one-hot cumsum.** A row's slot in its bucket is its
  position in the stably sorted order less the bucket's start, found by
  ``searchsorted`` on the sorted destinations: the reference's positions,
  in O(rows) memory instead of O(rows · P).
* **Key width.** Keys are int64 on the device (the reference truncates
  them to int32 with x64 off); the same ``KEY_LIMIT`` check raises above
  2**31 - 2, so both hold the same keys.

Bucket overflow is never silent: each exchange reports the number of
valid rows that did not fit, and ``exchange_by_key`` grows capacity (or
raises) instead of dropping.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..launch.mesh import shard_devices

FILL = -1

# The reference's exchange carries keys as int32 (jax x64 disabled); the
# port keeps its contract so both hold the same keys (and the fused chain's
# PallasBackend._KEY_LIMIT).
KEY_LIMIT = 2**31 - 2

_HASH_MULT = 2654435761


class BucketOverflowError(RuntimeError):
    """A bucketed exchange would have dropped rows (capacity too small)."""


def _hash_dest(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``(uint32(key) * 2654435761 mod 2**32) >> 8 mod n`` — the
    reference's default routing — in int64 without overflow: the product
    is taken in two 16-bit halves of the multiplier."""
    x = keys.to(torch.int64) & 0xFFFFFFFF
    lo = x * (_HASH_MULT & 0xFFFF)
    hi = ((x * (_HASH_MULT >> 16)) & 0xFFFF) << 16
    return (((lo + hi) & 0xFFFFFFFF) >> 8) % n


def _bucket(keys, values, n, capacity, dest):
    """One shard's send buffers: keys ``[n, C]`` (FILL where empty),
    values ``[n, C, W]``, and the count of valid rows that did not fit."""
    dev = keys.device
    valid = keys != FILL
    if dest is None:
        dest = _hash_dest(keys, n)
    dest = torch.where(valid, dest.to(torch.int64), n)  # invalid -> discard
    dest_s, order = torch.sort(dest, stable=True)
    start = torch.searchsorted(dest_s, torch.arange(n + 1, device=dev))
    slot = torch.arange(len(dest_s), device=dev) - start[dest_s]
    routed = dest_s < n
    keep = (slot < capacity) & routed
    n_overflow = (routed & ~keep).sum()
    # kept rows own their cells; every other row lands in the scratch cell
    # past the end, which is cut off
    cell = torch.where(keep, dest_s * capacity + slot, n * capacity)
    width = values.shape[1]
    buf_k = torch.full((n * capacity + 1,), FILL, dtype=torch.int64, device=dev)
    buf_v = torch.zeros((n * capacity + 1, width), dtype=values.dtype, device=dev)
    buf_k[cell] = keys[order]
    buf_v[cell] = values[order]
    return (buf_k[:-1].view(n, capacity), buf_v[:-1].view(n, capacity, width), n_overflow)


def repartition_by_key(
    keys: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    capacity: int,
    dest: Optional[Sequence[torch.Tensor]] = None,
):
    """Route each shard's rows to shard ``hash(key) % P`` through dense
    ``[P, C]`` buckets and their exchange. ``keys[p]`` (int64, FILL =
    invalid/padding), ``values[p]`` (``[rows_p, W]``) and ``dest[p]`` lie
    on shard p's device. Returns per-shard lists ``(keys', values',
    valid', n_overflow)``: shard q's ``keys'`` is its ``[P_src, C]``
    receive buffer flattened to ``[P·C]``.

    ``dest`` overrides the destination shard per row (e.g. the engine's
    splitmix64 ``key_partition``) so exchange placement matches the state
    shards' ownership; invalid (FILL) rows are never sent. A destination
    bucket past capacity loses no row silently: ``n_overflow[p]`` counts
    every valid row shard p failed to place."""
    n = len(keys)
    sent = [
        _bucket(keys[p], values[p], n, capacity, None if dest is None else dest[p])
        for p in range(n)
    ]
    k_out, v_out, ok_out = [], [], []
    for q in range(n):
        dev = keys[q].device
        k = torch.stack([sent[p][0][q].to(dev) for p in range(n)]).reshape(-1)
        v = torch.stack([sent[p][1][q].to(dev) for p in range(n)])
        k_out.append(k)
        v_out.append(v.reshape(-1, v.shape[-1]))
        ok_out.append(k != FILL)
    return k_out, v_out, ok_out, [s[2] for s in sent]


def _local_join(bk, bv, pk, pv):
    """Sort-probe join of local partitions (unique build keys)."""
    order = torch.sort(bk, stable=True).indices
    sbk = bk[order]
    idx = torch.searchsorted(sbk, pk).clamp(0, sbk.shape[0] - 1)
    hit = (sbk[idx] == pk) & (pk != FILL)
    out_v = torch.cat([pv, bv[order[idx]]], dim=-1)
    return torch.where(hit[:, None], out_v, 0.0), hit


def _split(x, devs: List[torch.device], dtype: torch.dtype) -> List[torch.Tensor]:
    """A global array as ``len(devs)`` contiguous shards, shard p on
    ``devs[p]``; the row count must divide evenly (as ``shard_map``
    requires: pad with ``pad_partition`` / ``pad_groups``)."""
    x = torch.as_tensor(x).to(dtype)
    d = len(devs)
    if x.shape[0] % d:
        raise ValueError(
            f"{x.shape[0]} rows do not split evenly over {d} shards; pad them first"
        )
    per = x.shape[0] // d
    return [x[p * per : (p + 1) * per].to(dev) for p, dev in enumerate(devs)]


def _gather(parts: List[torch.Tensor]) -> torch.Tensor:
    """Shard outputs in shard order, on the first shard's device."""
    dev = parts[0].device
    return torch.cat([x.to(dev) for x in parts])


def _total(parts: List[torch.Tensor]) -> torch.Tensor:
    """Sum of per-shard values on the first shard's device (the
    reference's ``psum``), shard 0 first."""
    dev = parts[0].device
    out = parts[0]
    for x in parts[1:]:
        out = out + x.to(dev)
    return out


def exchange_bytes(n_shards: int, capacity: int, width: int) -> int:
    """Bytes one shard's send buffers hold and the exchange moves: ``P·C``
    int64 keys and ``P·C·W`` float32 values (a row resident on its
    destination still transits the dense buffer)."""
    return n_shards * capacity * (8 + 4 * width)


def make_partitioned_join(mesh, build_width: int, probe_width: int, capacity: int):
    """Distributed hash join over row-partitioned inputs.

    build_keys/probe_keys: ``[R]`` int64 (FILL pads), split over the
    mesh's data shards; build_vals/probe_vals: ``[R, W]``. Returns
    ``join(bk, bv, pk, pv) -> (out, hit, out_keys, overflow)``: joined
    rows ``[P·P·C, W_p + W_b]``, the hit mask and the probe keys,
    partitioned by key hash, and the total count of rows that overflowed
    an exchange bucket (nonzero means the result is incomplete and
    capacity must grow)."""
    devs = shard_devices(mesh)

    def join(bk, bv, pk, pv):
        bk2, bv2, _, ob = repartition_by_key(
            _split(bk, devs, torch.int64), _split(bv, devs, torch.float32), capacity
        )
        pk2, pv2, _, op_ = repartition_by_key(
            _split(pk, devs, torch.int64), _split(pv, devs, torch.float32), capacity
        )
        joined = [_local_join(bk2[p], bv2[p], pk2[p], pv2[p]) for p in range(len(devs))]
        overflow = _total([ob[p] + op_[p] for p in range(len(devs))])
        return (_gather([j[0] for j in joined]), _gather([j[1] for j in joined]),
                _gather(pk2), overflow)

    return join


def make_partitioned_exchange(mesh, width: int, capacity: int):
    """The bucketed exchange alone: rows in row-partition order -> rows in
    key-shard order, with per-row ``dest`` routing (split over the shards
    alongside the rows). Returns ``exchange(keys, vals, dest) -> (keys',
    vals', valid', overflow)``."""
    devs = shard_devices(mesh)

    def exchange(keys, vals, dest):
        k2, v2, ok, ov = repartition_by_key(
            _split(keys, devs, torch.int64),
            _split(vals, devs, torch.float32),
            capacity,
            dest=_split(dest, devs, torch.int64),
        )
        return _gather(k2), _gather(v2), _gather(ok), _total(ov)

    return exchange


def exchange_by_key(
    mesh,
    keys: np.ndarray,
    values: np.ndarray,
    *,
    capacity: Optional[int] = None,
    dest: Optional[np.ndarray] = None,
    on_overflow: str = "grow",
    max_doublings: int = 6,
) -> Dict:
    """Host-facing bucketed exchange: pad, run the repartition, and grow
    capacity (never drop) on bucket overflow.

    Returns a dict with ``keys``/``values``/``valid`` (tensors in
    key-shard order, ``[P·P·C']`` rows, on the first shard's device),
    ``capacity`` actually used, ``bucket_overflow_rows`` (total rows that
    overflowed across all attempts — every one was recovered by regrowing,
    none lost) and ``attempts``. ``on_overflow='raise'`` hard-fails with
    BucketOverflowError instead of growing."""
    keys = np.asarray(keys, np.int64)
    if keys.size and np.abs(keys).max() > KEY_LIMIT:
        raise ValueError(
            "the device exchange carries the reference's int32 keycodes; "
            f"|key| must be <= {KEY_LIMIT} — wider keys stay on the host plane"
        )
    if on_overflow not in ("grow", "raise"):
        raise ValueError(f"on_overflow must be 'grow' or 'raise', got {on_overflow!r}")
    n = int(mesh.shape["data"])
    values = np.asarray(values, np.float32)
    if values.ndim == 1:
        values = values[:, None]
    if dest is not None:
        dest = np.asarray(dest, np.int64)
        if dest.shape != keys.shape:
            raise ValueError(f"dest shape {dest.shape} != keys shape {keys.shape}")
        if dest.size and (dest.min() < 0 or dest.max() >= n):
            raise ValueError(f"dest out of range [0, {n}) for the data axis")
    k_pad, v_pad, d_pad = pad_partition(keys, values, n, dest=dest)
    if capacity is None:
        # expected per-destination load + slack; grown below if a skewed
        # key distribution still overflows
        capacity = max(8, 2 * math.ceil(max(1, len(keys)) / (n * n)))
    overflow_total = 0
    attempts = 0
    while True:
        attempts += 1
        fn = make_partitioned_exchange(mesh, values.shape[1], int(capacity))
        k2, v2, ok, ov = fn(k_pad, v_pad, d_pad)
        ov = int(ov)
        if ov == 0:
            return {
                "keys": k2,
                "values": v2,
                "valid": ok,
                "capacity": int(capacity),
                "n_shards": n,
                "bucket_overflow_rows": overflow_total,
                "attempts": attempts,
            }
        overflow_total += ov
        if on_overflow == "raise":
            raise BucketOverflowError(
                f"bucketed exchange overflowed {ov} row(s) at capacity {capacity} "
                f"over {n} shard(s); grow capacity or use on_overflow='grow'"
            )
        if attempts > max_doublings:
            raise BucketOverflowError(
                f"bucketed exchange still overflowing after {attempts} attempts "
                f"(capacity {capacity}, {ov} rows over) — key distribution too "
                "skewed for the dense exchange"
            )
        capacity = max(int(capacity) * 2, int(capacity) + ov)


def make_partitioned_aggregate(mesh, n_groups: int, width: int):
    """Distributed group-by sum: shard-local one-hot segment sums (a
    float32 product, as the reference's ``einsum``), summed over the
    shards. Returns ``aggregate(gids, vals) -> [n_groups, width]``.

    Sentinel rows (gid outside ``[0, n_groups)``, e.g. the -1 padding
    written by ``pad_groups``) are masked shard-locally and contribute
    nothing. The product runs in full float32: TF32 is switched off for
    the call (it would cost about three decimal digits)."""
    devs = shard_devices(mesh)

    def local(gids, vals):
        ok = (gids >= 0) & (gids < n_groups)
        groups = torch.arange(n_groups, device=gids.device)
        onehot = (gids[:, None] == groups[None, :]).to(vals.dtype)
        onehot = onehot * ok[:, None].to(vals.dtype)
        return torch.einsum("rg,rw->gw", onehot, vals)

    def aggregate(gids, vals):
        gs = _split(gids, devs, torch.int64)
        vs = _split(vals, devs, torch.float32)
        precision = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            return _total([local(g, v) for g, v in zip(gs, vs)])
        finally:
            torch.set_float32_matmul_precision(precision)

    return aggregate


# -- host-side helpers --------------------------------------------------------


def pad_partition(
    keys: np.ndarray,
    values: np.ndarray,
    n_shards: int,
    dest: Optional[np.ndarray] = None,
):
    """Pad host arrays so rows split evenly across the data axis.

    Padding rows carry the FILL sentinel in ``keys`` — the one invalid
    marker every shard-local consumer masks (the exchange discards them
    before sending, ``_local_join`` treats them as misses, the aggregate
    masks out-of-range gids), so the round trip is exact for any
    ``n_shards``. Returns CPU tensors ``(keys', values', dest')``; dest'
    pads with 0 (a FILL row is never sent) and, when ``dest`` is None,
    holds the default hash routing."""
    rows = len(keys)
    keys = np.asarray(keys, np.int64)
    if rows and np.abs(keys).max() > KEY_LIMIT:
        raise ValueError(
            f"the device exchange carries int32 keycodes; |key| must be <= {KEY_LIMIT}"
        )
    per = math.ceil(max(1, rows) / n_shards)
    total = per * n_shards
    k = np.full(total, FILL, np.int64)
    v = np.zeros((total, values.shape[1]), values.dtype)
    k[:rows] = keys
    v[:rows] = values
    d = np.zeros(total, np.int64)
    if dest is not None:
        d[:rows] = dest
    else:
        # the device-side default hash, so dest-less callers route the
        # same with or without padding
        d[:rows] = _hash_dest(torch.from_numpy(keys), n_shards).numpy()
    return torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(d)


def pad_groups(gids: np.ndarray, values: np.ndarray, n_shards: int):
    """Pad a group-by input so rows split evenly: padding rows carry gid
    -1, which ``make_partitioned_aggregate`` masks shard-locally. Returns
    CPU tensors."""
    rows = len(gids)
    per = math.ceil(max(1, rows) / n_shards)
    total = per * n_shards
    g = np.full(total, -1, np.int64)
    v = np.zeros((total, values.shape[1]), values.dtype)
    g[:rows] = gids
    v[:rows] = values
    return torch.from_numpy(g), torch.from_numpy(v)
