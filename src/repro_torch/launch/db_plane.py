"""GraftDB's distributed data plane as a validated record (DESIGN.md §14).

Runs the distributed data plane on a data mesh — the bucketed-exchange
hash join, the summed aggregate, and the shard-local fused stage chain —
and returns one record that ``validate_db_plane_record`` checks
structurally, with the reference's ``REQUIRED_FIELDS`` and
``HLO_STAT_FIELDS``.

The reference only lowers and compiles the join and the aggregate and
reads its per-device numbers from XLA's HLO. The port has no HLO, so it
runs both at ``rows`` on the mesh's devices, and fills the four
per-device fields of ``hlo_stats`` from the exchange's own accounting:

* ``coll_bytes_per_device`` — bytes the join's two exchanges move per
  device: the dense ``[P, C]`` send buffers of the build and probe side
  (0 on a one-shard mesh, where nothing moves);
* ``coll_count`` — the exchanges that moved blocks between shards (2 on
  a multi-shard mesh: build side and probe side; 0 on one shard);
* ``mem_bytes_per_device`` — bytes read and written per device: each
  side's input shard read, its send buffers written, its receive buffers
  read, and the joined rows, hit mask and keys written;
* ``flops_per_device`` — the local join's compare count as its
  operations: the build side's sort and each probe's binary search,
  ``2 n ⌈log2 n⌉ + n`` for the ``n = P·C`` rows a device receives.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch

REQUIRED_FIELDS = (
    "arch",
    "shape",
    "mesh",
    "data_shards",
    "rows",
    "status",
    "hlo_stats",
    "aggregate",
    "chain",
    "total_s",
)
HLO_STAT_FIELDS = (
    "flops_per_device",
    "mem_bytes_per_device",
    "coll_bytes_per_device",
    "coll_count",
)


def _mesh_label(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def _chain_parity(mesh, rows: int) -> Dict:
    """Run one minimal fused stage chain both unsharded and shard-locally
    on ``mesh`` (inputs on its first shard's device), and compare every
    output bit for bit (stats and slot counts are summed over the shards;
    row outputs gather in shard order, which is row order for
    row-partitioned inputs). ``shard_launches`` is the number of B1
    launches the sharded call made (0 where the plain version runs)."""
    from ..kernels import _build
    from ..kernels.fused_chain import chain_launch, split_outputs
    from ..kernels.hash_probe import EMPTY, MULT
    from .mesh import shard_devices

    d = int(mesh.shape["data"])
    rows = max(rows, d)
    rows = (rows // d) * d
    cap = 64
    ecap = 64
    rng = np.random.default_rng(7)
    n_entries = 40
    # open-addressed table: entry keys 1..n_entries at their probe slots
    keys_host = np.arange(1, n_entries + 1, dtype=np.int32)
    tkeys = np.full(cap, EMPTY, np.int32)
    tentry = np.zeros(cap, np.int32)
    for e, k in enumerate(keys_host):
        pos = (int(k) * MULT) & (cap - 1)
        while tkeys[pos] != EMPTY:
            pos = (pos + 1) & (cap - 1)
        tkeys[pos] = k
        tentry[pos] = e
    evlo = np.full(ecap, 0xFFFFFFFF, np.uint32)
    evhi = np.full(ecap, 0xFFFFFFFF, np.uint32)
    # identity byte translation tables
    ttlo = np.zeros((8, 256), np.uint32)
    tthi = np.zeros((8, 256), np.uint32)
    for b in range(4):
        ttlo[b] = np.arange(256, dtype=np.uint32) << np.uint32(8 * b)
        tthi[4 + b] = np.arange(256, dtype=np.uint32) << np.uint32(8 * b)
    probe_keys = rng.integers(1, 2 * n_entries, rows).astype(np.int32)
    bits_lo = np.ones(rows, np.uint32)
    bits_hi = np.zeros(rows, np.uint32)
    spec = (((-1, 0, 0, None),), False)
    dev = shard_devices(mesh)[0]
    arrays = [
        torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)
        for a in (bits_lo, bits_hi, probe_keys, tkeys, tentry, evlo, evhi, ttlo, tthi)
    ]
    ref = chain_launch(spec, arrays)
    before = _build.launch_counts().get("fused_chain", 0)
    shd = chain_launch(spec, arrays, mesh=mesh)
    launches = _build.launch_counts().get("fused_chain", 0) - before
    return {
        "rows": int(rows),
        "data_shards": d,
        "parity": bool(torch.equal(ref, shd)),
        "matched_rows": int(split_outputs(spec, rows, ref.cpu())[-2][0, 1]),
        "shard_launches": int(launches),
    }


def _join_stats(d: int, rows: int, capacity: int, build_width: int, probe_width: int) -> Dict:
    """Per-device numbers of one partitioned join, from the exchange's
    accounting (module docstring)."""
    from ..relational.distributed import exchange_bytes

    local = rows // d
    recv = d * capacity  # rows a device receives per side
    moved = exchange_bytes(d, capacity, build_width) + exchange_bytes(d, capacity, probe_width)
    mem = 0
    for w in (build_width, probe_width):
        row_bytes = 8 + 4 * w
        mem += local * row_bytes + 2 * recv * row_bytes  # read shard, write send, read receive
    mem += recv * (4 * (build_width + probe_width) + 1 + 8)  # joined rows, hit, keys
    log_n = max(1, math.ceil(math.log2(recv)))
    return {
        "flops_per_device": float(2 * recv * log_n + recv),
        "mem_bytes_per_device": float(mem),
        "coll_bytes_per_device": float(moved if d > 1 else 0),
        "coll_count": 2 if d > 1 else 0,
        "coll_by_op": {"exchange": 2 if d > 1 else 0},
    }


def db_plane_record(
    mesh,
    *,
    rows: int = 1 << 26,
    n_groups: int = 256,
    chain_rows: Optional[int] = 2048,
) -> Dict:
    """Run the distributed GraftDB data plane on ``mesh`` and return a
    validated record — the engine's data plane shards across the mesh's
    devices (DESIGN.md §4/§14). The join takes ``rows`` unique build keys
    and ``rows`` probe keys drawn from twice their range (about half hit),
    widths 2 and 3; the aggregate ``rows`` rows into ``n_groups`` groups,
    width 4; data from a fixed seed. A join that overflows a bucket fails the
    record. ``chain_rows=None`` skips the fused-chain parity block."""
    from ..relational.distributed import (
        BucketOverflowError,
        make_partitioned_aggregate,
        make_partitioned_join,
    )

    t0 = time.time()
    d = int(mesh.shape["data"])
    rec: Dict = {
        "arch": "graftdb-dataplane",
        "shape": f"join_{rows >> 20 if rows >= 1 << 20 else rows}"
        + ("M" if rows >= 1 << 20 else ""),
        "mesh": _mesh_label(mesh),
        "data_shards": d,
        "rows": int(rows),
        "status": "ok",
        "aggregate": "skipped",
        "chain": "skipped",
    }
    try:
        rng = np.random.default_rng(7)
        capacity = max(8, 2 * rows // d // max(d, 1))
        join = make_partitioned_join(mesh, build_width=2, probe_width=3, capacity=capacity)
        bk = rng.permutation(rows).astype(np.int64) + 1
        pk = rng.integers(1, 2 * rows + 1, rows).astype(np.int64)
        bv = rng.normal(size=(rows, 2)).astype(np.float32)
        pv = rng.normal(size=(rows, 3)).astype(np.float32)
        _, hit, _, overflow = join(bk, bv, pk, pv)
        if int(overflow):
            raise BucketOverflowError(
                f"the join overflowed {int(overflow)} row(s) at capacity {capacity}"
            )
        rec["hlo_stats"] = _join_stats(d, rows, capacity, 2, 3)
        rec["join_hits"] = int(hit.sum())
        agg = make_partitioned_aggregate(mesh, n_groups=n_groups, width=4)
        gids = rng.integers(0, n_groups, rows)
        vals = rng.normal(size=(rows, 4)).astype(np.float32)
        sums = agg(gids, vals)
        if tuple(sums.shape) != (n_groups, 4) or not bool(torch.isfinite(sums).all()):
            raise ValueError(f"aggregate gave {tuple(sums.shape)} or non-finite sums")
        rec["aggregate"] = "ok"
        if chain_rows is not None:
            rec["chain"] = _chain_parity(mesh, chain_rows)
    except Exception as e:  # the record reports the failure; the validator raises
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def validate_db_plane_record(rec: Dict) -> Dict:
    """Structural + status validation of a db-plane record; raises
    ValueError with the first problem found, returns the record on
    success (so call sites can chain it)."""
    missing = [f for f in REQUIRED_FIELDS if f not in rec]
    if missing:
        raise ValueError(f"db-plane record missing fields: {missing}")
    if rec["status"] != "ok":
        raise ValueError(
            f"db-plane run failed: {rec.get('error', 'unknown error')}"
        )
    hs = rec["hlo_stats"]
    bad = [f for f in HLO_STAT_FIELDS if not isinstance(hs.get(f), (int, float))]
    if bad:
        raise ValueError(f"db-plane hlo_stats malformed fields: {bad}")
    if rec["aggregate"] != "ok":
        raise ValueError(f"db-plane aggregate failed: {rec['aggregate']!r}")
    chain = rec["chain"]
    if chain != "skipped":
        if not isinstance(chain, dict) or not chain.get("parity"):
            raise ValueError(
                f"shard-local fused chain is not bit-identical to the "
                f"unsharded launch: {chain!r}"
            )
        if chain.get("matched_rows", 0) <= 0:
            raise ValueError(
                f"chain parity block matched no rows — vacuous check: {chain!r}"
            )
    if rec["data_shards"] > 1 and hs["coll_count"] <= 0:
        raise ValueError(
            "multi-shard join made zero exchanges — the exchange was "
            "elided, the plan is not actually distributed"
        )
    return rec
