"""The port's mesh plane (DESIGN.md §14) against the reference.

Ports of ``tests/test_mesh_engine.py`` and ``tests/test_distributed_plane.py``
run the port alone (``graftdb_torch``, ``device="cpu"``: every kernel runs
its plain PyTorch version, and a mesh's shards are CPU shards): the
smoke-mesh session against the mesh-less 1x1 oracle, the config layer, the
per-device state views, the real exchange, the db-plane record, the
partitioned join, exchange and aggregate, and the FILL padding round trips.
The port's multi-shard meshes run here too (``DataMesh(n, "cpu")``), where
the reference needs forced host devices.

Parity tests hold the port to ``graftdb``: mesh sessions (``mesh="smoke"``
with ``backend="pallas"``; ``mesh=2`` and ``4``, where the reference gets a
duck-typed mesh, since its N-shard control plane runs in one process and
its chain runs unsharded on more than one shard) bit for bit in results,
per-query stats and EXPLAIN GRAFT, counters, ``mesh_stats()`` and the
virtual clock; the exchange, join and aggregate on the smoke mesh bit for
bit (the aggregate, a float32 product, at rtol 1e-5); and the exchange at
four host devices (``--xla_force_host_platform_device_count=4`` in a
subprocess) bit for bit in keys, values, valid, capacity, attempts and
``bucket_overflow_rows``. The port departs from the reference on one
input, deliberately: the reference's exchange overwrites the last cell of
bucket 0 with a padding row when that bucket fills exactly
(``test_exact_fill_keeps_every_row``).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graftdb
import graftdb_torch
from _port_counters import assert_counters_match, assert_stats_match
from graftdb_torch import EngineConfig
from repro.core.hashindex import key_partition as ref_key_partition
from repro.launch.mesh import make_smoke_mesh as ref_smoke_mesh
from repro.relational import distributed as ref_dist
from repro.relational import queries as ref_queries
from repro_torch.core.hashindex import key_partition
from repro_torch.kernels import fused_chain
from repro_torch.launch.db_plane import _chain_parity, db_plane_record, validate_db_plane_record
from repro_torch.launch.mesh import DataMesh, make_data_mesh, make_smoke_mesh, mesh_data_size, resolve_mesh
from repro_torch.relational import distributed as dist
from repro_torch.relational import queries
from repro_torch.relational.distributed import (
    FILL,
    BucketOverflowError,
    exchange_by_key,
    make_partitioned_aggregate,
    make_partitioned_join,
    pad_groups,
    pad_partition,
)
from repro_torch.relational.table import database_from_numpy
from test_torch_kernels import _random_chain

torch.set_num_threads(2)

ALL_MODES = ["isolated", "scan_sharing", "qpipe_osp", "residual", "graft"]
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def tdb(db):
    return database_from_numpy(db.tables, db.scale_factor)


def _workload(db, n=4, seed=123, spacing=0.001):
    rng = np.random.default_rng(seed)
    return [queries.sample_query(db, rng, arrival=i * spacing) for i in range(n)]


def _run(db, qs, **cfg):
    session = graftdb_torch.connect(db, EngineConfig(morsel_size=8192, device="cpu", **cfg))
    futs = session.submit_all(
        [queries.make_query(db, q.template, q.params, arrival=q.arrival) for q in qs]
    )
    session.run()
    return session, [f.result() for f in futs]


def _assert_bit_identical(ra, rb, ctx=""):
    assert set(ra) == set(rb), ctx
    for k in ra:
        np.testing.assert_array_equal(np.asarray(ra[k]), np.asarray(rb[k]), err_msg=f"{ctx}/{k}")


# ---------------------------------------------------------------------------
# Parity: smoke-mesh session vs the mesh-less 1x1 oracle, all five modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ALL_MODES)
def test_smoke_mesh_bit_identical_to_oracle(tdb, mode):
    _, r1 = _run(tdb, _workload(tdb), mode=mode, workers=1, partitions=1)
    sm, r2 = _run(tdb, _workload(tdb), mode=mode, mesh="smoke")
    for a, b in zip(r1, r2):
        _assert_bit_identical(a, b, ctx=mode)
    assert sm.engine.n_partitions == 1
    assert sm.stats()["mesh_data_shards"] == 1
    assert sm.backend.mesh is sm.mesh  # the chain launches shard-locally


def test_smoke_mesh_clock_identical_to_oracle(tdb):
    s1, _ = _run(tdb, _workload(tdb), mode="graft", workers=1, partitions=1)
    s2, _ = _run(tdb, _workload(tdb), mode="graft", mesh="smoke")
    # virtual completion clocks are part of the §14 determinism contract
    assert s1.now == s2.now


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_session_matches_partitioned_oracle(tdb, n):
    """An n-shard mesh session gives the mesh-less ``workers = partitions
    = n`` session's results; its clock is no earlier (it pays the
    exchange), and every shard received rows. Device affinity runs the
    partition units in another order, so float64 sums may differ in the
    last bit: the reference's own mesh=2 session differs from its oracle
    by 1 ulp on this workload (q8's ``total_volume``), so the results are
    held at rtol 1e-12, and bit for bit to the reference in
    ``test_mesh_session_matches_reference``."""
    so, ro = _run(tdb, _workload(tdb), mode="graft", workers=n, partitions=n)
    sm, rm = _run(tdb, _workload(tdb), mode="graft", mesh=n)
    for a, b in zip(ro, rm):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-12, err_msg=f"mesh={n}/{k}")
    st = sm.mesh_stats()
    assert st["data_shards"] == n and st["devices"] == ["cpu"] * n
    assert st["mesh_exchange_rows"] > 0
    assert len(st["rows_by_device"]) == n and min(st["rows_by_device"]) > 0
    assert sm.now >= so.now
    assert sm.backend.mesh is None  # more than one shard: the chain runs unsharded


# ---------------------------------------------------------------------------
# Config layer: mesh spec resolution + partition/worker pinning
# ---------------------------------------------------------------------------


def test_mesh_config_pins_partitions_and_workers():
    cfg = EngineConfig(mesh=4)
    assert cfg.partitions == 4 and cfg.workers == 4
    cfg = EngineConfig(mesh="smoke")
    assert cfg.partitions == 1 and cfg.workers == 1
    # explicit matching values are fine
    cfg = EngineConfig(mesh=2, partitions=2, workers=2)
    assert cfg.partitions == 2
    cfg = EngineConfig(mesh=DataMesh(3, "cpu"))
    assert cfg.partitions == 3 and cfg.workers == 3


def test_mesh_config_rejects_mismatch_and_bad_specs():
    with pytest.raises(ValueError, match="partitions"):
        EngineConfig(mesh=4, partitions=3)
    with pytest.raises(ValueError, match="workers"):
        EngineConfig(mesh=4, workers=3)
    with pytest.raises(ValueError):
        EngineConfig(mesh="nope")
    with pytest.raises(ValueError):
        EngineConfig(mesh=0)
    with pytest.raises(ValueError):
        EngineConfig(mesh=True)
    with pytest.raises(ValueError, match="clock"):
        EngineConfig(mesh=2, clock="wall")


def test_resolve_mesh_layer():
    assert mesh_data_size("smoke") == 1
    assert mesh_data_size(8) == 8
    mesh = resolve_mesh("smoke", "cpu")
    assert mesh.shape["data"] == 1
    assert mesh_data_size(mesh) == 1
    assert resolve_mesh(mesh, "cpu") is mesh
    assert make_data_mesh(4, "cpu").shape == {"data": 4, "model": 1}
    with pytest.raises(ValueError):
        resolve_mesh(None)
    with pytest.raises(ValueError):
        make_data_mesh(0, "cpu")


def test_cuda_mesh_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="CUDA card"):
        make_smoke_mesh()  # the default device is the card: no silent CPU mesh
    assert EngineConfig(mesh="smoke").make_mesh("cpu").shape["data"] == 1


def test_mesh_off_the_sessions_device_raises():
    """A mesh of CPU shards under a card session (the config's default
    device) raises instead of running the card's chain on the CPU; on a
    CPU session the same mesh resolves as it is."""
    mesh = DataMesh(1, "cpu")
    with pytest.raises(ValueError, match="shards on"):
        EngineConfig(mesh=mesh).make_mesh()
    with pytest.raises(ValueError, match="shards on"):
        resolve_mesh(DataMesh(2, "cpu"), "cuda:0")
    assert EngineConfig(mesh=mesh, device="cpu").make_mesh() is mesh


def test_sharded_chain_rejects_shards_off_the_inputs_device():
    """CPU inputs with a mesh naming the card: the sharded chain raises
    before it copies a shard."""
    card = type("CardMesh", (), {"axis_names": ("data", "model"),
                                 "shape": {"data": 1, "model": 1},
                                 "devices": [[torch.device("cuda", 0)]]})()
    spec, arrays = _random_chain(0, n=64)
    arrays = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)) for a in arrays]
    with pytest.raises(ValueError, match="shards on"):
        fused_chain.chain_launch(spec, arrays, mesh=card)


# ---------------------------------------------------------------------------
# Per-device state views + the real exchange on the session mesh
# ---------------------------------------------------------------------------


def test_mesh_stats_and_device_layout(tdb):
    # retention='epoch' keeps retired states resident so the per-device
    # layout is inspectable after the trace drains
    sm, _ = _run(tdb, _workload(tdb), mode="graft", mesh="smoke", retention="epoch")
    st = sm.mesh_stats()
    assert st["data_shards"] == 1
    assert st["devices"] == ["cpu"]
    assert st["mesh_exchange_rows"] == 0  # single shard: no exchange modeled
    assert st["bucket_overflow_rows"] == 0
    layouts = st["states"]
    assert layouts, "graft run must leave shared build state behind"
    for lay in layouts:
        assert lay["n_shards"] == 1
        assert len(lay["entries_by_device"]) == 1
        assert sum(lay["entries_by_device"]) > 0
        assert len(lay["bytes_by_device"]) == 1
        # replicated control plane: every extent frontier committed fully
        for done, total in lay["extent_frontiers"].values():
            assert done == total


def test_state_shard_views_partition_everything(tdb):
    sm, _ = _run(tdb, _workload(tdb), mode="graft", mesh="smoke", retention="epoch")
    states = [s for sts in sm.engine.state_index.values() for s in sts]
    states += [
        s for s in sm.engine.lifecycle.retired.values() if hasattr(s, "shard_entry_counts")
    ]
    assert states
    for st_ in states:
        counts = st_.shard_entry_counts(4)
        assert counts.sum() == len(st_.keycode.data)
        fr = st_.device_frontiers()
        assert set(fr) == set(st_.extents)
        for eid, (done, total) in fr.items():
            assert (done, total) == st_.extent_partition_frontier(eid)


@pytest.mark.parametrize("mesh", ["smoke", 4])
def test_validate_mesh_plane_round_trips(tdb, mesh):
    sm, _ = _run(tdb, _workload(tdb), mode="graft", mesh=mesh)
    rec = sm.validate_mesh_plane(sample_rows=512)
    assert rec["data_shards"] == mesh_data_size(mesh)
    assert rec["rows"] > 0
    assert rec["rows_lost"] == 0
    assert rec["rows_placed"] == rec["rows"]
    assert rec["routing_matches_state_shards"] is True


def test_mesh_explain_accounting_per_shard(tdb):
    """EXPLAIN GRAFT accounting is preserved exactly per shard:
    represented + residual + unattached == demand on every device."""
    qs = _workload(tdb, n=4)
    session = graftdb_torch.connect(tdb, EngineConfig(mode="graft", mesh="smoke", device="cpu"))
    session.submit_all(qs[:3])
    session.run()
    ex = session.explain_graft(qs[3])
    for pt in ex.partition_totals():
        assert pt["represented"] + pt["residual"] + pt["unattached"] == pt["demand"]
    assert (
        ex.represented_rows + ex.residual_rows + ex.unattached_rows == ex.total_demand_rows
    )


# ---------------------------------------------------------------------------
# db-plane record and the shard-local fused chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 4])
def test_db_plane_record_validates(d):
    rec = db_plane_record(make_data_mesh(d, "cpu"), rows=1 << 12, chain_rows=512)
    validate_db_plane_record(rec)  # raises on any structural problem
    assert rec["status"] == "ok"
    assert rec["data_shards"] == d
    assert rec["chain"]["parity"] is True
    assert rec["chain"]["matched_rows"] > 0
    assert rec["hlo_stats"]["mem_bytes_per_device"] > 0
    assert (rec["hlo_stats"]["coll_count"] > 0) == (d > 1)
    assert rec["join_hits"] > 0


def test_db_plane_validator_rejects_broken_records():
    rec = db_plane_record(make_smoke_mesh("cpu"), rows=1 << 12, chain_rows=512)
    bad = dict(rec)
    bad["status"] = "fail"
    with pytest.raises(ValueError, match="failed"):
        validate_db_plane_record(bad)
    bad = dict(rec)
    del bad["hlo_stats"]
    with pytest.raises(ValueError, match="missing"):
        validate_db_plane_record(bad)
    bad = dict(rec)
    bad["chain"] = {"parity": False}
    with pytest.raises(ValueError, match="bit-identical"):
        validate_db_plane_record(bad)
    bad = dict(rec, data_shards=2)
    with pytest.raises(ValueError, match="zero exchanges"):
        validate_db_plane_record(bad)


def test_sharded_chain_launch_parity_on_smoke_mesh():
    """chain_launch(mesh=...) on the smoke mesh: every output is
    bit-identical to the plain launch."""
    block = _chain_parity(make_smoke_mesh("cpu"), rows=1024)
    assert block["parity"] is True
    assert block["matched_rows"] > 0
    assert block["shard_launches"] == 0  # the plain version ran, on the CPU


@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_chain_equals_unsharded(d):
    """A two-stage chain with grants, filters (a host column and an
    entry-indexed one) and a build sink: the stats and slot counts sum
    over the shards, the row outputs gather in shard order."""
    spec, arrays = _random_chain(d, n=64)
    arrays = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)) for a in arrays]
    want = fused_chain.chain_launch(spec, arrays)
    got = fused_chain.chain_launch(spec, arrays, mesh=make_data_mesh(d, "cpu"))
    assert torch.equal(got, want)
    assert fused_chain.split_outputs(spec, 64, want)[2 + len(spec[0])][:, 1].sum() > 0


def test_sharded_chain_rejects_uneven_shards():
    spec, arrays = _random_chain(0, n=64)
    arrays = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)) for a in arrays]
    with pytest.raises(ValueError, match="shards"):
        fused_chain.chain_launch(spec, arrays, mesh=make_data_mesh(3, "cpu"))
    with pytest.raises(ValueError, match="shards"):
        fused_chain.chain_launch(spec, arrays, mesh=make_data_mesh(16, "cpu"))


# ---------------------------------------------------------------------------
# The distributed data plane (ports of test_distributed_plane.py)
# ---------------------------------------------------------------------------


def _run_join(mesh, bk, bv, pk, pv, capacity=1024, pad_shards=None):
    """Pad + run the partitioned join; returns (out, hit, out_keys, overflow)."""
    n = pad_shards if pad_shards is not None else mesh.shape["data"]
    jbk, jbv, _ = pad_partition(bk, bv, n)
    jpk, jpv, _ = pad_partition(pk, pv, n)
    join = make_partitioned_join(mesh, bv.shape[1], pv.shape[1], capacity=capacity)
    out, hit, out_keys, overflow = join(jbk, jbv, jpk, jpv)
    return out.numpy(), hit.numpy(), out_keys.numpy(), int(overflow)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_partitioned_join_matches_numpy(d):
    rng = np.random.default_rng(0)
    nb, npr = 200, 500
    bk = rng.choice(10_000, nb, replace=False).astype(np.int64)
    bv = rng.normal(size=(nb, 2)).astype(np.float32)
    pk = np.concatenate([bk[:100], rng.choice(10_000, npr - 100).astype(np.int64) + 10_000])
    pv = rng.normal(size=(npr, 3)).astype(np.float32)

    out, hit, out_keys, overflow = _run_join(make_data_mesh(d, "cpu"), bk, bv, pk, pv)
    assert overflow == 0

    bmap = {int(k): bv[i] for i, k in enumerate(bk)}
    assert hit.sum() == sum(int(k) in bmap for k in pk)
    for i in np.flatnonzero(hit):
        k = int(out_keys[i])
        assert k in bmap
        np.testing.assert_array_equal(out[i, 3:], bmap[k])


def test_bucket_overflow_is_counted_never_silent():
    """A deliberately overflowed bucket: the join reports the dropped rows
    through its overflow output instead of silently losing them."""
    bk = np.arange(64, dtype=np.int64)
    bv = np.ones((64, 1), np.float32)
    pk = np.arange(64, dtype=np.int64)
    pv = np.ones((64, 1), np.float32)
    mesh = make_smoke_mesh("cpu")
    # capacity 16 < 64 rows all hashing to the single shard: 48 build +
    # 48 probe rows overflow
    _, hit, _, overflow = _run_join(mesh, bk, bv, pk, pv, capacity=16)
    assert int(hit.sum()) < 64  # rows really did not fit
    assert overflow == 2 * (64 - 16)
    _, hit_ok, _, overflow_ok = _run_join(mesh, bk, bv, pk, pv, capacity=128)
    assert int(hit_ok.sum()) == 64
    assert overflow_ok == 0


@pytest.mark.parametrize("d", [1, 4])
def test_exchange_by_key_grows_instead_of_dropping(d):
    """The host wrapper recovers every overflowed row by regrowing
    capacity, surfaces the count, and can hard-fail instead."""
    mesh = make_data_mesh(d, "cpu")
    keys = np.arange(1, 101, dtype=np.int64)
    vals = keys.astype(np.float32)[:, None]
    rec = exchange_by_key(mesh, keys, vals, capacity=16 // d)
    assert rec["bucket_overflow_rows"] > 0  # overflow happened...
    assert rec["attempts"] > 1  # ...and was recovered by regrowing
    ok = rec["valid"].numpy()
    np.testing.assert_array_equal(np.sort(rec["keys"].numpy()[ok]), keys)  # zero rows lost
    v = rec["values"].numpy()[ok]
    np.testing.assert_array_equal(np.sort(v[:, 0]), keys.astype(np.float32))
    with pytest.raises(BucketOverflowError):
        exchange_by_key(mesh, keys, vals, capacity=16 // d, on_overflow="raise")


@pytest.mark.parametrize("d", [1, 4])
def test_exchange_by_key_routes_by_engine_partition(d):
    """dest= overrides the default hash with the engine's splitmix64
    key_partition, so exchange placement matches state-shard ownership."""
    mesh = make_data_mesh(d, "cpu")
    keys = np.arange(1, 257, dtype=np.int64)
    dest = key_partition(keys, d)
    rec = exchange_by_key(mesh, keys, keys.astype(np.float32)[:, None], dest=dest)
    cap = rec["capacity"]
    got_k = rec["keys"].numpy().reshape(d, d * cap)
    got_ok = rec["valid"].numpy().reshape(d, d * cap)
    for p in range(d):
        np.testing.assert_array_equal(np.sort(got_k[p][got_ok[p]]), np.sort(keys[dest == p]))


def test_exchange_rejects_wide_keys_and_bad_dest():
    mesh = make_data_mesh(2, "cpu")
    vals = np.ones((2, 1), np.float32)
    with pytest.raises(ValueError, match="<="):
        exchange_by_key(mesh, np.array([1, dist.KEY_LIMIT + 1]), vals)
    with pytest.raises(ValueError, match="out of range"):
        exchange_by_key(mesh, np.array([1, 2]), vals, dest=np.array([0, 2]))
    with pytest.raises(ValueError, match="on_overflow"):
        exchange_by_key(mesh, np.array([1, 2]), vals, on_overflow="drop")


def test_exact_fill_keeps_every_row():
    """Eight keys fill bucket 0 to capacity 8 exactly and the shard also
    holds a FILL padding row: every valid row arrives, with overflow 0.
    (The reference's exchange scatters the FILL row into the cell of the
    last kept row and returns 7 valid rows with overflow 0.)"""
    keys = np.concatenate([np.arange(8, dtype=np.int64), [FILL]])
    vals = np.arange(9, dtype=np.float32)[:, None]
    dest = np.zeros(9, np.int64)
    fn = dist.make_partitioned_exchange(make_smoke_mesh("cpu"), 1, 8)
    k, v, ok, ov = fn(torch.from_numpy(keys), torch.from_numpy(vals), torch.from_numpy(dest))
    assert int(ov) == 0
    assert int(ok.sum()) == 8
    np.testing.assert_array_equal(k.numpy(), np.arange(8))
    np.testing.assert_array_equal(v.numpy()[:, 0], np.arange(8, dtype=np.float32))


@pytest.mark.parametrize("pad_shards", [1, 2, 3, 5, 8])
def test_pad_partition_round_trip_exact(pad_shards):
    """Padding rows carry the FILL sentinel and every shard-local consumer
    masks them: join results are identical for any padding factor."""
    rng = np.random.default_rng(3)
    bk = rng.choice(5_000, 150, replace=False).astype(np.int64)
    bv = rng.normal(size=(150, 2)).astype(np.float32)
    pk = np.concatenate([bk[:70], rng.choice(5_000, 30).astype(np.int64) + 5_000])
    pv = rng.normal(size=(100, 3)).astype(np.float32)
    out, hit, out_keys, overflow = _run_join(
        make_smoke_mesh("cpu"), bk, bv, pk, pv, pad_shards=pad_shards
    )
    assert overflow == 0
    bmap = {int(k): bv[i] for i, k in enumerate(bk)}
    assert int(hit.sum()) == 70  # padding contributed zero phantom hits
    for i in np.flatnonzero(hit):
        np.testing.assert_array_equal(out[i, 3:], bmap[int(out_keys[i])])


@pytest.mark.parametrize("pad_shards", [1, 3, 7])
def test_pad_groups_round_trip_exact(pad_shards):
    """Aggregate padding carries the gid=-1 sentinel, masked shard-locally:
    totals identical for any padding factor."""
    rng = np.random.default_rng(4)
    n, g, w = 1000, 16, 4
    gids = rng.integers(0, g, n).astype(np.int64)
    vals = rng.normal(size=(n, w)).astype(np.float32)
    agg = make_partitioned_aggregate(make_smoke_mesh("cpu"), g, w)
    gp, vp = pad_groups(gids, vals, pad_shards)
    assert gp.shape[0] % pad_shards == 0
    got = agg(gp, vp).numpy()
    want = np.zeros((g, w), np.float32)
    np.add.at(want, gids, vals)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_partitioned_aggregate_matches_segment_sum(d):
    rng = np.random.default_rng(2)
    n, g, w = 1000, 16, 4
    gids = rng.integers(0, g, n).astype(np.int32)
    vals = rng.normal(size=(n, w)).astype(np.float32)
    agg = make_partitioned_aggregate(make_data_mesh(d, "cpu"), g, w)
    got = agg(*pad_groups(gids, vals, d)).numpy()
    want = np.zeros((g, w), np.float32)
    np.add.at(want, gids, vals)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The data plane against the reference's functions
# ---------------------------------------------------------------------------


def test_default_hash_matches_reference():
    """The default routing (uint32 multiply wraparound) at keys up to
    KEY_LIMIT, on the device and in ``pad_partition``'s host copy."""
    rng = np.random.default_rng(5)
    lim = dist.KEY_LIMIT
    keys = np.concatenate([rng.integers(-lim, lim + 1, 20_000), [lim, -lim, 0, -1, 1]])
    vals = np.zeros((len(keys), 1), np.float32)
    for n in (1, 2, 3, 4, 8):
        want = np.asarray(ref_dist._hash_dest(jnp.asarray(keys), n))
        np.testing.assert_array_equal(dist._hash_dest(torch.from_numpy(keys), n).numpy(), want)
        np.testing.assert_array_equal(
            pad_partition(keys, vals, n)[2].numpy(),
            np.asarray(ref_dist.pad_partition(keys, vals, n)[2]),
        )


def _join_inputs(seed=0):
    rng = np.random.default_rng(seed)
    bk = rng.choice(10_000, 200, replace=False).astype(np.int64)
    bv = rng.normal(size=(200, 2)).astype(np.float32)
    pk = np.concatenate([bk[:100], rng.choice(10_000, 400).astype(np.int64) + 10_000])
    pv = rng.normal(size=(500, 3)).astype(np.float32)
    return bk, bv, pk, pv


def test_join_matches_reference_on_smoke_mesh():
    bk, bv, pk, pv = _join_inputs()
    want = ref_dist.make_partitioned_join(ref_smoke_mesh(), 2, 3, capacity=1024)(
        *ref_dist.pad_partition(bk, bv, 1)[:2], *ref_dist.pad_partition(pk, pv, 1)[:2]
    )
    got = make_partitioned_join(make_smoke_mesh("cpu"), 2, 3, capacity=1024)(
        *pad_partition(bk, bv, 1)[:2], *pad_partition(pk, pv, 1)[:2]
    )
    for name, g, w in zip(("out", "hit", "keys"), got[:3], want[:3]):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().astype(w.dtype), w, err_msg=name)
    assert int(got[3]) == int(want[3]) == 0


@pytest.mark.parametrize("capacity", [16, 256])
def test_exchange_matches_reference_on_smoke_mesh(capacity):
    """Plain and grown (capacity 16: overflow recovered by regrowing)."""
    keys = np.random.default_rng(6).choice(1 << 20, 300, replace=False).astype(np.int64)
    vals = np.stack([keys, -keys], -1).astype(np.float32)
    want = ref_dist.exchange_by_key(ref_smoke_mesh(), keys, vals, capacity=capacity)
    got = exchange_by_key(make_smoke_mesh("cpu"), keys, vals, capacity=capacity)
    for k in ("capacity", "attempts", "bucket_overflow_rows", "n_shards"):
        assert got[k] == want[k], k
    for k in ("keys", "values", "valid"):
        w = np.asarray(want[k])
        np.testing.assert_array_equal(got[k].numpy().astype(w.dtype), w, err_msg=k)


def test_aggregate_matches_reference_on_smoke_mesh():
    rng = np.random.default_rng(8)
    gids = rng.integers(0, 16, 1000)
    vals = rng.normal(size=(1000, 4)).astype(np.float32)
    want = ref_dist.make_partitioned_aggregate(ref_smoke_mesh(), 16, 4)(
        *ref_dist.pad_groups(gids, vals, 1)
    )
    got = make_partitioned_aggregate(make_smoke_mesh("cpu"), 16, 4)(*pad_groups(gids, vals, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


_FOUR_DEVICES = """
import json, sys
import numpy as np
from repro.core.hashindex import key_partition
from repro.launch.mesh import make_data_mesh
from repro.relational.distributed import exchange_by_key

out = {}
mesh = make_data_mesh(4)
rng = np.random.default_rng(9)
keys = rng.choice(1 << 24, 1000, replace=False).astype(np.int64)
vals = np.stack([keys, keys % 97], -1).astype(np.float32)
dest = key_partition(keys, 4)
for case, kw in (("plain", dict(dest=dest)), ("grow", dict(dest=dest, capacity=4))):
    rec = exchange_by_key(mesh, keys, vals, **kw)
    out[case] = {k: (np.asarray(v).tolist() if k in ("keys", "values", "valid") else v)
                 for k, v in rec.items()}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def four_device_exchange(tmp_path_factory):
    """The reference's exchange at four forced host devices, in a
    subprocess (jax pins the device count at its first init)."""
    path = tmp_path_factory.mktemp("mesh") / "exchange.json"
    env = dict(
        os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    out = subprocess.run(
        [sys.executable, "-c", _FOUR_DEVICES, str(path)], env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("case", ["plain", "grow"])
def test_exchange_matches_reference_at_four_host_devices(four_device_exchange, case):
    want = four_device_exchange[case]
    rng = np.random.default_rng(9)
    keys = rng.choice(1 << 24, 1000, replace=False).astype(np.int64)
    vals = np.stack([keys, keys % 97], -1).astype(np.float32)
    dest = key_partition(keys, 4)
    np.testing.assert_array_equal(dest, ref_key_partition(keys, 4))
    kw = dict(dest=dest) if case == "plain" else dict(dest=dest, capacity=4)
    got = exchange_by_key(make_data_mesh(4, "cpu"), keys, vals, **kw)
    for k in ("capacity", "attempts", "bucket_overflow_rows", "n_shards"):
        assert got[k] == want[k], k
    if case == "grow":
        assert got["attempts"] > 1 and got["bucket_overflow_rows"] > 0
    np.testing.assert_array_equal(got["keys"].numpy(), np.asarray(want["keys"], np.int64))
    np.testing.assert_array_equal(got["values"].numpy(), np.asarray(want["values"], np.float32))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"], bool))


# ---------------------------------------------------------------------------
# Mesh sessions against graftdb
# ---------------------------------------------------------------------------


class _DuckMesh:
    """The reference's N-shard control plane in one process: a mesh
    descriptor with the port's shard device names."""

    axis_names = ("data", "model")

    def __init__(self, n):
        self.shape = {"data": n, "model": 1}
        self.devices = np.array([["cpu"]] * n)


def _pinned(module, db, qs):
    return [
        dataclasses.replace(module.make_query(db, q.template, q.params, arrival=q.arrival),
                            qid=20_000 + i)
        for i, q in enumerate(qs)
    ]


@pytest.mark.parametrize("mesh", ["smoke", 2, 4])
def test_mesh_session_matches_reference(db, tdb, mesh):
    rng = np.random.default_rng(123)
    qs = [ref_queries.sample_query(db, rng, arrival=i * 0.001) for i in range(4)]
    cfg = dict(mode="graft", morsel_size=8192, capture_explain=True)
    s_ref = graftdb.connect(db, graftdb.EngineConfig(
        backend="pallas", mesh=mesh if mesh == "smoke" else _DuckMesh(mesh), **cfg))
    f_ref = s_ref.submit_all(_pinned(ref_queries, db, qs))
    s_ref.run()
    s_port = graftdb_torch.connect(tdb, EngineConfig(device="cpu", mesh=mesh, **cfg))
    f_port = s_port.submit_all(_pinned(queries, tdb, qs))
    s_port.run()
    for a, b in zip(f_ref, f_port):
        ra, rb = a.result(), b.result()
        assert set(ra) == set(rb)
        for k in ra:
            np.testing.assert_array_equal(rb[k], ra[k], err_msg=f"q{a.qid}/{k}")
        assert_stats_match(b.stats(), a.stats())
        assert b.explain().render() == a.explain().render()
    assert_counters_match(s_port.counters, s_ref.counters)
    assert s_port.now == s_ref.now
    assert s_port.backend.stats() == s_ref.backend.stats()
    assert s_port.stats()["mesh_data_shards"] == s_ref.stats()["mesh_data_shards"]
    st_ref, st_port = s_ref.mesh_stats(), s_port.mesh_stats()
    if mesh == "smoke":  # the reference names its jax device
        assert len(st_ref.pop("devices")) == len(st_port.pop("devices")) == 1
    assert st_port == st_ref
    assert s_port.counters["kernel_chain_launches"] > 0
    if mesh != "smoke":
        assert st_port["mesh_exchange_rows"] > 0
    q = qs[0]
    qr, qt = (
        dataclasses.replace(m.make_query(d, q.template, q.params, arrival=s.now), qid=1)
        for m, d, s in ((ref_queries, db, s_ref), (queries, tdb, s_port))
    )
    assert s_port.explain_graft(qt).render() == s_ref.explain_graft(qr).render()


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_fault_site_matches_reference(db, tdb, n):
    """On a multi-shard mesh every shared morsel advance draws the
    ``exchange`` fault site: fault counters and statuses line up."""
    rng = np.random.default_rng(77)
    qs = [ref_queries.sample_query(db, rng, arrival=i * 0.001) for i in range(3)]
    cfg = dict(mode="graft", morsel_size=8192)
    schedule = {"exchange": 0.2, "stall": 0.1}
    s_ref = graftdb.connect(db, graftdb.EngineConfig(
        backend="reference", mesh=_DuckMesh(n), faults=graftdb.FaultPlan(seed=5, schedule=schedule),
        **cfg))
    f_ref = s_ref.submit_all(_pinned(ref_queries, db, qs))
    s_ref.run()
    s_port = graftdb_torch.connect(tdb, EngineConfig(
        backend="reference", device="cpu", mesh=n,
        faults=graftdb_torch.FaultPlan(seed=5, schedule=schedule), **cfg))
    f_port = s_port.submit_all(_pinned(queries, tdb, qs))
    s_port.run()
    assert [f.status for f in f_port] == [f.status for f in f_ref]
    assert_counters_match(s_port.counters, s_ref.counters)
    assert s_port.now == s_ref.now
    assert s_port.counters["faults_injected"] > 0
    draws = s_port.engine.faults._calls
    assert draws == s_ref.engine.faults._calls
    assert draws["exchange"] > 0 and draws["morsel"] == 0
