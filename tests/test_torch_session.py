"""The port's folding main path against the reference engine.

The same TPC-H data (handed over with ``database_from_numpy``) and the same
fuzz workloads run through ``graftdb_torch.connect(..., device="cpu")`` —
the torch backend with every kernel's plain PyTorch version — and through
``graftdb.connect(..., backend="pallas")``. Everything must be identical:
query results bit for bit, every engine counter, the virtual clock, the
backend's kernel and fallback counters, per-query stats and the EXPLAIN
GRAFT render. Results are also held against the port's own reference
executor. There is no tolerance: everything on this path is integer or
float64-exact.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import graftdb
import graftdb_torch
from repro.relational import queries as ref_queries
from repro_torch.api.backends import TorchBackend
from repro_torch.relational import queries, refexec
from repro_torch.relational.table import database_from_numpy

torch.set_num_threads(2)

MODES = ["isolated", "scan_sharing", "qpipe_osp", "residual", "graft"]
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def tdb(db):
    return database_from_numpy(db.tables, db.scale_factor)


def _workload(db, seed):
    """Reference queries of one fuzz workload (3-5 sampled templates,
    staggered arrivals)."""
    rng = np.random.default_rng(seed)
    qs, t = [], 0.0
    for _ in range(int(rng.integers(3, 6))):
        t += float(rng.choice([0.0, 0.002, 0.02, 0.08]))
        qs.append(ref_queries.sample_query(db, rng, arrival=t))
    return qs


def _workload_port(tdb, seed):
    """A fuzz workload sampled from the port's own query module."""
    rng = np.random.default_rng(seed)
    return [queries.sample_query(tdb, rng, arrival=0.01 * i) for i in range(3)]


def _same_qids(qs):
    """Pin query ids (each package numbers its queries on its own), so
    per-query stats and EXPLAIN renders compare equal."""
    return [dataclasses.replace(q, qid=10_000 + i) for i, q in enumerate(qs)]


def _run_ref(db, qs, **cfg):
    session = graftdb.connect(
        db, graftdb.EngineConfig(backend="pallas", capture_explain=True, **cfg)
    )
    futs = session.submit_all(_same_qids(
        [ref_queries.make_query(db, q.template, q.params, arrival=q.arrival) for q in qs]
    ))
    session.run()
    return session, futs


def _run_port(tdb, qs, **cfg):
    session = graftdb_torch.connect(
        tdb, graftdb_torch.EngineConfig(device="cpu", capture_explain=True, **cfg)
    )
    futs = session.submit_all(_same_qids(
        [queries.make_query(tdb, q.template, q.params, arrival=q.arrival) for q in qs]
    ))
    session.run()
    return session, futs


def _assert_same(s_ref, f_ref, s_port, f_port):
    assert len(f_ref) == len(f_port)
    for a, b in zip(f_ref, f_port):
        ra, rb = a.result(), b.result()
        assert set(ra) == set(rb)
        for k in ra:
            np.testing.assert_array_equal(rb[k], ra[k], err_msg=f"q{a.qid}/{k}")
        assert b.stats() == a.stats()
        assert b.explain().render() == a.explain().render()
    assert dict(s_port.counters) == dict(s_ref.counters)
    assert s_port.now == s_ref.now
    assert s_port.backend.stats() == s_ref.backend.stats()


def _assert_refexec(tdb, futs):
    for f in futs:
        got, want = f.result(), refexec.execute(tdb, f.query.plan)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(
                np.asarray(got[k], np.float64), np.asarray(want[k], np.float64), rtol=1e-9
            )


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("mode", MODES)
def test_port_matches_reference_session(db, tdb, mode, workers):
    qs = _workload(db, 42_000)
    cfg = dict(mode=mode, morsel_size=16384, workers=workers, partitions=workers)
    s_ref, f_ref = _run_ref(db, qs, **cfg)
    s_port, f_port = _run_port(tdb, qs, **cfg)
    _assert_same(s_ref, f_ref, s_port, f_port)
    _assert_refexec(tdb, f_port)
    if mode != "isolated":
        assert s_port.counters["kernel_chain_launches"] > 0
    for q in qs[:2]:  # pre-flight EXPLAIN GRAFT against the final state
        qr, qt = (
            dataclasses.replace(m.make_query(d, q.template, q.params, arrival=s.now), qid=1)
            for m, d, s in ((ref_queries, db, s_ref), (queries, tdb, s_port))
        )
        assert s_port.explain_graft(qt).render() == s_ref.explain_graft(qr).render()


@pytest.mark.parametrize("mode", ["qpipe_osp", "graft"])
def test_port_matches_reference_per_member_oracle(db, tdb, mode):
    """``member_major=False``: the per-member loops probe through
    ``probe_visible`` and the plain ``probe`` kernel instead of the chain."""
    qs = _workload(db, 42_001)
    cfg = dict(mode=mode, morsel_size=16384, member_major=False, workers=1)
    s_ref, f_ref = _run_ref(db, qs, **cfg)
    s_port, f_port = _run_port(tdb, qs, **cfg)
    _assert_same(s_ref, f_ref, s_port, f_port)
    _assert_refexec(tdb, f_port)
    assert s_port.counters["kernel_chain_launches"] == 0
    assert s_port.backend.kernel_probes > 0


def test_port_matches_reference_under_epoch_and_admission(db, tdb):
    """The partition pool (workers=4) with epoch retention, a memory
    budget and adaptive admission: evictions and deferrals line up."""
    stress = dict(
        mode="graft", morsel_size=16384, retention="epoch", memory_budget=200_000,
        admission="adaptive", admission_max_inflight=3,
        admission_share_threshold=0.4, workers=4, partitions=4,
    )
    qs = _workload(db, 77_000)
    s_ref, f_ref = _run_ref(db, qs, **stress)
    s_port, f_port = _run_port(tdb, qs, **stress)
    _assert_same(s_ref, f_ref, s_port, f_port)
    assert s_port.counters["kernel_chain_launches"] > 0


def test_grant_compiled_chain_matches_reference(db, tdb):
    """Near-miss grafted repeats compile extent-scoped grants into the
    chain launch."""
    seq = [(750.0, 0.0), (760.0, 0.01), (750.0, 0.02), (800.0, 0.03)]
    qs = [
        ref_queries.make_query(db, "q3", {"segment": 1.0, "date": d}, arrival=t)
        for d, t in seq
    ]
    s_ref, f_ref = _run_ref(db, qs, mode="graft", morsel_size=16384, workers=1)
    s_port, f_port = _run_port(tdb, qs, mode="graft", morsel_size=16384, workers=1)
    _assert_same(s_ref, f_ref, s_port, f_port)
    _assert_refexec(tdb, f_port)


def test_reference_backend_matches_reference(db, tdb):
    qs = _workload(db, 42_002)
    s_ref, f_ref = _run_ref(db, qs, mode="graft", morsel_size=16384, workers=1)
    session = graftdb_torch.connect(
        tdb, graftdb_torch.EngineConfig(mode="graft", morsel_size=16384, workers=1,
                                        backend="reference")
    )
    futs = session.submit_all(
        [queries.make_query(tdb, q.template, q.params, arrival=q.arrival) for q in qs]
    )
    session.run()
    for a, b in zip(f_ref, futs):
        for k, v in a.result().items():
            np.testing.assert_array_equal(b.result()[k], v)


# ---------------------------------------------------------------------------
# configuration surface
# ---------------------------------------------------------------------------


def test_config_defaults_to_the_card():
    cfg = graftdb_torch.EngineConfig()
    assert cfg.backend == "torch" and cfg.device == "cuda"
    assert cfg.morsel_size == 65536


@pytest.mark.parametrize("flag", ["use_agg_kernel", "use_insert_kernel"])
def test_kernel_flags_are_accepted(tdb, flag):
    """The reference's opt-in kernel flags: a session runs with each and
    its results equal the reference executor's (rtol 1e-5, the float32
    aggregate kernel's tolerance)."""
    backend = TorchBackend(device="cpu", **{flag: True})
    assert getattr(backend, flag) and backend.max_kernel_groups == 4096
    session = graftdb_torch.connect(
        tdb, graftdb_torch.EngineConfig(mode="graft", morsel_size=16384, backend=backend)
    )
    futs = session.submit_all([
        queries.make_query(tdb, q.template, q.params, arrival=q.arrival)
        for q in _workload_port(tdb, 42_003)
    ])
    session.run()
    for f in futs:
        want = refexec.execute(tdb, f.query.plan)
        for k, v in f.result().items():
            np.testing.assert_allclose(
                np.asarray(v, np.float64), np.asarray(want[k], np.float64), rtol=1e-5
            )


@pytest.mark.parametrize("limit", [4, 4096])
def test_max_kernel_groups_is_honoured(limit):
    """Sums over more than ``max_kernel_groups`` groups stay on the exact
    float64 path; the others round to float32 in the aggregate kernel."""
    rng = np.random.default_rng(limit)
    gids = rng.integers(0, 16, 3000)
    vals = rng.normal(size=3000) / 3.0
    backend = TorchBackend(device="cpu", use_agg_kernel=True, max_kernel_groups=limit)
    got = backend.segment_sum(gids, vals, 16)
    exact = np.bincount(gids, weights=vals, minlength=16)
    if limit < 16:
        np.testing.assert_array_equal(got, exact)
    else:
        np.testing.assert_array_equal(got, got.astype(np.float32))
        np.testing.assert_allclose(got, exact, rtol=1e-5)


def test_cuda_without_card_raises(tdb):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="CUDA card"):
        graftdb_torch.connect(tdb)


_ISOLATION = """
import sys
import numpy as np
import torch
import graftdb_torch
from graftdb_torch import EngineConfig
from repro_torch.core import batchplan, costmodel, dag, faults, reuse
from repro_torch.api import serving
from repro_torch.serve import folding
from repro_torch.kernels import flash_attention, linrec, ops, ref, seg_aggregate
from repro_torch.relational import queries, refexec, tpch
from repro_torch.core import meshexec
from repro_torch.launch import db_plane, mesh
from repro_torch.relational import distributed
from repro_torch import configs
from repro_torch.models import layers as lm_layers, model as lm_model, moe as lm_moe
from repro_torch.models import recurrent as lm_recurrent, shardctx as lm_shardctx
from repro_torch.launch import serve as lm_serve

db = tpch.get_database(0.002, seed=7)
session = graftdb_torch.connect(db, EngineConfig(mode="graft", device="cpu", morsel_size=2048))
rng = np.random.default_rng(3)
futs = session.submit_all([queries.sample_query(db, rng) for _ in range(3)])
session.run()
for f in futs:
    want = refexec.execute(db, f.query.plan)
    for k, v in f.result().items():
        np.testing.assert_allclose(np.asarray(v, float), np.asarray(want[k], float), rtol=1e-9)
assert session.counters["kernel_chain_launches"] > 0
cached = graftdb_torch.connect(db, EngineConfig(
    mode="graft", device="cpu", morsel_size=2048, retention="epoch", memory_budget=0,
    reuse_cache_budget=1 << 24, reuse_disk_budget=1 << 24,
    faults=graftdb_torch.FaultPlan(seed=3, schedule={"stall": 0.2, "rehydrate": 0.2}),
))
for t in (0.0, 10.0):
    cached.submit_all([queries.make_query(db, "q3", {"segment": 1.0, "date": 750.0}, arrival=t)])
    cached.run()
assert cached.counters["cache_spills"] > 0
cached.close()
planned = graftdb_torch.connect(db, EngineConfig(
    mode="graft", device="cpu", morsel_size=2048, batch_planning=True, batch_window=0.001,
))
burst = [queries.make_query(db, "q3", {"segment": 1.0, "date": d}, arrival=0.0)
         for d in (740.0, 750.0, 760.0)]
assert planned.explain_cohort(burst).plan.order[0] == burst[-1].qid
futs = planned.submit_all(burst)
planned.run()
assert planned.counters["batch_cohorts"] == 1 and len(planned.cohort_log()) == 1
for f in futs:
    want = refexec.execute(db, f.query.plan)
    for k, v in f.result().items():
        np.testing.assert_allclose(np.asarray(v, float), np.asarray(want[k], float), rtol=1e-9)
serve = graftdb_torch.connect_serving(config=graftdb_torch.ServingConfig(batch_fold=True))
reqs = [folding.Request(i, tuple(range(50 + 30 * i)), 4, arrival=0.0) for i in range(3)]
serve.submit_all(reqs)
assert serve.run()["prefill_tokens"]["batch_folded"] == 2
assert isinstance(serve, serving.ServingSession)
q = rng.normal(size=(2, 128, 32)).astype(np.float32)
out = ops.attention(q, q, q, window=64, device="cpu")
torch.testing.assert_close(out, ref.flash_attention_ref(*[torch.from_numpy(q)] * 3, window=64),
                           rtol=1e-5, atol=1e-4)
a = rng.uniform(0.7, 0.999, size=(1, 256, 128)).astype(np.float32)
h = ops.linear_recurrence(a, a, device="cpu")
torch.testing.assert_close(h, ref.linrec_ref(torch.from_numpy(a), torch.from_numpy(a)),
                           rtol=1e-4, atol=1e-4)
meshed = graftdb_torch.connect(db, EngineConfig(
    mode="graft", device="cpu", morsel_size=2048, mesh=2,
))
futs = meshed.submit_all([queries.make_query(db, "q3", {"segment": 1.0, "date": d}, arrival=0.0)
                          for d in (740.0, 760.0)])
meshed.run()
assert meshed.mesh_stats()["mesh_exchange_rows"] > 0
assert meshed.validate_mesh_plane(256)["rows_lost"] == 0
assert isinstance(meshed._mesh_plan, meshexec.MeshPlan)
for f in futs:
    want = refexec.execute(db, f.query.plan)
    for k, v in f.result().items():
        np.testing.assert_allclose(np.asarray(v, float), np.asarray(want[k], float), rtol=1e-9)
db_plane.validate_db_plane_record(
    db_plane.db_plane_record(mesh.make_data_mesh(2, "cpu"), rows=1 << 10, chain_rows=256))
assert distributed.exchange_by_key(mesh.make_smoke_mesh("cpu"), np.arange(5), np.ones(5))["attempts"] == 1
lm_cfg = configs.smoke_config("recurrentgemma-9b")
lm_params = lm_model.init_params(lm_cfg, torch.Generator().manual_seed(0), device="cpu")
lm_logits, _ = lm_model.prefill(lm_cfg, lm_params, {"tokens": torch.zeros(1, 8, dtype=torch.int64)})
assert lm_logits.shape == (1, lm_cfg.vocab_padded) and bool(torch.isfinite(lm_logits).all())
assert lm_shardctx.constrain(lm_logits, "dp", None) is lm_logits
import contextlib, io
lm_out = io.StringIO()
with contextlib.redirect_stdout(lm_out):
    lm_serve.main(["--device", "cpu", "--requests", "2", "--prefix-len", "8", "--suffix-len", "2",
                   "--decode", "2"])
assert "outputs identical: True" in lm_out.getvalue(), lm_out.getvalue()
leaked = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "repro", "graftdb")
)
assert not leaked, leaked
assert EngineConfig().device == "cuda"
if not torch.cuda.is_available():
    try:
        graftdb_torch.connect(db)
    except RuntimeError:
        pass
    else:
        raise AssertionError("connect() without a card did not raise")
print("isolated")
"""


def test_port_imports_nothing_of_the_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATION], env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "isolated" in out.stdout
