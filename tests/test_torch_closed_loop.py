"""The port's closed-loop workload (``repro_torch.launch.workload``)
against the reference's ``benchmarks/common.py``.

Every comparison is exact: ``completed``, ``elapsed_s``,
``throughput_qph``, ``median_latency_s``, ``p95_latency_s``, the
``latencies`` list and ``counters`` must be equal, not close (the
counters as ``_port_counters.assert_counters_match`` holds them). Each run
holds the port against its own counterpart in the reference:

- ``backend="reference"`` (the NumPy engine, the reference helpers'
  default) against ``benchmarks.common.run_closed_loop``, at the four grid
  points of ``examples/concurrent_workload.py``;
- ``backend="torch"`` (the port's default; here each kernel wrapper runs
  its plain version) against the same loop with the reference's kernel
  path, ``backend="pallas"`` in interpret mode, passed in by wrapping
  ``benchmarks.common.open_session``.

The graft clock depends on the backend in the reference itself, so the
two backends' graft clocks are held different. The results that
``keep_results`` keeps are held against the port's reference executor
at rtol 1e-9, the repository's oracle limit (the executor adds its float64
sums in another order). Sizes: TPC-H SF 0.01, 8 clients x 4 queries.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from _port_counters import assert_counters_match  # noqa: E402
from benchmarks import common  # noqa: E402
from repro_torch.launch import workload  # noqa: E402
from repro_torch.relational import queries, refexec  # noqa: E402

torch.set_num_threads(2)

SF = 0.01
CLIENTS, PER = 8, 4
SEED = 3
GRID = [("isolated", 1, 1), ("qpipe_osp", 1, 1), ("graft", 1, 1), ("graft", 4, 8)]
KEYS = ("completed", "elapsed_s", "throughput_qph", "median_latency_s", "p95_latency_s",
        "latencies", "counters")


def _label(point):
    mode, w, p = point
    return mode if w == 1 else f"{mode}-{w}w{p}p"


@pytest.fixture(scope="module")
def ref_db():
    return common.get_db(SF)


@pytest.fixture(scope="module")
def tdb():
    return workload.get_db(SF)


@pytest.fixture(scope="module")
def ref_seqs(ref_db):
    return common.client_sequences(ref_db, CLIENTS, PER, seed=SEED)


@pytest.fixture(scope="module")
def seqs(tdb):
    return workload.client_sequences(tdb, CLIENTS, PER, seed=SEED)


def _assert_same_run(got, want):
    for k in KEYS[:-1]:
        assert got[k] == want[k], (k, got[k], want[k])
    assert_counters_match(got["counters"], want["counters"])


def test_get_db_and_client_sequences_equal_the_reference(ref_db, tdb, ref_seqs, seqs):
    assert tdb.scale_factor == ref_db.scale_factor
    assert set(tdb.tables) == set(ref_db.tables)
    for name, table in ref_db.tables.items():
        assert set(tdb.tables[name].columns) == set(table.columns)
        for col, arr in table.columns.items():
            np.testing.assert_array_equal(tdb.tables[name].columns[col], arr,
                                          err_msg=f"{name}.{col}")
    assert seqs == ref_seqs
    assert len(seqs) == CLIENTS and all(len(s) == PER for s in seqs)
    for alpha, seed in ((0.0, 1), (1.5, 5)):
        assert (workload.client_sequences(tdb, 3, 5, seed=seed, zipf_alpha=alpha)
                == common.client_sequences(ref_db, 3, 5, seed=seed, zipf_alpha=alpha))
    assert workload.MORSEL == common.MORSEL and workload.DEFAULT_SF == common.DEFAULT_SF


@pytest.mark.parametrize("point", GRID, ids=_label)
def test_reference_backend_equals_reference_loop(point, ref_db, tdb, ref_seqs, seqs):
    mode, w, p = point
    want = common.run_closed_loop(ref_db, mode, ref_seqs, workers=w, partitions=p)
    got = workload.run_closed_loop(tdb, mode, seqs, workers=w, partitions=p,
                                   device="cpu", backend="reference")
    assert got["mode"] == mode and got["completed"] == CLIENTS * PER
    _assert_same_run(got, want)


@pytest.mark.parametrize("point", [("graft", 1, 1), ("graft", 4, 8)], ids=_label)
def test_torch_backend_equals_pallas_loop(point, ref_db, tdb, ref_seqs, seqs, monkeypatch):
    mode, w, p = point
    monkeypatch.setattr(common, "open_session",
                        functools.partial(common.open_session, backend="pallas"))
    want = common.run_closed_loop(ref_db, mode, ref_seqs, workers=w, partitions=p)
    got = workload.run_closed_loop(tdb, mode, seqs, workers=w, partitions=p, device="cpu")
    assert got["counters"]["kernel_chain_launches"] > 0
    _assert_same_run(got, want)


def test_graft_clock_depends_on_the_backend(tdb, seqs):
    """The kernel path probes a one-member stage through the visibility-
    fused lens and charges only its visible matches; the NumPy engine
    charges every key match. Isolated sessions see every entry of their
    own states, so only folding moves the clock: the isolated runs' clocks
    and latencies are equal, their kernel counters not."""
    runs = {b: {mode: workload.run_closed_loop(tdb, mode, seqs, device="cpu", backend=b)
                for mode in ("isolated", "graft")} for b in ("reference", "torch")}
    ref, ker = runs["reference"]["graft"], runs["torch"]["graft"]
    assert ker["elapsed_s"] != ref["elapsed_s"]
    assert ref["counters"]["kernel_chain_launches"] == 0 < ker["counters"]["kernel_chain_launches"]
    assert ref["counters"]["kernel_lens_probes"] == 0 < ker["counters"]["kernel_lens_probes"]
    assert ker["counters"]["fused_vis_rows"] < ref["counters"]["fused_vis_rows"]
    iso_ref, iso_ker = runs["reference"]["isolated"], runs["torch"]["isolated"]
    for k in KEYS[:-1]:
        assert iso_ker[k] == iso_ref[k], (k, iso_ker[k], iso_ref[k])


def test_keep_results_by_client_and_position(tdb):
    seqs = workload.client_sequences(tdb, 4, 2, seed=SEED)
    out = workload.run_closed_loop(tdb, "graft", seqs, device="cpu", keep_results=True)
    assert sorted(out["results"]) == [(c, i) for c in range(4) for i in range(2)]
    for (c, i), (template, params, result) in out["results"].items():
        assert (template, params) == seqs[c][i]
        plan = queries.make_query(tdb, template, params).plan
        want = refexec.execute(tdb, plan)
        assert set(result) == set(want)
        for k in want:
            np.testing.assert_allclose(np.sort(np.asarray(result[k], np.float64)),
                                       np.sort(np.asarray(want[k], np.float64)), rtol=1e-9)
    assert "results" not in workload.run_closed_loop(tdb, "graft", seqs, device="cpu")


def test_cuda_without_a_card_raises(tdb, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seqs = workload.client_sequences(tdb, 2, 2, seed=SEED)
    for backend in ("torch", "reference"):
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            workload.run_closed_loop(tdb, "graft", seqs, backend=backend)
