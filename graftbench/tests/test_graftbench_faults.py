"""A run whose timed path is broken underneath comes out not correct, and
so does the control; a sound run comes out correct.

Each test drives a whole run of a cell (``harness.run_cell``) on the CPU,
past the harness's look for a card: the kernels' plain versions, the
tables at SF 0.01, a 4 s window, clients started 0.05 s apart. The faults
are planted in the program before the run, for each fault a cell of this
benchmark can have: a morsel step that leaves every state as it was, half
of each morsel left out, one answer altered where the engine makes it.
(One chip: there is no exchange between chips to leave out.)"""

import time

import numpy as np
import pytest

from graftbench import control, harness, traffic

CELLS = ["sf1-closed32", "sf1-closed1"]
SEED = 2**32 + 17


@pytest.fixture(autouse=True)
def fast_starts(monkeypatch):
    """Clients started 0.05 s apart, so that a 4 s window has them all."""
    load = traffic.load
    monkeypatch.setattr(traffic, "load", lambda name: dict(load(name), stagger_s=0.05))


def run(cell, trace=False):
    return harness.run_cell(cell, SEED, 4.0, trace, time.perf_counter(), device="cpu",
                            scale_factor=0.01)


def step_leaves_state_unchanged(monkeypatch):
    """Every morsel reaches the pipelines, which do none of its work."""
    import repro_torch.core.runtime as runtime

    monkeypatch.setattr(runtime.Pipeline, "_process_packed_fused", lambda self, *a, **k: 0.0)


def half_of_each_morsel(monkeypatch):
    import repro_torch.core.runtime as runtime

    process = runtime.Pipeline.process

    def half(self, engine, cols, row_ids, part=0):
        n = len(row_ids) // 2
        return process(self, engine, {k: v[:n] for k, v in cols.items()}, row_ids[:n], part)

    monkeypatch.setattr(runtime.Pipeline, "process", half)


def one_answer_altered(monkeypatch):
    import repro_torch.core.engine as engine

    order = engine._apply_orderby

    def altered(result, ob):
        out = order(result, ob)
        if out and len(next(iter(out.values()))):
            name = [k for k in out if k not in ob.keys][-1]
            col = out[name].copy()
            col[0] = col[0] * (1 + 1e-5) + 1e-3
            out = dict(out, **{name: col})
        return out

    monkeypatch.setattr(engine, "_apply_orderby", altered)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [step_leaves_state_unchanged, half_of_each_morsel,
                                   one_answer_altered])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    got = control.control_readings(cell, SEED, 40, scale_factor=0.01)
    assert got["fails"], got
    assert got["max_rel_err"] > 1e3 * 1e-12


def test_traced_run_reads_its_host_metrics():
    out = run("sf1-closed32", trace=True)
    assert out["correct"]
    names = set(out["metrics"])
    assert {"scan_rows_per_query", "represented_build_share", "morsel_host_ms",
            "backend_host_share", "chain_decline_share"} <= names
    assert np.isfinite([m["value"] for m in out["metrics"].values()]).all()
