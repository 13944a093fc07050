"""The readers of the program's own trace (``run.program``) on made-up
inputs, and each reads None without it."""

import numpy as np
import pytest

from graftbench import program
from graftbench.harness import Run, reader
from graftbench.loops import Request, Window

READERS = ("morsel_filter_ms", "morsel_probe_ms", "morsel_sink_ms", "backend_table_share",
           "backend_fallback_share", "copy_bytes_per_query", "scheduler_host_share")


def make_run():
    win = Window(open_at=10.0, close_at=20.0)
    win.requests = [Request("q1", {}, 10.0 + i, done_at=11.0 + 2 * i) for i in range(5)]
    run = Run(cell={"name": "x"}, config={}, traffic={}, seconds=10.0, window=win)
    run.traced_s = 10.0
    run.traced_until = 20.0  # five queries' worth of work by then
    run.program = {
        "calls": {"morsel": 4, "morsel.filter": 4, "morsel.probe": 4, "morsel.sink": 4},
        "self_s": {"morsel": 0.1, "morsel.filter": 0.2, "morsel.probe": 0.4, "morsel.sink": 0.08,
                   "scheduler.step": 0.5, "engine.submit": 0.3, "engine.complete": 0.2,
                   "backend.table": 0.25},
        "total_s": {"backend.table": 0.5, "backend.fallback": 1.5, "scheduler.step": 9.0},
        "counters": {"h2d_bytes": 600, "d2h_bytes": 400, "h2d_copies": 3, "d2h_copies": 2},
    }
    return run


def test_readers_of_the_program_trace():
    run = make_run()
    assert reader("metrics", "morsel_filter_ms")(run) == pytest.approx(50.0)
    assert reader("metrics", "morsel_probe_ms")(run) == pytest.approx(100.0)
    assert reader("metrics", "morsel_sink_ms")(run) == pytest.approx(20.0)
    assert reader("metrics", "backend_table_share")(run) == pytest.approx(5.0)  # total, not self
    assert reader("metrics", "backend_fallback_share")(run) == pytest.approx(15.0)
    assert reader("metrics", "copy_bytes_per_query")(run) == pytest.approx(1000 / 5)
    assert reader("metrics", "scheduler_host_share")(run) == pytest.approx(10.0)  # self times


@pytest.mark.parametrize("name", READERS)
def test_program_readers_read_none_without_a_trace(name):
    run = make_run()
    run.program = None
    assert reader("metrics", name)(run) is None
    del run.program  # a harness whose Run has no such field
    assert reader("metrics", name)(run) is None


def test_no_morsel_and_no_window_read_none():
    run = make_run()
    run.program["calls"] = {}
    assert reader("metrics", "morsel_probe_ms")(run) is None
    run.traced_s = 0.0
    assert reader("metrics", "backend_table_share")(run) is None


def test_innermost_span_over_a_gap():
    # a step holding a morsel, whose probe holds a backend call, then a
    # second step
    rec = {"name": ["scheduler.step", "morsel", "morsel.probe", "backend.probe",
                    "scheduler.step"],
           "start": np.array([0.0, 1.0, 2.0, 2.5, 10.0]),
           "end": np.array([10.0, 9.0, 6.0, 2.6, 10.5]),
           "parent": np.array([-1, 0, 1, 2, -1])}
    name, share = program.innermost_over(rec, 2.0, 5.0)
    assert name == "morsel.probe" and share == pytest.approx(2.9 / 3)
    name, share = program.innermost_over(rec, 1.0, 9.0)  # the probe 3.9 s, the morsel 4 s
    assert name == "morsel" and share == pytest.approx(0.5)
    name, share = program.innermost_over(rec, 9.0, 12.5)  # the steps 1.5 s, nothing 2 s
    assert name is None and share == pytest.approx(2.0 / 3.5)
    name, share = program.innermost_over(rec, 8.5, 10.5)  # steps 1.5 s, morsel 0.5 s
    assert name == "scheduler.step" and share == pytest.approx(0.75)
