"""The metric arithmetic on made-up inputs."""

import numpy as np
import pytest

from graftbench import devtrace, kernel_bytes, readings
from graftbench.harness import Run, reader
from graftbench.loops import Request, Window


def test_union_and_gaps_of_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert devtrace.union_seconds(iv) == pytest.approx(3.0)
    assert devtrace.union_seconds([]) == 0.0
    assert devtrace.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert devtrace.engine_kernel("void chain_kernel<224>(ChainArgs<224>)") == "B1"
    assert devtrace.engine_kernel("probe_lens64_kernel(int const*)") == "B2"
    assert devtrace.engine_kernel("probe_multi64_kernel(int const*)") == "B3"
    assert devtrace.engine_kernel("probe_lens_kernel(int const*)") == "B4"
    assert devtrace.engine_kernel("probe_multi_kernel(int const*)") is None


def make_run():
    win = Window(open_at=10.0, close_at=20.0)
    win.requests = [Request("q1", {}, 10.0 + i, done_at=11.0 + 2 * i) for i in range(5)]
    win.requests.append(Request("q3", {}, 15.5))  # never done
    run = Run(cell={"name": "x"}, config={}, traffic={"loop": "closed"}, seconds=10.0, window=win)
    run.counters_open = {"scan_rows": 100.0, "represented_rows": 10.0, "residual_build_rows": 0.0,
                         "ordinary_build_rows": 10.0, "queued_admissions": 2.0,
                         "queue_delay_s_total": 1.0, "kernel_chain_launches": 5.0,
                         "fallback_probes_capacity": 1.0}
    run.counters_close = {"scan_rows": 600.0, "represented_rows": 40.0, "residual_build_rows": 5.0,
                          "ordinary_build_rows": 25.0, "queued_admissions": 6.0,
                          "queue_delay_s_total": 3.0, "kernel_chain_launches": 11.0,
                          "fallback_probes_capacity": 3.0, "fallback_probes_grants": 2.0}
    run.traced_s = 10.0
    run.spans = {"process_calls": 4, "process_s": 2.0, "backend_in_process_s": 1.0,
                 "backend_s": 1.5, "kernel_bytes": {"chain_launch": 3.35e6}}
    run.device = {"busy_s": 0.5, "window_s": 10.0, "engine_s": {"B1": 0.001, "B2": 0.001}}
    return run


def test_window_deltas_and_shares():
    run = make_run()
    assert run.delta("scan_rows") == 500.0
    assert reader("metrics", "scan_rows_per_query")(run) == 100.0  # 5 completed
    assert reader("metrics", "represented_build_share")(run) == pytest.approx(100 * 30 / 50)
    assert reader("metrics", "chain_decline_share")(run) == pytest.approx(100 * 4 / 10)
    assert reader("metrics", "morsel_host_ms")(run) == pytest.approx(250.0)
    assert reader("metrics", "backend_host_share")(run) == pytest.approx(15.0)
    assert reader("metrics", "device_idle_share")(run) == pytest.approx(95.0)
    # 3.35 MB over 3.35 TB/s is 1 us, against 2 ms of device time
    assert reader("metrics", "engine_kernels_roofline")(run) == pytest.approx(0.05)
    assert reader("end_to_end", "throughput_qph")(run) == pytest.approx(5 * 3600 / 10.0)


def test_window_work_counts_shares_inside_the_span():
    win = Window(open_at=10.0, close_at=20.0)
    win.requests = [Request("q1", {}, 5.0, done_at=15.0),   # half inside
                    Request("q1", {}, 12.0, done_at=14.0),  # whole
                    Request("q1", {}, 18.0, done_at=26.0),  # a quarter by the close
                    Request("q3", {}, 19.0)]                # never done: no share
    run = Run(cell={"name": "x"}, config={}, traffic={}, seconds=10.0, window=win)
    assert readings.window_work(run) == pytest.approx(1.75)
    assert reader("end_to_end", "throughput_qph")(run) == pytest.approx(1.75 * 360)
    # the counters closed at the first completion past the close, 22 s
    run.traced_until = 22.0
    assert readings.window_work(run, 22.0) == pytest.approx(2.0)
    run.counters_open, run.counters_close = {"scan_rows": 0.0}, {"scan_rows": 600.0}
    assert reader("metrics", "scan_rows_per_query")(run) == pytest.approx(300.0)


def test_readers_find_nothing_without_a_trace():
    run = make_run()
    run.spans = run.device = None
    for name in ("morsel_host_ms", "backend_host_share", "engine_kernels_roofline",
                 "device_idle_share"):
        assert reader("metrics", name)(run) is None


def test_kernel_bytes_from_the_arguments():
    torch = pytest.importorskip("torch")
    keys = torch.zeros(1024, dtype=torch.int32)
    assert kernel_bytes.count("hash_probe_lens64", (keys,), None) == 3 * 4 * 1024
    assert kernel_bytes.count("hash_probe_lens", (keys,), None) == 3 * 4 * 1024
    assert kernel_bytes.count("hash_probe_lens_multi64", (keys,), None) == 5 * 4 * 1024
    # one stage, keys from the rows, no grants or filter, no sink
    spec = (((-1, 0, 0, None),), False)
    rows = [torch.zeros(1024, dtype=torch.int32) for _ in range(3)]
    table = torch.zeros(1 << 20, dtype=torch.int32)  # a table: read by the home-slot word
    small = torch.zeros(8 * 256, dtype=torch.int32)  # a lens table: read whole
    arrays = rows + [table, table, table, table, small, small]
    out = torch.zeros(5 * 1024, dtype=torch.int32)
    want = 3 * 4096 + 2 * 8192 + 4 * 5 * 1024 + 1 * 1024 * 4
    assert kernel_bytes.count("chain_launch", (spec, arrays), out) == want
