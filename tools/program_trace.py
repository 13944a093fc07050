"""One traced run of a benchmark cell with the program's own tracer on or
off, and the breakdown that its spans and copy counters give.

    python3 tools/program_trace.py --workload sf1-closed1 --seed 7 --seconds 51 \\
        --program 1 --out closed1.json
    python3 tools/program_trace.py --site-cost

from the repository root, on a machine with a CUDA card. The run is the
benchmark's own traced run (``python3 -m graftbench.run --trace 1``: its
host spans and device trace); with ``--program 1`` it also starts
``Session.start_trace()`` as the window opens and stops it as the window
closes, and reads the program's metrics (``graftbench/metrics``) from the
trace. It writes one JSON object: the run's result line, the new metrics,
``throughput_qph`` of the window, self and total seconds by span name, the
three morsel phases by members per morsel, the cross-checks against the
benchmark's own spans, the longest idle gaps of the card with the
innermost program span open through most of each, and the program's copy
counts beside the profiler's memcpy events. ``--site-cost`` times a span
site with no trace running, in ns, on the host's CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

NEW_METRICS = ("morsel_filter_ms", "morsel_probe_ms", "morsel_sink_ms", "backend_table_share",
               "backend_fallback_share", "copy_bytes_per_query", "scheduler_host_share")
PHASES = ("morsel.filter", "morsel.probe", "morsel.sink")
MEMBER_BINS = ((1, 1), (2, 4), (5, 16), (17, 64))


def site_cost_ns(n: int = 2_000_000, repeats: int = 7) -> dict:
    """ns per span site (one read of ``trace.active``, one branch) with no
    trace running: the best of ``repeats`` loops with the site less the
    best of as many empty loops."""
    from repro_torch.core import trace

    assert trace.active is None

    def with_site():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            tr = trace.active
            if tr is not None:
                tr.open("x")
        return time.perf_counter_ns() - t0

    def bare():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            pass
        return time.perf_counter_ns() - t0

    def span_on():
        trace.start()
        tr = trace.active
        t0 = time.perf_counter_ns()
        for _ in range(n // 10):
            tr = trace.active
            if tr is not None:
                span = tr.open("x", 1)
            if tr is not None:
                tr.close(span)
        took = time.perf_counter_ns() - t0
        trace.stop()
        return took

    site = min(with_site() for _ in range(repeats))
    empty = min(bare() for _ in range(repeats))
    on = min(span_on() for _ in range(repeats))
    return {"site_ns": (site - empty) / n, "loop_ns": empty / n, "n": n,
            "span_on_ns": on / (n // 10) - empty / n}


def member_phases(records) -> list:
    """Mean self ms of each morsel phase by the morsel's member count."""
    import numpy as np

    name = np.array(records["name"])
    parent, tag, own = records["parent"], records["tag"], records["self"]
    morsel = np.flatnonzero(name == "morsel")
    out = []
    for lo, hi in MEMBER_BINS:
        sel = morsel[(tag[morsel] >= lo) & (tag[morsel] <= hi)]
        if not len(sel):
            continue
        row = {"members": f"{lo}-{hi}", "morsels": int(len(sel)),
               "morsel_self_ms": float(own[sel].mean() * 1e3)}
        inbin = np.zeros(len(name), dtype=bool)
        inbin[sel] = True
        for ph in PHASES:
            kids = np.flatnonzero((name == ph) & (parent >= 0))
            kids = kids[inbin[parent[kids]]]
            row[ph] = float(own[kids].sum() / len(sel) * 1e3)
        out.append(row)
    return out


def sink_split(records) -> dict:
    """Self seconds and calls of ``morsel.sink`` split by whether a
    ``backend.segment_sum`` ran inside it (aggregate sinks that received
    rows) or not (build sinks, and sinks that received none)."""
    import numpy as np

    name = np.array(records["name"])
    parent, own = records["parent"], records["self"]
    sink = name == "morsel.sink"
    agg = np.zeros(len(name), dtype=bool)
    seg = np.flatnonzero((name == "backend.segment_sum") & (parent >= 0))
    agg[parent[seg]] = True
    out = {}
    for label, sel in (("with_segment_sum", sink & agg), ("without", sink & ~agg)):
        out[label] = {"calls": int(sel.sum()), "self_s": float(own[sel].sum())}
    return out


def traced_run(workload: str, seed: int, seconds: float, with_program: bool,
               device: str = "cuda", scale_factor=None) -> dict:
    cache = ROOT / "build" / "graftbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    import torch

    from graftbench import devtrace, harness, program

    got = {}

    class CountingTrace(devtrace.DeviceTrace):
        """The benchmark's device trace, keeping its memcpy events."""

        def stop(self):
            prof, events = self._prof, self._prof.events

            def keep():
                out = events()
                got["events"] = [e for e in out
                                 if e.device_type == torch.autograd.DeviceType.CUDA]
                return out

            prof.events = keep
            got["host_mark"] = self.host_mark
            return super().stop()

    class Hooks(harness.Hooks):
        def open(self):
            super().open()
            if with_program:
                self.session.start_trace()
                got["program_open"] = time.perf_counter()

        def close(self):
            if with_program:
                got["program_close"] = time.perf_counter()
                tr = self.session.stop_trace()
                self.run.program = dict(tr.summary(), records={
                    "name": tr.name, "start": tr.start, "end": tr.end, "parent": tr.parent,
                    "tag": tr.tag, "self": tr.self_time})
            super().close()

    drive = harness.drive

    def keep_run(*a, **kw):
        got["run"] = drive(*a, **kw)
        return got["run"]

    devtrace.DeviceTrace = CountingTrace
    harness.Hooks = Hooks
    harness.drive = keep_run
    out = harness.run_cell(workload, seed, seconds, True, T_START, device, scale_factor)
    run = got["run"]
    rep = {"workload": workload, "seed": seed, "program": with_program, "result": out,
           "throughput_qph": harness.reader("end_to_end", "throughput_qph")(run),
           "setup_s": run.setup_s, "traced_s": run.traced_s,
           "host_spans": {k: v for k, v in run.spans.items() if k != "intervals"}}

    # the profiler's copies, in the device window and inside the program's,
    # on the host's clock as devtrace puts them (its marker is the first event)
    ev = got.get("events", [])
    shift = 0.0 if not ev else got["host_mark"] - min(e.time_range.start for e in ev) * 1e-6
    lo, hi = got.get("program_open", -1.0), got.get("program_close", -1.0)
    copies = {"h2d_events": 0, "d2h_events": 0, "h2d_events_in_program": 0,
              "d2h_events_in_program": 0, "other_memcpy": {}}
    for e in ev:
        if not e.name.startswith("Memcpy"):
            continue
        kind = "h2d" if "HtoD" in e.name else "d2h" if "DtoH" in e.name else None
        if kind is None:
            copies["other_memcpy"][e.name] = copies["other_memcpy"].get(e.name, 0) + 1
            continue
        copies[f"{kind}_events"] += 1
        if lo <= e.time_range.start * 1e-6 + shift <= hi:
            copies[f"{kind}_events_in_program"] += 1
    rep["copies"] = copies

    if with_program:
        p = run.program
        new = {m: harness.reader("metrics", m)(run) for m in NEW_METRICS}
        rep["new_metrics"] = new
        rep["spans"] = {n: {"calls": p["calls"][n], "self_s": p["self_s"][n],
                            "total_s": p["total_s"][n]} for n in sorted(p["calls"])}
        rep["counters"] = p["counters"]
        copies["program_h2d_copies"] = p["counters"]["h2d_copies"]
        copies["program_d2h_copies"] = p["counters"]["d2h_copies"]
        mh = out["metrics"].get("morsel_host_ms", {}).get("value")
        phases = sum(new[m] for m in ("morsel_filter_ms", "morsel_probe_ms", "morsel_sink_ms"))
        outer = sum(p["total_s"].get(n, 0.0) for n in program.BACKEND_SPANS)
        bshare = out["metrics"].get("backend_host_share", {}).get("value")
        rep["checks"] = {
            "phases_ms": phases, "morsel_host_ms": mh,
            "phases_over_morsel_host": phases / mh if mh else None,
            "backend_outer_s": outer, "backend_host_s": run.spans["backend_s"],
            "backend_outer_over_host": outer / run.spans["backend_s"] if run.spans["backend_s"] else None,
            "table_plus_fallback_share": new["backend_table_share"] + new["backend_fallback_share"],
            "backend_host_share": bshare,
            "program_window_s": hi - lo,
        }
        rep["members"] = member_phases(p["records"])
        rep["sinks"] = sink_split(p["records"])
        rep["spans_recorded"] = len(p["records"]["name"])
        gaps = sorted(run.device["gaps"] if run.device else [], key=lambda g: g[0] - g[1])[:10]
        # each: seconds, innermost span name, its share, start from the program's open
        rep["gaps"] = [[b - a, *program.innermost_over(p["records"], a, b), a - lo]
                       for a, b in gaps]
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out")
    ap.add_argument("--site-cost", action="store_true")
    # a smoke run on the CPU at a small scale: no device trace
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale-factor", type=float)
    args = ap.parse_args(argv)
    if args.site_cost:
        rep = site_cost_ns()
    else:
        rep = traced_run(args.workload, args.seed, args.seconds, bool(args.program),
                         args.device, args.scale_factor)
    text = json.dumps(rep, default=float)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    short = {k: v for k, v in rep.items() if k not in ("spans", "result", "host_spans")}
    print(json.dumps(short, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
