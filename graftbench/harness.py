"""One run of one cell: set-up, the window, the check, the metrics.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``: the cell names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``);
each metric is a reader ``end_to_end/<name>.py`` or ``metrics/<name>.py``
with ``read(run) -> float | None`` over the ``Run`` record below. A reader
that finds nothing to read returns None and its metric is left out.

The program under test is ``graftdb_torch`` (the port, under ``src/``):
the run hands it the tables through ``database_from_numpy``, builds each
query with its ``queries.make_query`` and drives ``connect`` /
``Session.submit`` / ``Session.run``. The check after the window holds
every answer of the window against ``reference.tpch_queries``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from . import datagen, loops, traffic
from .compare import Checker
from .reference.tpch_queries import Reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SRC = ROOT / "src"


def log(msg: str) -> None:
    print(f"graftbench: {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_of(bench: Dict, workload: str) -> Dict:
    for c in bench["workloads"]:
        if c["name"] == workload:
            return c
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def reported(bench: Dict, cell: Dict, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` prints: its end-to-end metrics with
    ``--trace 0``, its per-layer ones with ``--trace 1``."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def applies(m: Dict) -> bool:
        return cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in names

    return [m for m in bench["per_layer"] if applies(m)]


def reader(kind: str, name: str) -> Callable:
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"graftbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What the readers read."""

    cell: Dict
    config: Dict
    traffic: Dict
    seconds: float
    setup_s: float = 0.0
    window: Optional[loops.Window] = None
    #: host seconds of the spans' and counters' window (hooks open to
    #: close, at the first completion at or past the window's close)
    traced_s: float = 0.0
    traced_until: Optional[float] = None  # host time of the hooks' close
    counters_open: Dict[str, float] = field(default_factory=dict)
    counters_close: Dict[str, float] = field(default_factory=dict)
    spans: Optional[Dict] = None  # spans.HostSpans.summary(), traced runs
    device: Optional[Dict] = None  # devtrace.DeviceTrace.stop(), traced runs

    def delta(self, name: str) -> float:
        return self.counters_close.get(name, 0.0) - self.counters_open.get(name, 0.0)

    @property
    def completed(self) -> List[loops.Request]:
        """The window's queries (sent before its close and running in it
        at any time) that completed by the end of the drain."""
        return [r for r in self.window.requests if r.done_at is not None]


class Hooks:
    """What happens as the window opens and closes: counter snapshots,
    and in a traced run the host spans and the device trace."""

    def __init__(self, session, run: Run, trace: bool, device: str):
        self.session = session
        self.run = run
        self.spans = self.devtrace = None
        if trace:
            from .devtrace import DeviceTrace
            from .spans import HostSpans

            self.spans = HostSpans()
            if device == "cuda":
                self.devtrace = DeviceTrace()
        self.opened_at = self.closed_at = None

    def open(self) -> None:
        if self.devtrace is not None:
            self.devtrace.start()
        if self.spans is not None:
            self.spans.open()
        self.run.counters_open = dict(self.session.counters)
        self.opened_at = time.perf_counter()

    def close(self) -> None:
        self.closed_at = time.perf_counter()
        self.run.counters_close = dict(self.session.counters)
        self.run.traced_s = self.closed_at - self.opened_at
        self.run.traced_until = self.closed_at
        if self.spans is not None:
            self.spans.close()
            self.run.spans = self.spans.summary()
            self.run.spans["intervals"] = self.spans.intervals
        if self.devtrace is not None:
            self.run.device = self.devtrace.stop()
            sp = self.run.spans
            log(f"traced: {self.run.traced_s:.3f} s; Pipeline.process {sp['process_calls']} calls "
                f"{sp['process_s']:.3f} s, backend calls inside {sp['backend_in_process_s']:.3f} s; "
                f"backend {sp['backend_calls']} calls {sp['backend_s']:.3f} s; wrapper calls "
                f"{sp['kernel_calls']}, device launches {self.run.device['engine_launches']}, "
                f"device s {self.run.device['engine_s']}")

    def uninstall(self) -> None:
        if self.spans is not None:
            self.spans.uninstall()


def load_kernels() -> None:
    """Build (first run in a checkout only) and load the engine's CUDA
    kernels, into the port's fixed build directory in the checkout."""
    from repro_torch.kernels import _build

    stems = ("hash_probe", "fused_chain")
    _build.build(stems)
    for stem in stems:
        _build.load(stem)


@dataclass
class Cell:
    """A cell's files and inputs: its entry in ``BENCHMARK.json``, its
    configuration and mix, the tables made from the seed, and the same
    tables handed to the program."""

    bench: Dict
    cell: Dict
    config: Dict
    mix: Dict
    tables: datagen.Tables
    db: object
    device: str


def open_cell(workload: str, seed: int, t_start: float, device: str = "cuda",
              scale_factor: Optional[float] = None) -> Cell:
    """Everything before the session. For the harness's own tests:
    ``device="cpu"`` runs the kernels' plain versions, ``scale_factor``
    shrinks the tables."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    bench = benchmark()
    cell = cell_of(bench, workload)
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = traffic.load(cell["traffic"])
    sf = float(config["scale_factor"] if scale_factor is None else scale_factor)
    tables = datagen.generate(sf, seed)
    log(f"tables at SF {sf}: {datagen.nbytes(tables)} bytes, {time.perf_counter() - t_start:.3f} s from start")

    import torch

    from repro_torch.relational.table import database_from_numpy

    db = database_from_numpy(tables, sf)
    if device == "cuda":
        torch.cuda.init()
        load_kernels()
        log(f"CUDA and kernels ready, {time.perf_counter() - t_start:.3f} s from start")
    return Cell(bench, cell, config, mix, tables, db, device)


def drive(c: Cell, seed: int, seconds: float, trace: bool, t_start: float) -> Run:
    """Open a session, run the cell's mix through its window, close the
    session."""
    import graftdb_torch
    from repro_torch.relational import queries

    mix = c.mix
    run = Run(cell=c.cell, config=c.config, traffic=mix, seconds=seconds)
    session = graftdb_torch.connect(c.db, graftdb_torch.EngineConfig(**dict(c.config["engine"], device=c.device)))
    hooks = Hooks(session, run, trace, c.device)

    def build(template, params, arrival):
        return queries.make_query(c.db, template, params, arrival=arrival)

    stream = traffic.instances(mix, c.config["templates"], seed)
    try:
        run.window = loops.closed_loop(session, build, stream, int(mix["clients"]),
                                       float(mix["stagger_s"]), seconds, float(mix["drain_s"]),
                                       hooks)
    finally:
        hooks.uninstall()
        session.close()
    run.setup_s = hooks.opened_at - t_start
    log(f"window {run.window.seconds:.3f} s opened {run.setup_s:.3f} s from start, after "
        f"{run.window.completed_before} completions; {len(run.window.requests)} window queries; "
        f"loop ended {time.perf_counter() - hooks.opened_at:.3f} s after the open")
    done = [r.done_at - run.window.open_at for r in run.completed
            if run.window.open_at <= r.done_at < run.window.close_at]
    bins = np.bincount(np.clip(np.array(done, dtype=int) // 5, 0, None), minlength=1) if done else []
    life = [r.done_at - r.arrival for r in run.completed]
    log(f"completions per 5 s of the window: {list(map(int, bins))} ({len(done)} in all); "
        f"lifetimes of the window's queries {min(life, default=0):.3f}-{max(life, default=0):.3f} s; "
        f"templates: {dict(sorted(Counter(r.template for r in run.completed).items()))}")
    return run


def check(c: Cell, run: Run) -> Dict:
    """Every answer of the window against the reference: the checks."""
    answers = [(r.template, r.params, r.future.result()) for r in run.completed]
    limits = c.config["limits"]
    checker = Checker(Reference(c.tables), tie=float(limits["max_rel_err"]))
    t_ref = time.perf_counter()
    for template, params, got in answers:
        checker.check(template, params, got)
    log(f"reference: {checker.checked} answers, {len(checker._answers)} distinct, "
        f"{time.perf_counter() - t_ref:.3f} s")
    return {
        "max_rel_err": {"value": checker.max_rel_err, "limit": float(limits["max_rel_err"])},
        "wrong_rows": {"value": checker.wrong_rows, "limit": int(limits["wrong_rows"])},
        "never_done": {"value": len(run.window.requests) - len(answers),
                       "limit": int(limits["never_done"])},
    }


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", scale_factor: Optional[float] = None) -> Dict:
    """One run; returns the result line's object (without printing). The
    keywords after ``t_start`` are for the harness's own tests on the CPU
    (``open_cell``)."""
    import torch

    c = open_cell(workload, seed, t_start, device, scale_factor)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    run = drive(c, seed, seconds, trace, t_start)
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = check(c, run)
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    metrics = {}
    for m in reported(c.bench, c.cell, trace):
        value = reader("metrics" if trace else "end_to_end", m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {
        "platform": "gpu" if device == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(memory_peak),
    }
    out = {
        "correct": bool(correct),
        "attempted": len(run.window.requests),
        "failed": checks["never_done"]["value"],
        "metrics": metrics,
        "device": dev,
    }
    if trace and run.device is not None:
        dev["busy_s"] = run.device["busy_s"]
        dev["window_s"] = run.device["window_s"]
        out["breakdown"] = breakdown(run)
    out["checks"] = checks
    return out


def breakdown(run: Run) -> Dict:
    """The device operations that took most time, and the longest idle
    gaps of the device named by what the host was doing through most of
    each: the morsel pipeline's own NumPy work, a backend call, or the rest
    (scheduler, grafting, admission, the harness)."""
    ops = sorted(run.device["by_name"].items(), key=lambda kv: -kv[1])[:10]
    kinds = {k: sorted((s0, s1) for s0, s1, kind in run.spans["intervals"] if kind == k)
             for k in ("pipeline", "backend")}
    out = []
    for a, b in sorted(run.device["gaps"], key=lambda g: g[0] - g[1])[:10]:
        cover = {k: _overlap(v, a, b) for k, v in kinds.items()}
        cover["pipeline"] -= cover["backend"]  # backend calls run inside the pipeline's
        cover["other"] = (b - a) - cover["pipeline"] - cover["backend"]
        out.append(["host_" + max(cover, key=cover.get), b - a])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": out}


def _overlap(intervals, a: float, b: float) -> float:
    """Seconds of [a, b] covered by sorted, disjoint intervals."""
    starts = [s for s, _ in intervals]
    i = max(int(np.searchsorted(starts, a)) - 1, 0)
    total = 0.0
    for s0, s1 in intervals[i:]:
        if s0 >= b:
            break
        total += max(0.0, min(s1, b) - max(s0, a))
    return total
