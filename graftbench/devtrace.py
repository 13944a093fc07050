"""The device's side of a traced window, from ``torch.profiler``.

``DeviceTrace.start`` opens a CUDA-only profiler trace (CUPTI activity
records: kernels, copies and sets) and launches one marker kernel at a
known host time, which ties the trace's clock to the host's
``perf_counter``; ``stop`` closes it and reduces the events in the process
(no trace file is written) to:

* ``busy_s``: the union of all device intervals (an operation running);
* ``window_s``: host seconds from ``start`` to ``stop``;
* device seconds by operation name, and of the engine's kernels B1-B4;
* the idle gaps between device intervals, on the host's clock.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

#: name fragments of the engine kernels' CUDA functions (``csrc/*.cu``)
ENGINE_KERNELS = {
    "chain_kernel": "B1",
    "probe_lens64_kernel": "B2",
    "probe_multi64_kernel": "B3",
    "probe_lens_kernel": "B4",
}


def engine_kernel(name: str) -> Optional[str]:
    for frag, label in ENGINE_KERNELS.items():
        if frag in name:
            return label
    return None


def short_name(name: str) -> str:
    """A kernel's name without its argument list (copies and sets whole)."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    return name.split("(")[0].strip()[:120]


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, start, end = 0.0, None, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    return total + (end - start if end is not None else 0.0)


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """Stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self.host_start = self.host_stop = self.host_mark = 0.0

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.start()
        self.host_start = time.perf_counter()
        torch.cuda.synchronize()
        self.host_mark = time.perf_counter()
        torch.zeros(1, device="cuda")  # the marker: the trace's first device interval
        torch.cuda.synchronize()

    def stop(self) -> Dict:
        import torch

        torch.cuda.synchronize()
        self.host_stop = time.perf_counter()
        self._prof.stop()
        events = [e for e in self._prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        self._prof = None
        if not events:
            raise RuntimeError("the profiler recorded no device operation in the window")
        first = min(e.time_range.start for e in events)
        shift = self.host_mark - first * 1e-6  # device microseconds -> host seconds
        intervals, by_name, engine = [], {}, {}
        engine_launches: Dict[str, int] = {}
        for e in events:
            a = e.time_range.start * 1e-6 + shift
            b = e.time_range.end * 1e-6 + shift
            intervals.append((a, b))
            key = short_name(e.name)
            by_name[key] = by_name.get(key, 0.0) + (b - a)
            label = engine_kernel(e.name)
            if label is not None:
                engine[label] = engine.get(label, 0.0) + (b - a)
                engine_launches[label] = engine_launches.get(label, 0) + 1
        return {
            "busy_s": union_seconds(intervals),
            "window_s": self.host_stop - self.host_start,
            "by_name": by_name,
            "engine_s": engine,
            "engine_launches": engine_launches,
            "gaps": gaps(intervals, self.host_start, self.host_stop),
        }
