"""The program's own tracer: host spans and host<->device copy counters.

One trace may run per process, between ``start()`` and ``stop()``
(``Session.start_trace`` / ``Session.stop_trace``). While it runs, the
engine records a span at each layer boundary where its host work happens
(scheduler step, query install and completion, scan morsel, the morsel
pipeline's filter, probe and sink phases, the backend's calls, table
upkeep, declined probes and waits) and counts every host<->device copy the
backend makes, in logical bytes.

A span record is ``(name, start, end, parent, tag)``: ``start`` and ``end``
on ``time.perf_counter``'s clock (read in integer nanoseconds, so self
times are exact), ``parent`` the index of the enclosing span (-1 when it
was opened before the trace started), ``tag`` one int (a query id, a
member count or a row count). Records live in flat append-only lists; a
span still open at ``stop()`` is left out.

A site costs one read of ``active`` and one branch when no trace runs::

    tr = trace.active
    if tr is not None:
        span = tr.open("morsel.sink", n)
    ...
    if tr is not None:
        tr.close(span)

Closing a span also closes whatever an exception left open inside it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

#: the clock every span reads (``time.perf_counter`` in nanoseconds)
_clock = time.perf_counter_ns

COUNTERS = ("h2d_bytes", "d2h_bytes", "h2d_copies", "d2h_copies")

#: the running tracer, or None
active: Optional["Tracer"] = None


class Tracer:
    """The records of the running trace; sites call ``open``/``close`` and
    ``h2d``/``d2h``."""

    __slots__ = ("names", "starts", "ends", "parents", "tags", "counters", "_stack")

    def __init__(self):
        self.names: List[str] = []
        self.starts: List[int] = []
        self.ends: List[int] = []  # -1 while open
        self.parents: List[int] = []
        self.tags: List[int] = []
        self.counters: Dict[str, int] = dict.fromkeys(COUNTERS, 0)
        self._stack: List[int] = []  # open spans, innermost last

    def open(self, name: str, tag: int = 0) -> int:
        i = len(self.names)
        self.names.append(name)
        self.parents.append(self._stack[-1] if self._stack else -1)
        self.tags.append(tag)
        self.ends.append(-1)
        self._stack.append(i)
        self.starts.append(_clock())
        return i

    def tag(self, i: int, tag: int) -> None:
        """Set span ``i``'s tag once the site knows it."""
        self.tags[i] = tag

    def close(self, i: int) -> None:
        self.ends[i] = _clock()
        stack = self._stack
        while stack and stack.pop() != i:
            pass

    def h2d(self, nbytes: int) -> None:
        if nbytes > 0:
            c = self.counters
            c["h2d_bytes"] += int(nbytes)
            c["h2d_copies"] += 1

    def d2h(self, nbytes: int) -> None:
        if nbytes > 0:
            c = self.counters
            c["d2h_bytes"] += int(nbytes)
            c["d2h_copies"] += 1


@dataclass(frozen=True)
class Trace:
    """A stopped trace: the closed spans as columns (``start``/``end`` in
    seconds on ``time.perf_counter``'s clock, ``parent`` indexing these
    columns or -1), their self seconds (duration less the durations of
    their direct children) and totals by name, calls by name, and the copy
    counters."""

    name: List[str]
    start: np.ndarray
    end: np.ndarray
    parent: np.ndarray
    tag: np.ndarray
    self_time: np.ndarray
    self_s: Dict[str, float]
    total_s: Dict[str, float]
    calls: Dict[str, int]
    counters: Dict[str, int]

    def __len__(self) -> int:
        return len(self.name)

    def summary(self) -> Dict[str, Dict]:
        """Self and total seconds, calls by name, and the counters."""
        return {"self_s": dict(self.self_s), "total_s": dict(self.total_s),
                "calls": dict(self.calls), "counters": dict(self.counters)}

    @classmethod
    def of(cls, tr: Tracer) -> "Trace":
        n = len(tr.ends)
        ends = np.array(tr.ends[:n], dtype=np.int64)
        starts = np.array(tr.starts[:n], dtype=np.int64)
        parents = np.array(tr.parents[:n], dtype=np.int64)
        keep = ends >= 0
        index = np.cumsum(keep) - 1  # old index -> new, for kept spans
        has_parent = parents >= 0
        has_parent[has_parent] = keep[parents[has_parent]]
        parents = np.where(has_parent, index[np.maximum(parents, 0)], -1)[keep]
        names = [m for m, k in zip(tr.names, keep.tolist()) if k]
        dur = (ends - starts)[keep]
        inner = np.zeros(len(dur), dtype=np.int64)
        np.add.at(inner, parents[parents >= 0], dur[parents >= 0])
        own = dur - inner
        self_s: Dict[str, float] = {}
        total_s: Dict[str, float] = {}
        calls: Dict[str, int] = {}
        for m, d, o in zip(names, dur.tolist(), own.tolist()):
            self_s[m] = self_s.get(m, 0) + o
            total_s[m] = total_s.get(m, 0) + d
            calls[m] = calls.get(m, 0) + 1
        return cls(
            name=names,
            start=starts[keep] / 1e9,
            end=ends[keep] / 1e9,
            parent=parents,
            tag=np.array(tr.tags[:n], dtype=np.int64)[keep],
            self_time=own / 1e9,
            self_s={m: v / 1e9 for m, v in self_s.items()},
            total_s={m: v / 1e9 for m, v in total_s.items()},
            calls=calls,
            counters=dict(tr.counters),
        )


def start() -> None:
    global active
    if active is not None:
        raise RuntimeError("a trace is already running in this process")
    active = Tracer()


def stop() -> Trace:
    global active
    tr = active
    if tr is None:
        raise RuntimeError("no trace is running")
    active = None
    return Trace.of(tr)
