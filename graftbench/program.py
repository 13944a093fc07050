"""Arithmetic on the program's own trace, for the readers of its spans and
counters.

A traced run carries it as ``run.program``: the summary of
``Session.stop_trace()`` (``Trace.summary()``: self and total seconds and
calls by span name, the copy counters) and, under ``"records"``, the
spans themselves as columns (``name``, ``start``, ``end``, ``parent``,
``tag``; times on the host's ``perf_counter``). A run without it (an
untraced run, or a program without the tracer) reads None everywhere.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np

#: the backend's engine calls, each traced where it is outermost
BACKEND_SPANS = ("backend.probe_chain", "backend.probe_visible", "backend.probe",
                 "backend.probe_visible_multi", "backend.segment_sum")


def program(run) -> Optional[Dict]:
    return getattr(run, "program", None) or None


def per_morsel_ms(run, name: str) -> Optional[float]:
    """Self ms of span ``name`` per ``morsel`` span (one
    ``Pipeline.process`` call)."""
    p = program(run)
    if p is None or not p["calls"].get("morsel"):
        return None
    return 1e3 * p["self_s"].get(name, 0.0) / p["calls"]["morsel"]


def window_share(run, names: Iterable[str], kind: str = "total_s") -> Optional[float]:
    """Seconds of the spans ``names`` (their totals, or with ``kind=
    "self_s"`` their self times) as a share of the traced window."""
    p = program(run)
    if p is None or run.traced_s <= 0:
        return None
    return 100.0 * sum(p[kind].get(n, 0.0) for n in names) / run.traced_s


def innermost_over(records: Dict, a: float, b: float) -> Tuple[Optional[str], float]:
    """The span name that is innermost through most of [a, b], and the
    share of [a, b] it covers; (None, share) when no span is open through
    most of it. A span is innermost where none of its children is open, so
    its part of [a, b] is its overlap less its direct children's."""
    start, end = np.asarray(records["start"]), np.asarray(records["end"])
    parent = np.asarray(records["parent"])
    ov = np.clip(np.minimum(end, b) - np.maximum(start, a), 0.0, None)
    has = parent >= 0
    own = ov - np.bincount(parent[has], weights=ov[has], minlength=len(ov))
    by_name: Dict[str, float] = {}
    for i in np.flatnonzero(ov > 0):
        name = records["name"][i]
        by_name[name] = by_name.get(name, 0.0) + float(own[i])
    uncovered = (b - a) - float(ov[~has].sum())
    if not by_name or max(by_name.values()) < uncovered:
        return None, uncovered / (b - a)
    best = max(by_name, key=by_name.get)
    return best, by_name[best] / (b - a)
