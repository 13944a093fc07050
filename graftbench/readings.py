"""Arithmetic the metric readers share: the window's work, and the traced
window's shares."""

from __future__ import annotations

from typing import Optional

from .peaks import H100_HBM_BW

DECLINE_REASONS = ("grants", "slot_limit", "keyrange", "capacity", "predicate")


def window_work(run, until: Optional[float] = None) -> float:
    """Queries' worth of work from the window's open to ``until`` (its
    close by default): each query running then counts with the share of
    its time, sent to done, inside that span. Past the close only the
    window's queries run until the first completion, where the traced
    run's counters and spans close (``run.traced_until``)."""
    w = run.window
    end = w.close_at if until is None else until
    return sum(max(0.0, min(r.done_at, end) - max(r.arrival, w.open_at)) / (r.done_at - r.arrival)
               for r in run.completed if r.done_at > r.arrival)


def morsel_host_ms(run) -> Optional[float]:
    """Host ms per ``Pipeline.process`` call, less the backend calls inside."""
    s = run.spans
    if not s or not s["process_calls"]:
        return None
    return (s["process_s"] - s["backend_in_process_s"]) / s["process_calls"] * 1e3


def device_idle_share(run) -> Optional[float]:
    d = run.device
    if not d:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])


def engine_kernels_roofline(run) -> Optional[float]:
    """Bound (bytes over the HBM bandwidth) over device time, B1-B4."""
    if not run.spans or not run.device:
        return None
    device_s = sum(run.device["engine_s"].values())
    if device_s <= 0:
        return None
    return 100.0 * sum(run.spans["kernel_bytes"].values()) / H100_HBM_BW / device_s
