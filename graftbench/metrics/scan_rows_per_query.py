"""Rows the shared scans read from the window's open to the counters'
close, per query's worth of work done over the same span
(``readings.window_work``)."""

from graftbench.readings import window_work


def read(run):
    work = window_work(run, run.traced_until)
    return run.delta("scan_rows") / work if work > 0 else None
