"""Host<->device bytes the backend copied over the traced window (the
program's ``h2d_bytes`` and ``d2h_bytes``), per query's worth of work
done over the same span (``readings.window_work``)."""

from graftbench.program import program
from graftbench.readings import window_work


def read(run):
    p = program(run)
    if p is None:
        return None
    work = window_work(run, run.traced_until)
    c = p["counters"]
    return (c["h2d_bytes"] + c["d2h_bytes"]) / work if work > 0 else None
