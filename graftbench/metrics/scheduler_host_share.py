"""Share of the traced window in the scheduler and grafting layer's own
host work: self time of ``scheduler.step`` (ready units, admission, clock),
``engine.submit`` (install, boundary resolution, grafting) and
``engine.complete`` (result, ORDER BY, release)."""

from graftbench.program import window_share


def read(run):
    return window_share(run, ("scheduler.step", "engine.submit", "engine.complete"), "self_s")
