"""Share of the traced window in probes the backend declined and served by
the host reference (``backend.fallback``)."""

from graftbench.program import window_share


def read(run):
    return window_share(run, ("backend.fallback",))
