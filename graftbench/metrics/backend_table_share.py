"""Share of the traced window in the backend's probe-table upkeep
(``backend.table``: key inserts with the table's upload, mirror syncs)."""

from graftbench.program import window_share


def read(run):
    return window_share(run, ("backend.table",))
