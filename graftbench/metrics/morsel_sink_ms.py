"""Host ms a morsel spends in its sinks (``insert_or_mark``, aggregate
folds), less the backend's calls: self time of ``morsel.sink`` per
``morsel`` span."""

from graftbench.program import per_morsel_ms


def read(run):
    return per_morsel_ms(run, "morsel.sink")
