"""Host ms a morsel spends in its source filter (member-major plan, source
bits, compaction): self time of ``morsel.filter`` per ``morsel`` span."""

from graftbench.program import per_morsel_ms


def read(run):
    return per_morsel_ms(run, "morsel.filter")
