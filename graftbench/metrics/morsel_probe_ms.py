"""Host ms a morsel spends in its probe stages (key encoding, lens
translation, gathers, stage filters, chain replay), less the backend's
calls: self time of ``morsel.probe`` per ``morsel`` span."""

from graftbench.program import per_morsel_ms


def read(run):
    return per_morsel_ms(run, "morsel.probe")
