"""Burst traces of the port's batch-planning tests, shared by the CPU tests
(``test_torch_batch_planning.py``) and the card tests (``test_torch_cuda.py``,
which must import without JAX). It imports only the port.

The shape is the reference's queued burst (``benchmarks/batch_sweep.py``
``make_burst_trace``): each burst is same-instant queries of one template on
one group (``b % 5``), dates ascending in the template's step up to its last
date, bursts ``gap_s`` virtual s apart. For q3 the narrowest member comes
first; q5's members have windows of one width, shifted, so a cohort's
members see different rows of one shared orders state, whose multi-member
probes take ``hash_probe_lens_multi64``.
"""

from repro_torch.relational import queries
from repro_torch.relational.table import days

#: per template: the parameter that takes the burst's group, the last date
#: of a burst and the step between its members' dates (days)
BURSTS = {"q3": ("segment", "1996-06-30", 2), "q5": ("region", "1994-06-30", 60)}


def burst_trace(db, n_bursts, size, gap_s=0.002, template="q3"):
    """``n_bursts`` bursts of ``size`` same-instant ``template`` queries."""
    group, end, step = BURSTS[template]
    last = days(end)
    return [
        queries.make_query(
            db, template,
            {group: float(b % 5), "date": float(last - step * (size - 1 - i))},
            arrival=(b + 1) * gap_s,
        )
        for b in range(n_bursts)
        for i in range(size)
    ]
