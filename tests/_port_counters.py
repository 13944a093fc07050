"""The port's session counters and per-query stats beside the reference
engine's. It imports nothing of either package.

The port counts three things the reference does not (``PORT_ONLY``): the
aggregate cohort fold's first contacts served by appending to a member's
accumulators or by a lookup in the member's own group index, and the
buckets the fold reduced. The port also defers a member index's inserts of
appended groups until something reads that index, and then inserts them in
the batches the reference inserted, so its ``index_rebuilds`` is a prefix
of the reference's doublings: never more, and equal when nothing was
appended. Every other counter and stat must be equal.
"""

PORT_ONLY = ("agg_fold_appended_groups", "agg_fold_looked_up_groups", "agg_fold_buckets")


def assert_counters_match(port, ref):
    port, ref = dict(port), dict(ref)
    assert set(port) == set(ref) | set(PORT_ONLY), set(port) ^ set(ref)
    appended = port["agg_fold_appended_groups"]
    for k in PORT_ONLY:
        del port[k]
    rebuilds, ref_rebuilds = port.pop("index_rebuilds"), ref.pop("index_rebuilds")
    assert rebuilds <= ref_rebuilds if appended else rebuilds == ref_rebuilds, (
        rebuilds, ref_rebuilds, appended)
    assert port == ref


def assert_stats_match(port, ref):
    port, ref = dict(port), dict(ref)
    assert_counters_match(port.pop("counters"), ref.pop("counters"))
    assert port == ref
