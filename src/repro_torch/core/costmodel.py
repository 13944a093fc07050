"""Work-clock cost-model calibration.

The default constants (engine.DEFAULT_COST_MODEL) model the paper's
~100 ns/row single-worker row engine. ``calibrate()`` measures THIS host's
vectorized data plane instead (numpy filter / sort-probe / insert / segment
sum throughput) and returns a cost model for wall-clock-faithful virtual
time. Benchmarks use the fixed defaults so results are machine-independent;
calibration is exposed for deployments that want host-accurate queueing.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from .engine import DEFAULT_COST_MODEL


def _time(fn, reps: int = 3) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def calibrate(n: int = 1 << 20, seed: int = 0) -> Dict[str, float]:
    rng = np.random.default_rng(seed)
    col = rng.uniform(0, 1000, n)
    keys = rng.integers(0, n, n)
    skeys = np.sort(rng.choice(2 * n, n // 4, replace=False))
    vals = rng.normal(size=n)
    gids = rng.integers(0, 1024, n)

    t_scan = _time(lambda: col.copy()) / n
    t_filter = _time(lambda: (col > 500.0) & (col < 900.0)) / n
    t_probe = _time(lambda: np.searchsorted(skeys, keys)) / n
    idx = np.searchsorted(skeys, keys).clip(0, len(skeys) - 1)
    t_match = _time(lambda: skeys[idx] == keys) / n
    t_insert = _time(lambda: np.sort(keys[: n // 4], kind="stable")) / (n // 4)
    t_agg = _time(lambda: np.bincount(gids, weights=vals, minlength=1024)) / n
    # rehydration (§12) ~= bulk copy of the SoA columns + an index-rebuild
    # share comparable to one more copy pass
    t_rehydrate = _time(lambda: (col.copy(), keys.copy())) / n

    return {
        "scan": max(t_scan, 1e-10),
        "filter": max(t_filter, 1e-10),
        "probe": max(t_probe, 1e-10),
        "match": max(t_match, 1e-10),
        "insert": max(t_insert * 2, 1e-10),  # insert ~= sort share + dict upkeep
        "mark": max(t_match * 2, 1e-10),
        "agg": max(t_agg, 1e-10),
        "rehydrate": max(t_rehydrate * 2, 1e-10),
    }


def scaled_default(target_row_ns: float = 100.0) -> Dict[str, float]:
    """DEFAULT_COST_MODEL rescaled so 'scan' hits target ns/row."""
    k = target_row_ns * 1e-9 / DEFAULT_COST_MODEL["scan"]
    return {name: v * k for name, v in DEFAULT_COST_MODEL.items()}


def score_arrival(engine, query) -> Dict[str, object]:
    """Three-way per-arrival decision (§12): modeled boundary-build seconds
    under isolated recompute, grafting onto live shared state, and
    rehydrating cached artifacts, plus the source the admission path would
    pick. ``graft`` has no rehydration term, so live state always dominates
    a cached artifact for the same coverage; ``cache`` wins only where no
    live candidate exists and the artifact's saved build work exceeds its
    rehydration cost. Read-only — shares ``engine.demand_cache`` and the
    reuse plane's coverage memo with EXPLAIN GRAFT."""
    from .grafting import graft_potential
    from .reuse import reuse_potential, reuse_scores

    cm = engine.cost_model
    row = cm["scan"] + cm["filter"] + cm["insert"]
    live = graft_potential(engine, query)
    cached = reuse_potential(engine, query)

    from .grafting import all_boundaries, estimate_demand

    demand = sum(estimate_demand(engine, b.build) for b in all_boundaries(query.plan))
    recompute_s = demand * row
    scores = {
        "recompute_s": recompute_s,
        "graft_s": recompute_s * (1.0 - live),
        "cache_s": None,
        "choice": "recompute",
    }
    if cached > 0.0:
        s = reuse_scores(cm, demand, int(round(cached * demand)), int(round(cached * demand)))
        scores["cache_s"] = recompute_s - s["saved_s"] + s["rehydrate_s"]
    if live >= cached and live > 0.0:
        scores["choice"] = "graft"
    elif cached > 0.0:
        scores["choice"] = "cache"
    return scores
