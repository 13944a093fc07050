"""Deterministic fault injection (DESIGN.md §16).

GraftDB's folding widens every query's failure domain: operator state is
shared, so a fault inside one producer's morsel threatens every folded
beneficiary. The fault plane makes that failure domain *testable*: a seeded
``FaultPlan`` injects failures at the engine's real boundaries — morsel
execution, the mesh exchange, artifact rehydration, worker stalls — as a
pure function of ``(seed, site, occurrence index)``. Because the scheduler
is a deterministic simulation under the virtual clock, the occurrence
indexes replay identically run over run, so every chaos schedule is
bit-reproducible: same seed + same workload ⇒ same faults at the same
virtual instants ⇒ same surviving results.

Sites:

* ``morsel``    — a (scan × partition) morsel advance fails before any
  state mutation (kernel error / worker crash). Retried with
  WorkClock-charged exponential backoff; retry exhaustion escalates to
  quarantine (build pipelines) or unfold (main pipelines).
* ``exchange``  — the §14 bucketed all_to_all exhausts its bucket-overflow
  regrowth. Drawn instead of ``morsel`` on mesh sessions (every morsel
  there transits the sharded exchange).
* ``rehydrate`` — a spilled artifact is corrupt at rehydration: the reuse
  plane counts ``cache_corrupt``, drops the artifact, and falls through to
  recompute — never raising into the arrival path.
* ``stall``     — a worker stalls for ``stall_s`` virtual seconds before
  executing its morsel (slow node / GC pause). Pure delay, never an error.

``FaultPlan(schedule={})`` arms the hooks with zero perturbation: every
draw misses and charges nothing, so results, counters, and virtual clocks
are identical to ``faults=None`` — the overhead-identity leg of
``benchmarks/chaos_sweep.py`` pins this.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple, Union

SITES = ("morsel", "exchange", "rehydrate", "stall")

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a high-quality pure-int hash, no RNG state."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


@dataclass(frozen=True)
class FaultPlan:
    """Seeded, declarative chaos schedule for one session.

    * ``seed`` — hash seed; two sessions with the same seed + schedule +
      workload inject bit-identical fault sequences.
    * ``schedule`` — ``site -> rate | occurrence indexes``: a float in
      [0, 1] fires probabilistically per draw (hashed, not sampled — no
      RNG state), a collection of ints fires at exactly those per-site
      occurrence indexes (0-based). Unlisted sites never fire.
    * ``retry_limit`` — bounded deterministic retries per faulted morsel
      before escalation (quarantine / unfold).
    * ``backoff_s`` — virtual seconds charged to the executing worker's
      clock per retry, doubling each attempt.
    * ``stall_s`` — virtual seconds one fired ``stall`` delays a worker.
    * ``max_injections`` — global cap on fired faults (None = unbounded);
      a chaos run at rate 1.0 still terminates without it (escalation
      unfolds then fails each query), but the cap keeps sweeps cheap.
    """

    seed: int = 0
    schedule: Mapping[str, Union[float, Tuple[int, ...]]] = field(
        default_factory=dict
    )
    retry_limit: int = 2
    backoff_s: float = 1e-4
    stall_s: float = 5e-4
    max_injections: Optional[int] = None

    def __post_init__(self):
        if not isinstance(self.seed, int):
            raise ValueError(f"FaultPlan.seed must be an int, got {self.seed!r}")
        for site, spec in dict(self.schedule).items():
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; expected one of {SITES}"
                )
            if isinstance(spec, bool):
                raise ValueError(f"fault schedule for {site!r} must be a rate "
                                 f"in [0, 1] or a collection of occurrence "
                                 f"indexes, got {spec!r}")
            if isinstance(spec, (int, float)):
                if not (0.0 <= float(spec) <= 1.0):
                    raise ValueError(
                        f"fault rate for {site!r} must be in [0, 1], got {spec!r}"
                    )
            else:
                try:
                    idxs = tuple(int(i) for i in spec)
                except TypeError:
                    raise ValueError(
                        f"fault schedule for {site!r} must be a rate or a "
                        f"collection of occurrence indexes, got {spec!r}"
                    ) from None
                if any(i < 0 for i in idxs):
                    raise ValueError(
                        f"occurrence indexes for {site!r} must be >= 0, got {idxs}"
                    )
        if not isinstance(self.retry_limit, int) or self.retry_limit < 0:
            raise ValueError(
                f"retry_limit must be a non-negative int, got {self.retry_limit!r}"
            )
        if self.backoff_s < 0 or self.stall_s < 0:
            raise ValueError("backoff_s and stall_s must be non-negative")
        if self.max_injections is not None and (
            not isinstance(self.max_injections, int) or self.max_injections < 0
        ):
            raise ValueError(
                f"max_injections must be a non-negative int or None, "
                f"got {self.max_injections!r}"
            )


class FaultPlane:
    """Runtime of one FaultPlan: per-site occurrence counters + the pure
    fire decision. Owned by the engine, consulted by the scheduler (morsel /
    exchange / stall sites) and the reuse plane (rehydrate site). All state
    is a deterministic function of the draw sequence, which the virtual
    clock makes a deterministic function of the workload."""

    def __init__(self, plan: FaultPlan, counters: Optional[Dict] = None):
        self.plan = plan
        self.counters = counters if counters is not None else {}
        self._calls: Dict[str, int] = {s: 0 for s in SITES}
        self._injected = 0
        # normalize the schedule once: site -> ('rate', p) | ('at', frozenset)
        self._sched: Dict[str, Tuple[str, object]] = {}
        for site, spec in dict(plan.schedule).items():
            if isinstance(spec, (int, float)):
                if float(spec) > 0.0:
                    self._sched[site] = ("rate", float(spec))
            else:
                idxs = frozenset(int(i) for i in spec)
                if idxs:
                    self._sched[site] = ("at", idxs)

    def fire(self, site: str) -> bool:
        """One draw at ``site``: advances the per-site occurrence index and
        returns whether this occurrence faults. Pure in (seed, site, index)."""
        i = self._calls[site]
        self._calls[site] = i + 1
        spec = self._sched.get(site)
        if spec is None:
            return False
        cap = self.plan.max_injections
        if cap is not None and self._injected >= cap:
            return False
        kind, val = spec
        if kind == "at":
            hit = i in val
        else:
            h = _mix64(_mix64(self.plan.seed & _MASK64) ^ _mix64(
                (SITES.index(site) << 48) ^ i
            ))
            hit = (h / 2.0**64) < val
        if hit:
            self._injected += 1
            self.counters["faults_injected"] = (
                self.counters.get("faults_injected", 0) + 1
            )
        return hit

    def stall(self) -> float:
        """Virtual delay of one potential worker stall (0.0 = no stall).
        Only draws when the schedule lists the site, so stall-free plans
        keep the other sites' occurrence indexes unperturbed."""
        if "stall" not in self._sched:
            return 0.0
        return self.plan.stall_s if self.fire("stall") else 0.0

    def attempt(self, site: str, clock) -> bool:
        """Bounded deterministic retry of one morsel-boundary fault site:
        draws up to ``retry_limit + 1`` times, charging exponential backoff
        to the executing worker's clock between attempts. Returns True when
        an attempt succeeds, False when retries are exhausted (escalate)."""
        plan = self.plan
        for i in range(plan.retry_limit + 1):
            if not self.fire(site):
                return True
            if i < plan.retry_limit:
                self.counters["fault_retries"] = (
                    self.counters.get("fault_retries", 0) + 1
                )
                clock.tick(plan.backoff_s * (2.0**i))
        return False
