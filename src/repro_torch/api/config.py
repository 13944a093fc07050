"""EngineConfig: one validated dataclass for every knob of a Session.

Consolidates the kwargs that used to be hand-threaded through
``GraftEngine(db, mode=..., morsel_size=..., cost_model=..., zone_maps=...)``
plus ``Runner(eng, clock=...)`` into a single immutable config object that
``graftdb.connect`` accepts. Invalid values fail at construction time with
actionable messages, not deep inside the engine.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Union

from ..core.engine import DEFAULT_COST_MODEL, MODES
from ..core.scheduler import WallClock, WorkClock

CLOCKS = ("work", "wall")
BACKENDS = ("reference", "torch")
DEVICES = ("cuda", "cpu")
# 'refcount' — paper §6.1: release at zero references. 'epoch' — retire
# zero-ref states for later grafts under a memory-budgeted evictor (§10).
RETENTION_POLICIES = ("refcount", "epoch")
ADMISSION_POLICIES = ("always", "adaptive")


def _not_ported(knob: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob} belongs to a plane the PyTorch port does not have yet "
        f"(ROADMAP {item}); use the reference package for it"
    )


def _default_workers() -> int:
    """Session default worker count; the CI matrix leg sets
    ``GRAFTDB_TEST_WORKERS=4`` to run the whole suite partition-parallel."""
    try:
        return max(1, int(os.environ.get("GRAFTDB_TEST_WORKERS", "1")))
    except ValueError:
        return 1


@dataclass(frozen=True)
class EngineConfig:
    """Configuration of one GraftDB session.

    * ``mode`` — sharing level: one of ``isolated`` / ``scan_sharing`` /
      ``qpipe_osp`` / ``residual`` / ``graft`` (paper §6.1/§6.4).
    * ``morsel_size`` — rows per shared-scan morsel.
    * ``cost_model`` — per-row modeled costs (seconds); defaults to the
      calibrated single-worker constants in ``core.engine``.
    * ``clock`` — ``"work"`` (virtual time, deterministic) or ``"wall"``
      (real time); or a zero-arg clock factory (e.g. the ``WorkClock``
      class), invoked per session; or a clock instance — which is then
      SHARED by every session built from this config (advanced use).
    * ``backend`` — ``"torch"`` (the CUDA probe and fused-chain kernels
      over device-resident state mirrors) or ``"reference"`` (NumPy row
      engine), or an ``ExecutionBackend`` instance.
    * ``device`` — where the ``"torch"`` backend keeps its mirrors and
      runs its kernels: ``"cuda"`` (the default; ``connect`` raises when
      no card is visible) or ``"cpu"``, which runs every kernel's plain
      PyTorch version instead.
    * ``retention`` — shared-state retention policy: ``"refcount"`` is the
      evaluated prototype's release-at-zero-refs policy; ``"epoch"``
      retires zero-ref states (kept observable for later grafts) and
      reclaims them oldest-epoch-first under ``memory_budget`` (§10).
    * ``memory_budget`` — bytes of *retired* shared state the epoch
      evictor retains (None = retain without bound). Pinned state — live
      lenses or queued-but-admissible ones — is never evicted; its
      footprint is bounded by admission control, not by this budget.
    * ``reuse_cache_budget`` — bytes of the reuse plane's host-memory
      artifact tier (DESIGN.md §12): evicted retired states spill into a
      semantic artifact cache instead of being destroyed, and repeat
      arrivals rehydrate them when the cost model favors reuse over
      recompute. None (default) disables the reuse plane. Requires
      ``retention='epoch'`` — refcount release never evicts.
    * ``reuse_disk_budget`` — bytes of the optional on-disk artifact tier
      (a temp dir): artifacts aging out of the memory tier demote here
      instead of dropping. Requires ``reuse_cache_budget``.
    * ``admission`` — open-loop arrival admission: ``"always"`` admits
      every due arrival (seed behavior); ``"adaptive"`` admits freely below
      ``admission_max_inflight`` active queries and past that only arrivals
      whose graft potential reaches ``admission_share_threshold`` — the
      rest queue until load drops (queue delays surface in ``stats()``).
    * ``zone_maps`` — beyond-paper morsel skipping on min/max zones.
    * ``capture_explain`` — record a structured grafting explanation
      (``QueryFuture.explain()``) at each query's admission.
    * ``max_steps`` — executor livelock bound (threaded into ``Runner.run``).
    * ``workers`` — logical worker count of the partition-parallel pool
      (DESIGN.md §9); defaults to ``$GRAFTDB_TEST_WORKERS`` or 1. Virtual
      clocks only: ``workers > 1`` requires ``clock="work"`` or a factory.
    * ``partitions`` — data partitions per scan/state (None = ``workers``).
      ``workers=1, partitions=1`` is byte-identical to the seed engine.
    * ``max_sleep_s`` — WallClock sleep cap: longer idle gaps are skipped
      virtually instead of blocking (None = sleep the full gap).
    * ``faults`` — deterministic chaos injection (DESIGN.md §16): a seeded
      ``core.faults.FaultPlan`` arms the engine's fault hooks (morsel /
      rehydrate / stall sites; the exchange site waits for the mesh plane),
      replayed bit-identically under the virtual clock. ``None`` (default)
      disarms every hook.
    * ``member_major`` — the fused packed-mask morsel pipeline (DESIGN.md
      §11): per-morsel data-plane cost independent of the folded member
      count. False selects the retained per-member loops — the
      differential oracle the fused path is verified against (results,
      probe pair streams, and EXPLAIN GRAFT accounting are bit-identical).

    The reference's ``mesh`` and ``batch_planning=True`` belong to planes
    the port does not have yet: setting either raises
    ``NotImplementedError`` naming the ROADMAP item that ports it.
    """

    mode: str = "graft"
    morsel_size: int = 65536
    cost_model: Optional[Dict[str, float]] = None
    clock: Union[str, object] = "work"
    backend: Union[str, object] = "torch"
    device: str = "cuda"
    retention: str = "refcount"
    memory_budget: Optional[int] = None
    reuse_cache_budget: Optional[int] = None
    reuse_disk_budget: Optional[int] = None
    admission: str = "always"
    admission_max_inflight: int = 8
    admission_share_threshold: float = 0.5
    zone_maps: bool = False
    capture_explain: bool = False
    max_steps: int = 50_000_000
    workers: int = field(default_factory=_default_workers)
    partitions: Optional[int] = None
    max_sleep_s: Optional[float] = 0.25
    member_major: bool = True
    mesh: Union[None, str, int, object] = None
    batch_planning: bool = False
    faults: Optional[object] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"unknown mode {self.mode!r}; expected one of {sorted(MODES)}"
            )
        if not isinstance(self.morsel_size, int) or self.morsel_size <= 0:
            raise ValueError(f"morsel_size must be a positive int, got {self.morsel_size!r}")
        if isinstance(self.clock, str):
            if self.clock not in CLOCKS:
                raise ValueError(
                    f"clock must be one of {CLOCKS}, a clock factory, or a clock "
                    f"instance, got {self.clock!r}"
                )
        elif not isinstance(self.clock, type) and not callable(self.clock) and not hasattr(self.clock, "now"):
            raise ValueError(
                f"clock must expose .now/.tick/.advance_to (or be a factory), got {self.clock!r}"
            )
        if isinstance(self.backend, str) and self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS} or an ExecutionBackend instance, got {self.backend!r}"
            )
        if self.device not in DEVICES:
            raise ValueError(f"device must be one of {DEVICES}, got {self.device!r}")
        if self.retention not in RETENTION_POLICIES:
            raise ValueError(
                f"retention must be one of {RETENTION_POLICIES}, got {self.retention!r}"
            )
        if self.memory_budget is not None:
            if not isinstance(self.memory_budget, int) or self.memory_budget < 0:
                raise ValueError(
                    f"memory_budget must be a non-negative int (bytes) or None, "
                    f"got {self.memory_budget!r}"
                )
            if self.retention != "epoch":
                raise ValueError(
                    "memory_budget requires retention='epoch' (the refcount "
                    "policy frees state at zero refs — there is nothing to budget)"
                )
        if self.reuse_cache_budget is not None:
            if not isinstance(self.reuse_cache_budget, int) or self.reuse_cache_budget < 0:
                raise ValueError(
                    f"reuse_cache_budget must be a non-negative int (bytes) or None, "
                    f"got {self.reuse_cache_budget!r}"
                )
            if self.retention != "epoch":
                raise ValueError(
                    "reuse_cache_budget requires retention='epoch' (artifacts "
                    "spill at eviction — the refcount policy never evicts)"
                )
        if self.reuse_disk_budget is not None:
            if not isinstance(self.reuse_disk_budget, int) or self.reuse_disk_budget < 0:
                raise ValueError(
                    f"reuse_disk_budget must be a non-negative int (bytes) or None, "
                    f"got {self.reuse_disk_budget!r}"
                )
            if self.reuse_cache_budget is None:
                raise ValueError("reuse_disk_budget requires reuse_cache_budget")
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(
                f"admission must be one of {ADMISSION_POLICIES}, got {self.admission!r}"
            )
        if not isinstance(self.admission_max_inflight, int) or self.admission_max_inflight < 1:
            raise ValueError(
                f"admission_max_inflight must be a positive int, "
                f"got {self.admission_max_inflight!r}"
            )
        if not (0.0 < self.admission_share_threshold <= 1.0):
            raise ValueError(
                f"admission_share_threshold must be in (0, 1], "
                f"got {self.admission_share_threshold!r}"
            )
        if self.cost_model is not None:
            unknown = set(self.cost_model) - set(DEFAULT_COST_MODEL)
            if unknown:
                raise ValueError(f"unknown cost_model keys: {sorted(unknown)}")
        if self.max_steps <= 0:
            raise ValueError(f"max_steps must be positive, got {self.max_steps!r}")
        if not isinstance(self.workers, int) or self.workers < 1:
            raise ValueError(f"workers must be a positive int, got {self.workers!r}")
        if self.partitions is not None and (
            not isinstance(self.partitions, int) or self.partitions < 1
        ):
            raise ValueError(
                f"partitions must be a positive int or None (= workers), got {self.partitions!r}"
            )
        if self.mesh is not None:
            raise _not_ported("mesh", "A3")
        if self.workers > 1 and self._wall_clocked():
            # N logical workers advance N independent virtual clocks; a
            # wall clock (class, instance, or one shared instance) cannot
            # model that.
            if self.workers == _default_workers():
                # the worker count came from the GRAFTDB_TEST_WORKERS
                # default, not an explicit request: wall-clock sessions
                # stay single-worker instead of failing unrelated scripts
                object.__setattr__(self, "workers", 1)
            else:
                raise ValueError(
                    "workers > 1 requires a virtual clock: use clock='work' or a clock factory"
                )
        if self.max_sleep_s is not None and self.max_sleep_s <= 0:
            raise ValueError(f"max_sleep_s must be positive or None, got {self.max_sleep_s!r}")
        if not isinstance(self.member_major, bool):
            raise ValueError(
                f"member_major must be a bool, got {self.member_major!r}"
            )
        if self.batch_planning is not False:
            raise _not_ported("batch_planning", "A2")
        if self.faults is not None:
            from ..core.faults import FaultPlan

            if not isinstance(self.faults, FaultPlan):
                raise ValueError(
                    f"faults must be a FaultPlan or None, got {self.faults!r}"
                )

    def _wall_clocked(self) -> bool:
        """The configured clock is real-time: the 'wall' name, the
        WallClock class itself, or any non-factory instance."""
        if self.clock == "wall":
            return True
        if isinstance(self.clock, type):
            return issubclass(self.clock, WallClock)
        return not isinstance(self.clock, str) and not callable(self.clock) and hasattr(
            self.clock, "now"
        )

    @property
    def n_partitions(self) -> int:
        """Resolved partition count (``partitions`` defaulting to ``workers``)."""
        return self.partitions if self.partitions is not None else self.workers

    # -- factories -----------------------------------------------------------
    def make_clock(self):
        if isinstance(self.clock, str):
            return (
                WallClock(max_sleep_s=self.max_sleep_s)
                if self.clock == "wall"
                else WorkClock()
            )
        # A class counts as a factory even when it defines `now` as a
        # class-level property (hasattr(WallClock, "now") is True).
        if isinstance(self.clock, type) or (
            callable(self.clock) and not hasattr(self.clock, "now")
        ):
            return self.clock()  # factory/class: fresh clock per session
        return self.clock  # explicit instance: shared across sessions

    def clock_factory(self):
        """Zero-arg per-worker clock factory (workers > 1 pools).

        Validation guarantees the clock is virtual here: 'wall', the
        WallClock class, and bare instances all either raised or downgraded
        the session to workers=1 in ``__post_init__``."""
        if isinstance(self.clock, str):
            return WorkClock
        return self.clock

    def make_backend(self):
        from .backends import resolve_backend

        return resolve_backend(self.backend, self.device)

    def make_admission(self):
        """Admission controller for the session's Runner (None = admit all)."""
        if self.admission == "always":
            return None
        from ..core.scheduler import AdmissionController

        return AdmissionController(
            max_inflight=self.admission_max_inflight,
            share_threshold=self.admission_share_threshold,
        )

    def with_(self, **kw) -> "EngineConfig":
        """Functional update (frozen dataclass)."""
        return replace(self, **kw)
