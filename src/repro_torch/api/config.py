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
from ..launch.mesh import mesh_data_size, resolve_mesh

CLOCKS = ("work", "wall")
BACKENDS = ("reference", "torch")
DEVICES = ("cuda", "cpu")
# 'refcount' — paper §6.1: release at zero references. 'epoch' — retire
# zero-ref states for later grafts under a memory-budgeted evictor (§10).
RETENTION_POLICIES = ("refcount", "epoch")
ADMISSION_POLICIES = ("always", "adaptive")


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
    * ``mesh`` — mesh execution over the 'data' axis (DESIGN.md §14):
      ``'smoke'`` (one-shard mesh, production axis names), an int N (N-way
      data mesh: shard p on ``cuda:(p mod device_count)``, so N shards
      share one card unless more are visible; on the CPU with
      ``device="cpu"``), or a ``repro_torch.launch.mesh.DataMesh``. Pins
      ``partitions`` and ``workers`` to the data-axis size P — state
      shards, worker clocks, and devices map one-to-one — and charges the
      per-stage exchange cost model term. ``None`` (default) is the
      single-host engine.
    * ``batch_planning`` — graft-aware batch planning (DESIGN.md §15):
      arrivals due at one decision step are windowed into cohorts and
      admitted in the joint planner's provider-first order (maximizing
      total represented coverage across the cohort) instead of greedy
      one-at-a-time FIFO. False (default) keeps the greedy path
      byte-identical to prior releases; with batch planning on, due
      submissions gather into the arrival queue and fold at the next
      decision step.
    * ``batch_window`` — arrival window (seconds) of one cohort: arrivals
      within this span of the cohort's earliest member plan jointly. 0.0
      batches only same-instant ties.
    * ``faults`` — deterministic chaos injection (DESIGN.md §16): a seeded
      ``core.faults.FaultPlan`` arms the engine's fault hooks (morsel /
      exchange / rehydrate / stall sites), replayed bit-identically under
      the virtual clock. ``None`` (default) disarms every hook.
    * ``member_major`` — the fused packed-mask morsel pipeline (DESIGN.md
      §11): per-morsel data-plane cost independent of the folded member
      count. False selects the retained per-member loops — the
      differential oracle the fused path is verified against (results,
      probe pair streams, and EXPLAIN GRAFT accounting are bit-identical).
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
    batch_window: float = 0.0
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
            p = mesh_data_size(self.mesh)  # validates the spec shape
            if self.partitions is not None and self.partitions != p:
                raise ValueError(
                    f"mesh execution pins partitions to the data-axis size "
                    f"({p}); got partitions={self.partitions}. Drop the "
                    "partitions override or match the mesh shape."
                )
            object.__setattr__(self, "partitions", p)
            if self.workers != p:
                if self.workers == _default_workers():
                    # the worker count came from the env default, not an
                    # explicit request: pin it to the device count
                    object.__setattr__(self, "workers", p)
                else:
                    raise ValueError(
                        f"mesh execution pins workers to the data-axis size "
                        f"({p}) — one logical worker clock per device; got "
                        f"workers={self.workers}"
                    )
            if p > 1 and self._wall_clocked():
                raise ValueError(
                    "mesh execution with data shards > 1 requires a virtual "
                    "clock: use clock='work' or a clock factory"
                )
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
        if not isinstance(self.batch_planning, bool):
            raise ValueError(
                f"batch_planning must be a bool, got {self.batch_planning!r}"
            )
        if not isinstance(self.batch_window, (int, float)) or isinstance(
            self.batch_window, bool
        ) or self.batch_window < 0:
            raise ValueError(
                f"batch_window must be a non-negative number (seconds), "
                f"got {self.batch_window!r}"
            )
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

    def make_mesh(self, device: Optional[str] = None):
        """Resolve the ``mesh`` spec to a mesh (None when unset), its shards
        on ``device`` (default: the config's ``device``)."""
        if self.mesh is None:
            return None
        return resolve_mesh(self.mesh, device or self.device)

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


@dataclass(frozen=True)
class ServingConfig:
    """Configuration of one serving (KV-prefix folding) session.

    * ``fold`` — enable dynamic folding (False = isolated baseline: every
      request prefills its whole prompt).
    * ``batch_fold`` — multi-prefix batching (DESIGN.md §15): requests due
      at the same event-loop step admit longest-prompt-first, so shorter
      same-instant prompts fold onto the longest request's fresh prefix
      state instead of each creating its own.
    * ``min_share`` — minimum shared-prefix length (tokens) worth attaching.
    * ``prefill_tok_s`` / ``decode_step_s`` — SimExecutor cost model; ignored
      when an explicit ``executor`` is passed to ``connect_serving``.
    * ``retain_prefixes`` — keep zero-ref prefix states (their covered KV
      cache serves later matching requests) instead of dropping them (§10).
    * ``memory_budget_tokens`` — token budget of retained prefixes; the
      evictor reclaims retired states oldest-epoch-first past it (None =
      retain without bound; requires ``retain_prefixes``).
    * ``reuse_cache_tokens`` — token budget of the serving-plane artifact
      cache (§12): evicted KV prefixes spill into the same tiered
      ``ArtifactStore`` the relational reuse plane uses and rehydrate when
      a later request's prompt matches (None = no prefix cache; requires
      ``retain_prefixes``).
    """

    fold: bool = True
    batch_fold: bool = False
    min_share: int = 16
    prefill_tok_s: float = 8000.0
    decode_step_s: float = 0.02
    retain_prefixes: bool = False
    memory_budget_tokens: Optional[int] = None
    reuse_cache_tokens: Optional[int] = None

    def __post_init__(self):
        if not isinstance(self.batch_fold, bool):
            raise ValueError(f"batch_fold must be a bool, got {self.batch_fold!r}")
        if self.min_share < 0:
            raise ValueError(f"min_share must be >= 0, got {self.min_share!r}")
        if self.prefill_tok_s <= 0 or self.decode_step_s <= 0:
            raise ValueError("executor cost-model rates must be positive")
        if self.memory_budget_tokens is not None:
            if not isinstance(self.memory_budget_tokens, int) or self.memory_budget_tokens < 0:
                raise ValueError(
                    f"memory_budget_tokens must be a non-negative int or None, "
                    f"got {self.memory_budget_tokens!r}"
                )
            if not self.retain_prefixes:
                raise ValueError(
                    "memory_budget_tokens requires retain_prefixes=True"
                )
        if self.reuse_cache_tokens is not None:
            if not isinstance(self.reuse_cache_tokens, int) or self.reuse_cache_tokens < 0:
                raise ValueError(
                    f"reuse_cache_tokens must be a non-negative int or None, "
                    f"got {self.reuse_cache_tokens!r}"
                )
            if not self.retain_prefixes:
                raise ValueError("reuse_cache_tokens requires retain_prefixes=True")
