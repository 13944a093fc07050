"""Elastic scaling and straggler mitigation — the control-plane decision
logic, deterministic and fully unit-testable in simulation.

Model (designed for 1000+ nodes, exercised here in simulation):

* every pod posts a heartbeat each step; the (replicated, deterministic)
  controller evaluates them at step boundaries,
* a pod whose heartbeat lags beyond ``straggler_factor`` x the healthy
  median for ``patience`` consecutive steps is marked DEGRADED; a pod
  missing ``dead_after`` heartbeats is DEAD,
* decisions: CONTINUE / DROP_POD (elastic restore onto the shrunk mesh at
  the next checkpoint boundary) / ABORT_RESTART (below min_pods),
* in-step, collectives are fixed-size, so a slow link delays but never
  deadlocks; the controller never interrupts mid-step — it re-meshes only
  at checkpoint boundaries, which the deterministic data pipeline makes
  exactly resumable (train/data.py).

Because every healthy host computes the same decision from the same
heartbeat log, no consensus protocol sits on the hot path (same argument as
the GraftDB control plane — DESIGN.md §4).

A copy of the reference's ``train/elastic.py`` (pure Python; the port
imports nothing of the reference): the same heartbeat log gives the same
decisions.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple


class PodState(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    DEAD = "dead"


class Action(enum.Enum):
    CONTINUE = "continue"
    DROP_PODS = "drop_pods"
    ABORT_RESTART = "abort_restart"


@dataclasses.dataclass
class ElasticConfig:
    straggler_factor: float = 2.0
    patience: int = 3
    dead_after: int = 5
    min_pods: int = 1


@dataclasses.dataclass
class Decision:
    action: Action
    drop: Tuple[int, ...] = ()
    new_mesh_pods: int = 0
    reason: str = ""


class ElasticController:
    def __init__(self, n_pods: int, cfg: Optional[ElasticConfig] = None):
        self.cfg = cfg or ElasticConfig()
        self.n_pods = n_pods
        self.step_times: Dict[int, List[float]] = {p: [] for p in range(n_pods)}
        self.missed: Dict[int, int] = {p: 0 for p in range(n_pods)}
        self.slow_streak: Dict[int, int] = {p: 0 for p in range(n_pods)}
        self.active = set(range(n_pods))

    def heartbeat(self, pod: int, step_time: float) -> None:
        if pod in self.active:
            self.step_times[pod].append(step_time)
            self.missed[pod] = 0

    def miss(self, pod: int) -> None:
        if pod in self.active:
            self.missed[pod] += 1

    def evaluate(self) -> Decision:
        """Deterministic per-step-boundary decision."""
        cfg = self.cfg
        dead = {p for p in self.active if self.missed[p] >= cfg.dead_after}
        latest = {
            p: self.step_times[p][-1]
            for p in self.active
            if p not in dead and self.step_times[p]
        }
        if latest:
            healthy_sorted = sorted(latest.values())
            median = healthy_sorted[len(healthy_sorted) // 2]
            for p, t in latest.items():
                if t > cfg.straggler_factor * median:
                    self.slow_streak[p] += 1
                else:
                    self.slow_streak[p] = 0
        stragglers = {
            p for p in self.active if self.slow_streak[p] >= cfg.patience
        }
        drop = tuple(sorted(dead | stragglers))
        if not drop:
            return Decision(Action.CONTINUE)
        remaining = len(self.active) - len(drop)
        if remaining < cfg.min_pods:
            return Decision(
                Action.ABORT_RESTART,
                drop=drop,
                reason=f"{len(drop)} pods unhealthy, below min_pods={cfg.min_pods}",
            )
        for p in drop:
            self.active.discard(p)
        return Decision(
            Action.DROP_PODS,
            drop=drop,
            new_mesh_pods=remaining,
            reason="dead=" + ",".join(map(str, sorted(dead)))
            + " stragglers="
            + ",".join(map(str, sorted(stragglers))),
        )


def remesh_plan(old_pods: int, new_pods: int, data: int = 16, model: int = 16) -> Dict:
    """The elastic restore plan: target mesh + whether the global batch is
    preserved (batch is sharded over ('pod','data'); dropping pods shrinks
    the FSDP axis — the deterministic pipeline re-slices by global example
    index so content is unchanged)."""
    return {
        "old_mesh": (old_pods, data, model) if old_pods > 1 else (data, model),
        "new_mesh": (new_pods, data, model) if new_pods > 1 else (data, model),
        "restore": "checkpoint-boundary",
        "batch_reslice": f"{old_pods * data} -> {new_pods * data} FSDP shards",
    }
