"""Mesh execution plan: the replicated control-plane view of a data-axis
mesh (DESIGN.md §14).

One grafted execution spans the 'data' mesh axis by mapping the engine's
key-partition shards onto devices one-to-one: P (state partitions) = data-
axis size, worker clocks = devices, and every morsel's probe rows
repartition by join-key hash before touching shard-local state. The
MeshPlan holds what every host replica agrees on — the shard count, the
routing function (splitmix64 ``key_partition``, identical to the state's
did/probe shards), the modeled exchange accounting, and the per-device row
histogram — while the device data plane (bucketed all_to_all + shard-local
fused chain) lives in ``relational/distributed`` / ``kernels/fused_chain``.

Determinism contract: nothing here may depend on device identity or wall
time. Routing is a pure function of keycodes; counters advance in morsel
order under the virtual clocks; two replicas driving the same trace hold
bit-identical MeshPlan state.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .hashindex import key_partition


class MeshPlan:
    """Replicated per-engine record of one data-axis mesh execution."""

    def __init__(self, mesh, axis_name: str = "data"):
        self.mesh = mesh
        self.axis_name = axis_name
        self.n_shards = int(mesh.shape[axis_name])
        self.devices = [str(d) for d in np.asarray(mesh.devices, dtype=object).reshape(-1)]
        # first-stage routing histogram: rows each device received from the
        # morsel repartition (the data-plane balance signal)
        self.rows_by_device = np.zeros(self.n_shards, np.int64)

    def route(self, keycodes: np.ndarray) -> np.ndarray:
        """Destination device per row — the same splitmix64 shard the
        state's did-dedup and probe indexes use, so exchange placement and
        state ownership can never disagree."""
        return key_partition(np.asarray(keycodes, np.int64), self.n_shards)

    def note_morsel(self, keycodes: np.ndarray) -> None:
        """Record one morsel's first-stage repartition in the per-device
        histogram (stage-0 only: both the staged loop and the fused chain
        observe identical stage-0 keycodes, so the histogram is
        backend-independent)."""
        if len(keycodes) == 0 or self.n_shards <= 1:
            return
        parts = self.route(keycodes)
        self.rows_by_device += np.bincount(parts, minlength=self.n_shards)

    def exchange_rows(self, n_rows: int) -> int:
        """Rows crossing the exchange for one stage: on a 1-device mesh
        nothing moves; on P devices every row is routed (a row resident on
        its destination still transits the dense [P, C, W] buffer — the
        exchange tensor is what the cost model charges for)."""
        return int(n_rows) if self.n_shards > 1 else 0

    def stats(self) -> Dict:
        return {
            "axis": self.axis_name,
            "data_shards": self.n_shards,
            "devices": list(self.devices),
            "rows_by_device": self.rows_by_device.tolist(),
        }
