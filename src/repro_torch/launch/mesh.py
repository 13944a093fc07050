"""Data-axis meshes of the port (DESIGN.md §14).

The reference runs an N-shard mesh inside one process: XLA gives it N
devices and ``Session(mesh=N)`` is one object. The port keeps that shape.
Its mesh is a descriptor, :class:`DataMesh`, that names one torch device
per shard of the 'data' axis; the exchange is a transpose of the stacked
buckets between those devices (``relational.distributed``), and the
shard-local fused chain launches once per shard on its device
(``kernels.fused_chain.chain_launch(mesh=...)``). No process group is
needed: NCCL refuses two ranks on one card, so a process-group exchange
on one H100 would have to leave the card for ``gloo`` on CPU tensors.

Shard p lives on ``cuda:(p mod torch.cuda.device_count())``, or on the
CPU when the caller asks for it, so four shards on one card are four
shards on ``cuda:0``; ``MeshPlan.stats()["devices"]`` names them.
Building a CUDA mesh without a visible card raises.

The reference's production meshes (16 x 16, and 2 x 16 x 16 over two
pods) stand for 256 and 512 devices, which one card does not have:
:func:`make_production_mesh` returns a device-less descriptor of them,
:class:`ProductionMesh`, which the sharding rules and the dry run read
(``shape`` and ``axis_names``) and a ``Session`` refuses.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch


class DataMesh:
    """``n_data`` shards on the 'data' axis and one on 'model', the
    reference's axis names, each shard on a torch device.

    Duck-types the reference's mesh where the engine reads it: ``shape``
    (``{"data": N, "model": 1}``), ``axis_names`` and ``devices`` (an
    ``[N, 1]`` nested list of ``torch.device``)."""

    axis_names = ("data", "model")

    def __init__(self, n_data: int, device: str = "cuda"):
        n_data = int(n_data)
        if n_data < 1:
            raise ValueError(f"data-axis size must be >= 1, got {n_data}")
        kind = torch.device(device).type
        if kind == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "a CUDA mesh needs a CUDA card and none is visible; pass "
                    "device='cpu' for a mesh of CPU shards"
                )
            n_cards = torch.cuda.device_count()
            devs = [torch.device("cuda", p % n_cards) for p in range(n_data)]
        elif kind == "cpu":
            devs = [torch.device("cpu")] * n_data
        else:
            raise ValueError(f"mesh device must be 'cuda' or 'cpu', got {device!r}")
        self.shape = {"data": n_data, "model": 1}
        self.devices = [[d] for d in devs]

    def __repr__(self) -> str:
        return f"DataMesh({self.shape['data']}, devices={[str(r[0]) for r in self.devices]})"


class ProductionMesh:
    """A mesh without devices, the counterpart of JAX's ``AbstractMesh``:
    ``shape`` ({axis: size}) and ``axis_names``, nothing else."""

    def __init__(self, shape, axis_names):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"ProductionMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """The reference's production mesh as a descriptor: ('data', 'model')
    = (16, 16), or ('pod', 'data', 'model') = (2, 16, 16) with
    ``multi_pod``."""
    if multi_pod:
        return ProductionMesh((2, 16, 16), ("pod", "data", "model"))
    return ProductionMesh((16, 16), ("data", "model"))


def shard_devices(mesh) -> List[torch.device]:
    """The torch device of each data shard of ``mesh`` (a ``DataMesh`` or
    any mesh whose ``devices`` name torch devices), in shard order."""
    n = int(mesh.shape["data"])
    flat = np.asarray(mesh.devices, dtype=object).reshape(n, -1)
    return [torch.device(str(row[0])) for row in flat]


def make_smoke_mesh(device: str = "cuda") -> DataMesh:
    """One-shard mesh with the production axis names: the same sharding
    rules run on one device."""
    return DataMesh(1, device)


def make_data_mesh(n_data: int, device: str = "cuda") -> DataMesh:
    """Mesh with ``n_data`` shards on the 'data' axis (P = data-axis size
    in the engine's mesh execution)."""
    return DataMesh(n_data, device)


def resolve_mesh(spec, device: str = "cuda"):
    """Resolve an EngineConfig ``mesh`` spec to a mesh on ``device``.

    Accepts: a mesh (it must carry a 'data' axis and keep its shards on
    ``device``'s kind; returned as it is), the string 'smoke' (one-shard
    mesh), or an int n (n-way data mesh). A mesh of CPU shards under a
    card session raises: its shards would move the card's work to the
    CPU. So does a ``ProductionMesh``, which has no devices."""
    if spec is None:
        raise ValueError("mesh spec is None — nothing to resolve")
    if isinstance(spec, str):
        if spec == "smoke":
            return make_smoke_mesh(device)
        raise ValueError(f"unknown mesh spec {spec!r}; expected 'smoke', an int, or a mesh")
    if isinstance(spec, int):
        return make_data_mesh(spec, device)
    if isinstance(spec, ProductionMesh):
        raise ValueError(
            f"{spec!r} describes the reference's production mesh of {spec.size} devices "
            "and holds none; a session needs a mesh of devices ('smoke', an int, or a "
            "DataMesh)"
        )
    if "data" not in getattr(spec, "axis_names", ()):
        raise ValueError(
            f"mesh {spec!r} has no 'data' axis — the engine shards state over 'data'"
        )
    check_shard_devices(spec, torch.device(device))
    return spec


def check_shard_devices(mesh, device: torch.device) -> None:
    """Raise unless every shard of ``mesh`` lies on a device of
    ``device``'s kind (any card for a card, the CPU for the CPU)."""
    kinds = {d.type for d in shard_devices(mesh)}
    if kinds != {device.type}:
        raise ValueError(
            f"mesh {mesh!r} keeps its shards on {sorted(kinds)}, but the work is on "
            f"{device.type!r}; build the mesh on {device.type!r}"
        )


def mesh_data_size(spec) -> int:
    """The data-axis size a mesh spec resolves to, without building it
    (``EngineConfig`` validates with it): 'smoke' -> 1, int n -> n, mesh
    -> mesh.shape['data']; a bool is no spec."""
    if isinstance(spec, str):
        if spec == "smoke":
            return 1
        raise ValueError(f"unknown mesh spec {spec!r}; expected 'smoke', an int, or a mesh")
    if isinstance(spec, bool):
        raise ValueError(f"mesh must be 'smoke', an int, or a mesh, got {spec!r}")
    if isinstance(spec, int):
        if spec < 1:
            raise ValueError(f"data-axis size must be >= 1, got {spec}")
        return spec
    shape = getattr(spec, "shape", None)
    try:
        return int(shape["data"])
    except (TypeError, KeyError):
        raise ValueError(
            f"mesh {spec!r} has no 'data' axis — the engine shards state over 'data'"
        ) from None


def data_axes(mesh) -> tuple:
    """The compound data-parallel axis: ('pod', 'data') on a multi-pod
    mesh, ('data',) otherwise."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
