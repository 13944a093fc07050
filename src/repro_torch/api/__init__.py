"""GraftDB public API of the PyTorch port: one facade over engine, runner
and backends.

Entry point: ``connect(db, config)`` — relational Session over a shared
GraftEngine, on the CUDA card by default (``EngineConfig(device="cuda")``).

Everything under ``repro_torch.core`` is internal; this package
(re-exported at top level as ``graftdb_torch``) is the supported surface.
"""

from ..core.faults import FaultPlan
from .backends import ExecutionBackend, ReferenceBackend, TorchBackend, resolve_backend
from .config import EngineConfig
from .explain import BoundaryExplain, GraftExplain, analyze_query
from .futures import QueryCancelled, QueryFuture
from .session import Session, connect

__all__ = [
    "connect",
    "Session",
    "EngineConfig",
    "FaultPlan",
    "QueryCancelled",
    "QueryFuture",
    "GraftExplain",
    "BoundaryExplain",
    "analyze_query",
    "ExecutionBackend",
    "ReferenceBackend",
    "TorchBackend",
    "resolve_backend",
]
