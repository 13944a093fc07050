"""GraftDB public API of the PyTorch port: one facade over engine, runner,
backends and folding.

Entry points:

* ``connect(db, config)`` — relational Session over a shared GraftEngine,
  on the CUDA card by default (``EngineConfig(device="cuda")``).
* ``connect_serving(executor, config)`` — ServingSession over shared
  KV-prefix states (the LM-serving adaptation on the same surface; its
  token-cost simulator runs on the host).

Everything under ``repro_torch.core`` / ``repro_torch.serve`` is internal;
this package (re-exported at top level as ``graftdb_torch``) is the
supported surface.
"""

from ..core.faults import FaultPlan
from .backends import ExecutionBackend, ReferenceBackend, TorchBackend, resolve_backend
from .config import EngineConfig, ServingConfig
from .explain import (
    BoundaryExplain,
    CohortExplain,
    GraftExplain,
    analyze_cohort,
    analyze_query,
)
from .futures import QueryCancelled, QueryFuture, RequestFuture
from .serving import ServingSession, connect_serving
from .session import Session, connect

__all__ = [
    "connect",
    "connect_serving",
    "Session",
    "ServingSession",
    "EngineConfig",
    "ServingConfig",
    "FaultPlan",
    "QueryCancelled",
    "QueryFuture",
    "RequestFuture",
    "GraftExplain",
    "BoundaryExplain",
    "analyze_query",
    "CohortExplain",
    "analyze_cohort",
    "ExecutionBackend",
    "ReferenceBackend",
    "TorchBackend",
    "resolve_backend",
]
