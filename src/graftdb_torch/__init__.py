"""graftdb_torch — GraftDB's dynamic query folding on PyTorch and CUDA.

The PyTorch port's one supported entry point, mirroring ``graftdb``:

    import graftdb_torch
    from graftdb_torch import EngineConfig

    session = graftdb_torch.connect(db, EngineConfig(mode="graft"))
    fut = session.submit(query)
    print(session.explain_graft(query).render())   # EXPLAIN GRAFT
    result = fut.result()

    serving = graftdb_torch.connect_serving(fold=True)  # KV-prefix folding

``EngineConfig()`` runs the data plane on the CUDA card; pass
``device="cpu"`` for the kernels' plain PyTorch versions. The
implementation lives in ``repro_torch.api``; ``repro_torch.core`` is
internal.
"""

from repro_torch.api import (
    BoundaryExplain,
    CohortExplain,
    EngineConfig,
    ExecutionBackend,
    FaultPlan,
    GraftExplain,
    QueryCancelled,
    QueryFuture,
    ReferenceBackend,
    RequestFuture,
    ServingConfig,
    ServingSession,
    Session,
    TorchBackend,
    analyze_cohort,
    analyze_query,
    connect,
    connect_serving,
    resolve_backend,
)

__version__ = "0.1.0"

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
    "__version__",
]
