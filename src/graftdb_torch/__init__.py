"""graftdb_torch — GraftDB's dynamic query folding on PyTorch and CUDA.

The PyTorch port's one supported entry point, mirroring ``graftdb``:

    import graftdb_torch
    from graftdb_torch import EngineConfig

    session = graftdb_torch.connect(db, EngineConfig(mode="graft"))
    fut = session.submit(query)
    print(session.explain_graft(query).render())   # EXPLAIN GRAFT
    result = fut.result()

``EngineConfig()`` runs the data plane on the CUDA card; pass
``device="cpu"`` for the kernels' plain PyTorch versions. The
implementation lives in ``repro_torch.api``; ``repro_torch.core`` is
internal.
"""

from repro_torch.api import (
    BoundaryExplain,
    EngineConfig,
    ExecutionBackend,
    FaultPlan,
    GraftExplain,
    QueryCancelled,
    QueryFuture,
    ReferenceBackend,
    Session,
    TorchBackend,
    analyze_query,
    connect,
    resolve_backend,
)

__version__ = "0.1.0"

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
    "__version__",
]
