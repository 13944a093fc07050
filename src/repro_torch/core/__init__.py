"""GraftDB core: dynamic folding of concurrent analytical queries.

The paper's contribution — state-centric execution, per-query state lenses,
and query grafting — implemented as a composable engine over a columnar
vectorized data plane (see DESIGN.md for the TPU adaptation notes).

INTERNAL LAYER. The supported public surface is the ``graftdb`` package
(``repro.api``): ``graftdb.connect(db, EngineConfig(...))`` returns a
Session; do not hand-assemble ``GraftEngine`` + ``Runner`` pairs outside
``repro.api`` and ``repro.core`` themselves. These exports remain importable
for mechanism-level tests and diagnostics only.
"""

from .engine import MODES, GraftEngine, QueryHandle
from .plans import (
    AggSpec,
    Aggregate,
    BinOp,
    Col,
    Const,
    HashJoin,
    OrderBy,
    Query,
    Scan,
    WhereEq,
)
from .predicates import (
    And,
    Cmp,
    ColCmp,
    Conjunction,
    Coverage,
    InSet,
    TRUE,
    evaluate,
    pred_and,
    prove_implies,
)
from .scheduler import PoolClock, Runner, WallClock, WorkClock

__all__ = [
    "GraftEngine",
    "QueryHandle",
    "MODES",
    "Runner",
    "WorkClock",
    "WallClock",
    "PoolClock",
    "Query",
    "Scan",
    "HashJoin",
    "Aggregate",
    "OrderBy",
    "AggSpec",
    "Col",
    "Const",
    "BinOp",
    "WhereEq",
    "And",
    "Cmp",
    "ColCmp",
    "InSet",
    "TRUE",
    "Conjunction",
    "Coverage",
    "evaluate",
    "pred_and",
    "prove_implies",
]
