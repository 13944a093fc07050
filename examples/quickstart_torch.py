"""Quickstart on the PyTorch/CUDA port: dynamic folding of two TPC-H Q3
queries (the paper's Fig. 3 running instance) through the Session API.

Q_A arrives first and builds the order-side hash state; Q_B arrives
mid-flight with a broader order-date predicate, observes the represented
extent through its state lens, contributes the missing date band as
residual production, and completes without rebuilding Q_A's work. The
grafting decision is surfaced as structured data by EXPLAIN GRAFT.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The twin of ``examples/quickstart.py``: the same instance (TPC-H SF 0.02),
queries and printed lines, on ``graftdb_torch`` with its default backend
(``backend="torch"``), on the CUDA card unless ``--device cpu``. The
folding main path there runs the fused stage chain (B1) and the probes
it falls back to.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import graftdb_torch  # noqa: E402
from graftdb_torch import EngineConfig  # noqa: E402
from repro_torch.relational import queries, refexec, tpch  # noqa: E402
from repro_torch.relational.table import days  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    db = tpch.get_database(0.02)
    print(f"TPC-H-derived instance: {db.nbytes()/1e6:.0f} MB, lineitem {db['lineitem'].nrows:,} rows")

    qa = queries.make_query(db, "q3", {"segment": 1.0, "date": float(days("1995-03-15"))}, arrival=0.0)
    qb = queries.make_query(db, "q3", {"segment": 1.0, "date": float(days("1995-03-20"))}, arrival=0.02)

    for mode in ("isolated", "graft"):
        session = graftdb_torch.connect(
            db, EngineConfig(mode=mode, morsel_size=16384, device=args.device))
        session.submit_all([
            queries.make_query(db, "q3", qa.params, 0.0),
            queries.make_query(db, "q3", qb.params, 0.02),
        ])
        session.run()
        c = session.counters
        print(
            f"\n[{mode}] both done at t={session.now:.3f}s | "
            f"scan {c['scan_rows']:,.0f} rows | builds: ordinary {c['ordinary_build_rows']:,.0f}, "
            f"residual {c['residual_build_rows']:,.0f}, represented(observed) {c['represented_rows']:,.0f}"
        )

    # rerun with explain capture and verify against the reference executor
    ref = refexec.execute(db, qb.plan)
    session = graftdb_torch.connect(
        db, EngineConfig(mode="graft", morsel_size=16384, capture_explain=True,
                         device=args.device)
    )
    session.submit(qa)
    fb = session.submit(qb)
    res = fb.result()  # drives the shared executor until Q_B completes
    ok = all(
        np.allclose(np.sort(np.asarray(res[k], float)), np.sort(np.asarray(ref[k], float)))
        for k in ref
    )
    print(f"\nQ_B result matches reference executor: {ok}")
    print("top revenue rows:", {k: np.round(v[:3], 2).tolist() for k, v in res.items()})
    print("\n" + fb.explain().render())
    return ok


if __name__ == "__main__":
    main()
