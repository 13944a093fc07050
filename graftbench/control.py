"""The control of the check that decides ``correct``: the comparison has to
fail it.

The control is the plain reference put in the program's place and
computed one precision lower than the configuration states: float32 for
the float64 measures (prices, discounts, costs and their sums; keys,
dates and codes stay exact). For each seed it makes the cell's tables at
the cell's size and the first ``--queries`` instances of the cell's mix,
answers each in float32 as the program would (ordered, LIMIT applied) and
holds the answers against the float64 reference with the run's own
comparison. Each seed prints one JSON line with the numbers the run
compares; a sound limit lies below every seed's ``max_rel_err`` here.

    python3 -m graftbench.control --workload sf1-closed32 --seeds 1,2,3 --queries 60
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional

import numpy as np

from . import datagen, harness, traffic
from .compare import Checker
from .reference.tpch_queries import TEMPLATES, Reference


def control_answer(ref32: Reference, template: str, params: Dict):
    res = ref32.run(template, params)
    limit = TEMPLATES[template].limit
    return {k: np.asarray(v[:limit] if limit else v, dtype=np.float64) for k, v in res.items()}


def control_readings(workload: str, seed: int, n_queries: int,
                     scale_factor: Optional[float] = None) -> Dict:
    cell = harness.cell_of(harness.benchmark(), workload)
    config = harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json")
    mix = traffic.load(cell["traffic"])
    sf = float(config["scale_factor"] if scale_factor is None else scale_factor)
    tables = datagen.generate(sf, seed)
    limit = float(config["limits"]["max_rel_err"])
    checker = Checker(Reference(tables), tie=limit)
    ref32 = Reference(tables, np.float32)
    stream = traffic.instances(mix, config["templates"], seed)
    for _ in range(n_queries):
        t, p = next(stream)
        checker.check(t, p, control_answer(ref32, t, p))
    return {"workload": workload, "seed": seed, "scale_factor": sf, "queries": checker.checked,
            "max_rel_err": checker.max_rel_err, "wrong_rows": checker.wrong_rows,
            "limit": limit, "fails": checker.max_rel_err > limit or checker.wrong_rows > 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--queries", type=int, required=True)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control_readings(args.workload, seed, args.queries)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
