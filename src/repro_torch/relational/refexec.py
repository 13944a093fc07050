"""Reference plan executor — the correctness oracle for the engine.

Executes a physical plan directly with vectorized numpy (no sharing, no
morsels, no visibility machinery). Engine results in every mode must match
this executor exactly; the property tests assert it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..core.plans import Aggregate, HashJoin, OrderBy, PlanNode, Scan, expr_eval
from ..core.predicates import TRUE, evaluate
from .table import Database


def execute(db: Database, plan: PlanNode) -> Dict[str, np.ndarray]:
    cols = _exec(db, plan)
    return cols


def _exec(db: Database, node: PlanNode) -> Dict[str, np.ndarray]:
    if isinstance(node, Scan):
        t = db[node.table]
        mask = evaluate(node.pred, t.columns)
        return {k: v[mask] for k, v in t.columns.items()}
    if isinstance(node, HashJoin):
        build = _exec(db, node.build)
        probe = _exec(db, node.probe)
        bkeys = _codes(build, node.build_keys)
        pkeys = _codes(probe, node.probe_keys)
        order = np.argsort(bkeys, kind="stable")
        sb = bkeys[order]
        lo = np.searchsorted(sb, pkeys, "left")
        hi = np.searchsorted(sb, pkeys, "right")
        counts = hi - lo
        total = int(counts.sum())
        pidx = np.repeat(np.arange(len(pkeys)), counts)
        starts = np.repeat(lo, counts)
        offs = np.arange(total) - np.repeat(np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
        bidx = order[starts + offs]
        out = {k: v[pidx] for k, v in probe.items()}
        names = node.payload_as if node.payload_as is not None else node.payload
        for a, o in zip(node.payload, names):
            out[o] = build[a][bidx]
        if node.post_filter is not TRUE:
            m = evaluate(node.post_filter, out)
            out = {k: v[m] for k, v in out.items()}
        return out
    if isinstance(node, Aggregate):
        rows = _exec(db, node.input)
        n = len(next(iter(rows.values()))) if rows else 0
        if node.group_keys:
            stacked = np.stack([rows[k] for k in node.group_keys], axis=1)
            uniq, inv = np.unique(stacked, axis=0, return_inverse=True)
            inv = np.asarray(inv).ravel()
            ng = len(uniq)
        else:
            uniq = np.zeros((1, 0))
            inv = np.zeros(n, dtype=np.int64)
            ng = 1
        out: Dict[str, np.ndarray] = {}
        for i, k in enumerate(node.group_keys):
            out[k] = uniq[:, i]
        cnt = np.bincount(inv, minlength=ng).astype(np.float64)
        for spec in node.aggs:
            vals = None
            if spec.expr is not None:
                vals = np.broadcast_to(
                    np.asarray(expr_eval(spec.expr, rows), dtype=np.float64), (n,)
                )
            if spec.distinct:
                pairs = np.stack([inv.astype(np.float64), vals], axis=1)
                up = np.unique(pairs, axis=0)
                out[spec.name] = np.bincount(
                    up[:, 0].astype(np.int64), minlength=ng
                ).astype(np.float64)
            elif spec.func == "count":
                out[spec.name] = cnt.copy()
            elif spec.func == "sum":
                out[spec.name] = np.bincount(inv, weights=vals, minlength=ng)
            elif spec.func == "avg":
                s = np.bincount(inv, weights=vals, minlength=ng)
                out[spec.name] = s / np.maximum(cnt, 1e-300)
            elif spec.func == "min":
                acc = np.full(ng, np.inf)
                np.minimum.at(acc, inv, vals)
                out[spec.name] = acc
            elif spec.func == "max":
                acc = np.full(ng, -np.inf)
                np.maximum.at(acc, inv, vals)
                out[spec.name] = acc
            else:
                raise ValueError(spec.func)
        return out
    if isinstance(node, OrderBy):
        res = _exec(db, node.input)
        if not res:
            return res
        n = len(next(iter(res.values())))
        keys = []
        for k, asc in zip(reversed(node.keys), reversed(node.ascending)):
            keys.append(res[k] if asc else -res[k])
        order = np.lexsort(keys) if keys else np.arange(n)
        if node.limit is not None:
            order = order[: node.limit]
        return {k: v[order] for k, v in res.items()}
    raise TypeError(node)


def _codes(cols: Dict[str, np.ndarray], attrs: Tuple[str, ...]) -> np.ndarray:
    code = np.asarray(cols[attrs[0]], dtype=np.int64)
    for a in attrs[1:]:
        code = code * np.int64(1 << 21) + np.asarray(cols[a], dtype=np.int64)
    return code
