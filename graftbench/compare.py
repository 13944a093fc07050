"""The comparison that decides ``correct``.

Each query the window completed is held against the plain reference's
answer to the same (template, params) on the same tables
(``reference.tpch_queries``). Three numbers come out, each with a limit:

* ``max_rel_err``: the widest gap of any measure, as a share of the
  largest magnitude in the reference's column (so a sum that cancels to
  near zero is judged on its column's scale);
* ``wrong_rows``: rows missing, extra, out of order, or with a group key
  the reference does not have; for a LIMIT query, a row outside the
  reference's top rows unless its sort value ties the last kept one
  within ``max_rel_err``'s limit;
* ``never_done``: queries due in the window that never completed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .reference.tpch_queries import TEMPLATES, Reference, Result, instance_key


def _row_keys(res: Result, keys) -> list:
    n = len(next(iter(res.values()))) if res else 0
    return [tuple(float(res[k][i]) for k in keys) for i in range(n)]


def _sort_values(res: Result, order) -> np.ndarray:
    """Rows' ORDER BY values as columns (descending ones negated)."""
    return np.stack([res[c] if asc else -res[c] for c, asc in order], axis=1) if order else None


def compare_one(template: str, got: Result, want: Result, tie: float) -> Tuple[float, int]:
    """(max_rel_err, wrong_rows) of one answer against the reference's
    whole, ordered result."""
    spec = TEMPLATES[template]
    if set(got) != set(want):
        return float("inf"), max(1, len(next(iter(want.values()))) if want else 1)
    n_want = len(next(iter(want.values())))
    n_got = len(next(iter(got.values())))
    n_keep = n_want if spec.limit is None else min(spec.limit, n_want)
    wrong = abs(n_got - n_keep)
    index = {k: i for i, k in enumerate(_row_keys(want, spec.keys))}
    measures = [c for c in want if c not in spec.keys]
    scale = {c: max(float(np.abs(want[c]).max()) if n_want else 0.0, 1e-300) for c in measures}
    err = 0.0
    rows = []
    for i, key in enumerate(_row_keys(got, spec.keys)):
        j = index.get(key)
        if j is None:
            wrong += 1
            continue
        rows.append(j)
        for c in measures:
            err = max(err, abs(float(got[c][i]) - float(want[c][j])) / scale[c])
    # the answer's own order must be its ORDER BY
    if spec.order and n_got > 1:
        sv = _sort_values(got, spec.order)
        for a in range(n_got - 1):
            if tuple(sv[a]) > tuple(sv[a + 1]):
                wrong += 1
    # a LIMIT keeps the reference's top rows, ties at the cut aside
    if spec.limit is not None and n_want > n_keep:
        sort_col = spec.order[0][0]
        cut = float(want[sort_col][n_keep - 1])
        col_scale = max(float(np.abs(want[sort_col]).max()), 1e-300)
        for j in rows:
            if j >= n_keep and abs(float(want[sort_col][j]) - cut) > tie * col_scale:
                wrong += 1
    return err, wrong


class Checker:
    """Reference answers kept per distinct instance, and the worst numbers
    over every answer checked."""

    def __init__(self, reference: Reference, tie: float):
        self.reference = reference
        self.tie = tie
        self._answers: Dict[Tuple, Result] = {}
        self.max_rel_err = 0.0
        self.wrong_rows = 0
        self.checked = 0

    def answer(self, template: str, params: Dict) -> Result:
        key = instance_key(template, params)
        if key not in self._answers:
            self._answers[key] = self.reference.run(template, params)
        return self._answers[key]

    def check(self, template: str, params: Dict, got: Result) -> None:
        err, wrong = compare_one(template, got, self.answer(template, params), self.tie)
        self.max_rel_err = max(self.max_rel_err, err)
        self.wrong_rows += wrong
        self.checked += 1
