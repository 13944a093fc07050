"""Columnar tables.

All columns are encoded into comparable scalar float64/int64 domains up
front (dates -> int days since 1992-01-01, strings -> dictionary codes), so
the predicate prover and the vectorized/Pallas data plane see numbers only.
Dictionaries are kept on the table for decoding results.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Table:
    name: str
    columns: Dict[str, np.ndarray]
    dictionaries: Dict[str, List[str]] = field(default_factory=dict)
    _zones: Dict = field(default_factory=dict, repr=False)

    @property
    def nrows(self) -> int:
        return len(next(iter(self.columns.values())))

    def morsel(self, start: int, size: int) -> Dict[str, np.ndarray]:
        end = min(start + size, self.nrows)
        return {k: v[start:end] for k, v in self.columns.items()}

    def zone_map(self, morsel_size: int) -> Dict[str, "np.ndarray"]:
        """Per-morsel (min, max) per column — built lazily, cached per
        morsel size. Used by zone-map morsel skipping (beyond-paper)."""
        zm = self._zones.get(morsel_size)
        if zm is None:
            n = self.nrows
            nm = max(1, -(-n // morsel_size))
            bounds = np.arange(0, nm * morsel_size, morsel_size)
            zm = {}
            for k, col in self.columns.items():
                mins = np.minimum.reduceat(col, bounds)
                maxs = np.maximum.reduceat(col, bounds)
                zm[k] = (mins, maxs)
            self._zones[morsel_size] = zm
        return zm

    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns.values())

    def code(self, column: str, value: str) -> int:
        return self.dictionaries[column].index(value)


class Database:
    def __init__(self, tables: Dict[str, Table], scale_factor: float):
        self.tables = tables
        self.scale_factor = scale_factor

    def __getitem__(self, name: str) -> Table:
        return self.tables[name]

    def nbytes(self) -> int:
        return sum(t.nbytes() for t in self.tables.values())


def database_from_numpy(tables, scale_factor: float) -> Database:
    """Build a ``Database`` from plain column arrays.

    ``tables`` maps a table name to ``(columns, dictionaries)``, or to any
    object with ``columns`` and ``dictionaries`` attributes (such as another
    engine's ``Table``). Columns are copied, so both databases can be read
    side by side without sharing buffers."""
    out: Dict[str, Table] = {}
    for name, t in tables.items():
        cols, dicts = (t.columns, t.dictionaries) if hasattr(t, "columns") else t
        out[name] = Table(
            name,
            {k: np.array(v, copy=True) for k, v in cols.items()},
            {k: list(v) for k, v in dicts.items()},
        )
    return Database(out, scale_factor)


DATE_EPOCH = "1992-01-01"


def days(datestr: str) -> int:
    """Encode 'YYYY-MM-DD' as int days since 1992-01-01."""
    y, m, d = map(int, datestr.split("-"))
    return (np.datetime64(f"{y:04d}-{m:02d}-{d:02d}") - np.datetime64(DATE_EPOCH)).astype(int)
