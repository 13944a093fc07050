"""The nine TPC-H-derived templates, computed straight from the tables.

Each template is written from its SQL meaning (Q1, Q3-Q10 as the
repository defines them: the same predicates, join keys, groups, sums and
ORDER BY), with no plan, no morsel and no shared state: every join is a
lookup of the probe row's key among the build side's unique keys, every
group a sort of the group keys, every sum a segmented sum. Results are
whole, before any LIMIT; ``TEMPLATES[t]`` says which columns are group
keys, how the rows are ordered and the LIMIT.

``Reference(tables, dtype)`` computes the measures (prices, discounts,
costs and their sums) in ``dtype``: float64 is the reference; float32 is
the control, the same arithmetic one precision lower. Keys, dates and
codes are compared exactly in either. NumPy only.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..datagen import days


class Template(NamedTuple):
    keys: Tuple[str, ...]  # group-key columns
    order: Tuple[Tuple[str, bool], ...]  # (column, ascending)
    limit: Optional[int]


TEMPLATES: Dict[str, Template] = {
    "q1": Template(("l_returnflag", "l_linestatus"),
                   (("l_returnflag", True), ("l_linestatus", True)), None),
    "q3": Template(("l_orderkey", "o_orderdate", "o_shippriority"),
                   (("revenue", False), ("o_orderdate", True)), 10),
    "q4": Template(("o_orderpriority",), (("o_orderpriority", True),), None),
    "q5": Template(("n_name",), (("revenue", False),), None),
    "q6": Template((), (), None),
    "q7": Template(("supp_nation", "cust_nation", "l_shipyear"),
                   (("supp_nation", True), ("cust_nation", True), ("l_shipyear", True)), None),
    "q8": Template(("o_orderyear",), (("o_orderyear", True),), None),
    "q9": Template(("n_name", "o_orderyear"), (("n_name", True), ("o_orderyear", False)), None),
    "q10": Template(("c_custkey", "n_name"), (("revenue", False),), 20),
}

Result = Dict[str, np.ndarray]


class Reference:
    """The templates over one database, with the lookups that every
    instance shares kept between calls."""

    def __init__(self, tables, dtype=np.float64):
        self.cols = {name: cols for name, (cols, _) in tables.items()}
        self.dtype = np.dtype(dtype)
        self._memo: Dict[object, np.ndarray] = {}

    # -- building blocks -------------------------------------------------------
    def col(self, table: str, name: str) -> np.ndarray:
        return self.cols[table][name]

    def measure(self, table: str, name: str) -> np.ndarray:
        """A value column in the arithmetic's precision."""
        key = ("measure", table, name)
        if key not in self._memo:
            self._memo[key] = self.col(table, name).astype(self.dtype)
        return self._memo[key]

    def row_of(self, table: str, key_col: str, keys: np.ndarray) -> np.ndarray:
        """The row of ``table`` whose ``key_col`` equals each key, or -1:
        an equi-join on a unique key."""
        memo = ("pos", table, key_col)
        pos = self._memo.get(memo)
        if pos is None:
            k = self.col(table, key_col).astype(np.int64)
            if k.min() < 0 or len(np.unique(k)) != len(k):
                raise ValueError(f"{table}.{key_col} is not a unique non-negative key")
            pos = np.full(int(k.max()) + 1, -1, dtype=np.int64)
            pos[k] = np.arange(len(k))
            self._memo[memo] = pos
        k = keys.astype(np.int64)
        inside = (k >= 0) & (k < len(pos))
        return np.where(inside, pos[np.clip(k, 0, len(pos) - 1)], -1)

    def lineitem_row_of(self, table: str, key_col: str, l_col: str) -> np.ndarray:
        """``row_of`` for every lineitem row's ``l_col``, kept."""
        memo = ("lrow", table, key_col, l_col)
        if memo not in self._memo:
            self._memo[memo] = self.row_of(table, key_col, self.col("lineitem", l_col))
        return self._memo[memo]

    def partsupp_row(self) -> np.ndarray:
        """Each lineitem row's partsupp row by (partkey, suppkey), or -1."""
        memo = ("ps_row",)
        if memo not in self._memo:
            pk = self.col("partsupp", "ps_partkey").astype(np.int64)
            sk = self.col("partsupp", "ps_suppkey").astype(np.int64)
            radix = int(max(sk.max(), self.col("lineitem", "l_suppkey").max())) + 1
            code = pk * radix + sk
            order = np.argsort(code, kind="stable")
            sc = code[order]
            if len(sc) > 1 and (sc[1:] == sc[:-1]).any():
                raise ValueError("partsupp (partkey, suppkey) is not unique")
            want = (self.col("lineitem", "l_partkey").astype(np.int64) * radix
                    + self.col("lineitem", "l_suppkey").astype(np.int64))
            at = np.clip(np.searchsorted(sc, want), 0, len(sc) - 1)
            self._memo[memo] = np.where(sc[at] == want, order[at], -1)
        return self._memo[memo]

    def lineitem_derived(self, name: str) -> np.ndarray:
        """Rows reached from every lineitem row through its order or its
        supplier, kept: ``customer`` (the order's customer, -1 if none),
        ``supp_nation`` and ``cust_nation`` (nation rows)."""
        memo = ("lderived", name)
        if memo not in self._memo:
            if name == "customer":
                ro = self.lineitem_row_of("orders", "o_orderkey", "l_orderkey")
                rc = self.row_of("customer", "c_custkey",
                                 self.col("orders", "o_custkey")[np.maximum(ro, 0)])
                v = np.where(ro >= 0, rc, -1)
            elif name == "supp_nation":
                rs = self.lineitem_row_of("supplier", "s_suppkey", "l_suppkey")
                v = np.where(rs >= 0, self.nation_of(
                    self.col("supplier", "s_nationkey")[np.maximum(rs, 0)]), -1)
            elif name == "cust_nation":
                rc = self.lineitem_derived("customer")
                v = np.where(rc >= 0, self.nation_of(
                    self.col("customer", "c_nationkey")[np.maximum(rc, 0)]), -1)
            else:
                raise KeyError(name)
            self._memo[memo] = v
        return self._memo[memo]

    def revenue(self) -> np.ndarray:
        """l_extendedprice * (1 - l_discount) of every lineitem row."""
        memo = ("revenue", self.dtype)
        if memo not in self._memo:
            one = self.dtype.type(1.0)
            self._memo[memo] = (self.measure("lineitem", "l_extendedprice")
                                * (one - self.measure("lineitem", "l_discount")))
        return self._memo[memo]

    def nation_of(self, nationkeys: np.ndarray) -> np.ndarray:
        """Nation rows of the given nation keys (every key exists)."""
        rows = self.row_of("nation", "n_nationkey", nationkeys)
        if (rows < 0).any():
            raise ValueError("a nation key without a nation")
        return rows

    def in_region(self, region: float) -> np.ndarray:
        """Per nation row: whether its region's r_name is ``region``."""
        reg_ok = self.col("region", "r_name") == region
        r = self.row_of("region", "r_regionkey", self.col("nation", "n_regionkey"))
        return (r >= 0) & reg_ok[np.maximum(r, 0)]

    def segsum(self, inv: np.ndarray, values: np.ndarray, n: int) -> np.ndarray:
        """Per group sums, accumulated in the arithmetic's precision."""
        if self.dtype == np.float64:
            return np.bincount(inv, weights=values, minlength=n)
        out = np.zeros(n, dtype=self.dtype)
        np.add.at(out, inv, values.astype(self.dtype))
        return out

    @staticmethod
    def groups(keys: Dict[str, np.ndarray]) -> Tuple[Result, np.ndarray, int]:
        """Distinct combinations of integer-valued key columns (sorted
        ascending by the columns in order) and each row's group."""
        names = list(keys)
        ints = []
        for k in names:
            v = keys[k]
            iv = v.astype(np.int64)
            if not np.array_equal(iv, v):
                raise ValueError(f"group key {k} is not integer-valued")
            ints.append(iv)
        code = np.zeros(len(ints[0]), dtype=np.int64)
        lows, radices = [], []
        for iv in ints:
            lo = int(iv.min()) if len(iv) else 0
            radix = (int(iv.max()) - lo + 1) if len(iv) else 1
            code = code * radix + (iv - lo)
            lows.append(lo)
            radices.append(radix)
        span = int(np.prod(radices, dtype=np.float64))
        if span <= max(1 << 22, 8 * len(code)):
            present = np.bincount(code, minlength=span) > 0
            uniq = np.flatnonzero(present)
            inv = (np.cumsum(present) - 1)[code]
        else:
            uniq, inv = np.unique(code, return_inverse=True)
        out: Result = {}
        rest = uniq.copy()
        for name, lo, radix in reversed(list(zip(names, lows, radices))):
            out[name] = (rest % radix + lo).astype(np.float64)
            rest //= radix
        return {k: out[k] for k in names}, inv.ravel(), len(uniq)

    def finish(self, template: str, res: Result) -> Result:
        """Rows in the template's ORDER BY order (LIMIT not applied)."""
        spec = TEMPLATES[template]
        n = len(next(iter(res.values())))
        cols = [res[c] if asc else -res[c] for c, asc in reversed(spec.order)]
        order = np.lexsort(cols) if cols else np.arange(n)
        return {k: v[order] for k, v in res.items()}

    # -- the templates ---------------------------------------------------------
    def run(self, template: str, params: Dict) -> Result:
        return self.finish(template, getattr(self, template)(params))

    def q1(self, p: Dict) -> Result:
        m = self.col("lineitem", "l_shipdate") <= days("1998-12-01") - p["delta"]
        out, inv, n = self.groups({k: self.col("lineitem", k)[m]
                                   for k in ("l_returnflag", "l_linestatus")})
        one = self.dtype.type(1.0)
        qty = self.measure("lineitem", "l_quantity")[m]
        ext = self.measure("lineitem", "l_extendedprice")[m]
        disc = self.measure("lineitem", "l_discount")[m]
        tax = self.measure("lineitem", "l_tax")[m]
        disc_price = ext * (one - disc)
        cnt = np.bincount(inv, minlength=n).astype(np.float64)
        out["sum_qty"] = self.segsum(inv, qty, n)
        out["sum_base_price"] = self.segsum(inv, ext, n)
        out["sum_disc_price"] = self.segsum(inv, disc_price, n)
        out["sum_charge"] = self.segsum(inv, disc_price * (one + tax), n)
        out["avg_qty"] = out["sum_qty"] / cnt
        out["avg_price"] = out["sum_base_price"] / cnt
        out["avg_disc"] = self.segsum(inv, disc, n) / cnt
        out["count_order"] = cnt
        return out

    def q3(self, p: Dict) -> Result:
        seg, date = p["segment"], p["date"]
        ro = self.lineitem_row_of("orders", "o_orderkey", "l_orderkey")
        m = (self.col("lineitem", "l_shipdate") > date) & (ro >= 0)
        ro = np.where(m, ro, 0)
        m &= self.col("orders", "o_orderdate")[ro] < date
        rc = self.row_of("customer", "c_custkey", self.col("orders", "o_custkey")[ro])
        m &= rc >= 0
        m &= self.col("customer", "c_mktsegment")[np.maximum(rc, 0)] == seg
        ro = ro[m]
        out, inv, n = self.groups({
            "l_orderkey": self.col("lineitem", "l_orderkey")[m],
            "o_orderdate": self.col("orders", "o_orderdate")[ro],
            "o_shippriority": self.col("orders", "o_shippriority")[ro],
        })
        out["revenue"] = self.segsum(inv, self.revenue()[m], n)
        return out

    def q4(self, p: Dict) -> Result:
        d0 = p["date"]
        d1 = d0 + 92
        ro = self.lineitem_row_of("orders", "o_orderkey", "l_orderkey")
        m = (self.col("lineitem", "l_commitdate") < self.col("lineitem", "l_receiptdate")) & (ro >= 0)
        od = self.col("orders", "o_orderdate")[np.maximum(ro, 0)]
        m &= (od >= d0) & (od < d1)
        ro = ro[m]
        pri = self.col("orders", "o_orderpriority")[ro]
        okey = self.col("orders", "o_orderkey")[ro]
        out, inv, n = self.groups({"o_orderpriority": pri})
        radix = int(okey.max()) + 1 if len(okey) else 1
        pairs = np.unique(inv.astype(np.int64) * radix + okey.astype(np.int64))
        out["order_count"] = np.bincount(pairs // radix, minlength=n).astype(np.float64)
        return out

    def q5(self, p: Dict) -> Result:
        region, d0 = p["region"], p["date"]
        d1 = d0 + 365
        ro = self.lineitem_row_of("orders", "o_orderkey", "l_orderkey")
        sn = self.lineitem_derived("supp_nation")
        cn = self.lineitem_derived("cust_nation")
        od = self.col("orders", "o_orderdate")[np.maximum(ro, 0)]
        m = (ro >= 0) & (od >= d0) & (od < d1) & (sn >= 0) & (cn >= 0)
        n_key = self.col("nation", "n_nationkey")
        m &= n_key[np.maximum(cn, 0)] == n_key[np.maximum(sn, 0)]  # c_nationkey = s_nationkey
        m &= self.in_region(region)[np.maximum(sn, 0)]
        out, inv, n = self.groups({"n_name": self.col("nation", "n_name")[sn[m]]})
        out["revenue"] = self.segsum(inv, self.revenue()[m], n)
        return out

    def q6(self, p: Dict) -> Result:
        d0, disc, qty = p["date"], p["discount"], p["quantity"]
        ship = self.col("lineitem", "l_shipdate")
        ld = self.col("lineitem", "l_discount")
        m = ((ship >= d0) & (ship < d0 + 365)
             & (ld >= round(disc - 0.01, 4)) & (ld <= round(disc + 0.01, 4))
             & (self.col("lineitem", "l_quantity") < qty))
        v = self.measure("lineitem", "l_extendedprice")[m] * self.measure("lineitem", "l_discount")[m]
        return {"revenue": self.segsum(np.zeros(len(v), dtype=np.int64), v, 1)}

    def q7(self, p: Dict) -> Result:
        pair = (p["nation1"], p["nation2"])
        n_name = self.col("nation", "n_name")
        in_pair = (n_name == pair[0]) | (n_name == pair[1])
        ship = self.col("lineitem", "l_shipdate")
        sn = self.lineitem_derived("supp_nation")
        cn = self.lineitem_derived("cust_nation")
        m = (ship >= days("1995-01-01")) & (ship <= days("1996-12-31")) & (sn >= 0) & (cn >= 0)
        m &= in_pair[np.maximum(sn, 0)] & in_pair[np.maximum(cn, 0)]
        supp_nation, cust_nation = n_name[sn[m]], n_name[cn[m]]
        keep = supp_nation != cust_nation
        out, inv, n = self.groups({
            "supp_nation": supp_nation[keep],
            "cust_nation": cust_nation[keep],
            "l_shipyear": self.col("lineitem", "l_shipyear")[m][keep],
        })
        out["revenue"] = self.segsum(inv, self.revenue()[m][keep], n)
        return out

    def q8(self, p: Dict) -> Result:
        ptype, nation, region = p["type"], p["nation"], p["region"]
        rp = self.lineitem_row_of("part", "p_partkey", "l_partkey")
        rs = self.lineitem_row_of("supplier", "s_suppkey", "l_suppkey")
        ro = self.lineitem_row_of("orders", "o_orderkey", "l_orderkey")
        m = (rp >= 0) & (rs >= 0) & (ro >= 0)
        m &= self.col("part", "p_type")[np.maximum(rp, 0)] == ptype
        od = self.col("orders", "o_orderdate")[np.maximum(ro, 0)]
        m &= (od >= days("1995-01-01")) & (od <= days("1996-12-31"))
        ro = ro[m]
        rc = self.row_of("customer", "c_custkey", self.col("orders", "o_custkey")[ro])
        ok = rc >= 0
        cn = self.nation_of(self.col("customer", "c_nationkey")[np.maximum(rc, 0)])
        ok &= self.in_region(region)[cn]
        sn = self.nation_of(self.col("supplier", "s_nationkey")[rs[m]])
        rev = self.revenue()[m][ok]
        supp_nation = self.col("nation", "n_name")[sn][ok]
        out, inv, n = self.groups({"o_orderyear": self.col("orders", "o_orderyear")[ro][ok]})
        zero = self.dtype.type(0.0)
        out["nation_volume"] = self.segsum(inv, np.where(supp_nation == nation, rev, zero), n)
        out["total_volume"] = self.segsum(inv, rev, n)
        return out

    def q9(self, p: Dict) -> Result:
        rp = self.lineitem_row_of("part", "p_partkey", "l_partkey")
        rps = self.partsupp_row()
        rs = self.lineitem_row_of("supplier", "s_suppkey", "l_suppkey")
        ro = self.lineitem_row_of("orders", "o_orderkey", "l_orderkey")
        m = (rp >= 0) & (rps >= 0) & (rs >= 0) & (ro >= 0)
        m &= self.col("part", "p_colorcode")[np.maximum(rp, 0)] == p["color"]
        sn = self.nation_of(self.col("supplier", "s_nationkey")[rs[m]])
        cost = self.measure("partsupp", "ps_supplycost")[rps[m]]
        profit = self.revenue()[m] - cost * self.measure("lineitem", "l_quantity")[m]
        out, inv, n = self.groups({
            "n_name": self.col("nation", "n_name")[sn],
            "o_orderyear": self.col("orders", "o_orderyear")[ro[m]],
        })
        out["sum_profit"] = self.segsum(inv, profit, n)
        return out

    def q10(self, p: Dict) -> Result:
        d0 = p["date"]
        d1 = d0 + 92
        ro = self.lineitem_row_of("orders", "o_orderkey", "l_orderkey")
        m = (self.col("lineitem", "l_returnflag") == 0.0) & (ro >= 0)
        od = self.col("orders", "o_orderdate")[np.maximum(ro, 0)]
        m &= (od >= d0) & (od < d1)
        rc = self.row_of("customer", "c_custkey", self.col("orders", "o_custkey")[ro[m]])
        ok = rc >= 0
        rc = rc[ok]
        rn = self.nation_of(self.col("customer", "c_nationkey")[rc])
        out, inv, n = self.groups({
            "c_custkey": self.col("customer", "c_custkey")[rc],
            "n_name": self.col("nation", "n_name")[rn],
        })
        out["revenue"] = self.segsum(inv, self.revenue()[m][ok], n)
        acct = np.full(n, -np.inf, dtype=self.dtype)
        np.maximum.at(acct, inv, self.measure("customer", "c_acctbal")[rc])
        out["c_acctbal"] = acct
        return out


def instance_key(template: str, params: Dict) -> Tuple:
    return (template,) + tuple(sorted((k, float(v)) for k, v in params.items()))


def measures(template: str, res: Result) -> List[str]:
    keys = set(TEMPLATES[template].keys)
    return [c for c in res if c not in keys]
