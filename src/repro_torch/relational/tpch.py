"""TPC-H-derived data generator (statistical reimplementation of dbgen).

Generates the eight TPC-H tables with dbgen's cardinalities, key structure,
and value distributions (uniform dates over the 1992-1998 window, segment /
priority / flag categoricals, FK joins), scaled by SF. Not byte-identical to
dbgen — the paper's workloads only need statistically-faithful instances
(template parameters are sampled uniformly from large domains; overlap comes
from operator requirements, not from exact rows).

Keys are dense 0..N-1 row indices (orderkey == orders row index etc.), which
gives collision-free derivation identifiers and mixed-radix join-key
encodings for the shared-state machinery.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .table import Database, Table, days

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
ORDER_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
RETURN_FLAGS = ["R", "A", "N"]
LINE_STATUS = ["O", "F"]
SHIP_MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1), ("EGYPT", 4),
    ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3), ("INDIA", 2), ("INDONESIA", 2),
    ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0),
    ("MOROCCO", 0), ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1),
]
# part "colors" used by Q9's p_name LIKE '%<color>%' (dbgen draws part names
# from a 92-word list; we use 25 so the ~4% selectivity is comparable).
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "green",
]
TYPE_SYLL1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_SYLL2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_SYLL3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
TYPES = [f"{a} {b} {c}" for a in TYPE_SYLL1 for b in TYPE_SYLL2 for c in TYPE_SYLL3]

MIN_DATE = days("1992-01-01")  # == 0
MAX_ORDER_DATE = days("1998-08-02")
END_DATE = days("1998-12-31")


def generate(scale_factor: float = 0.05, seed: int = 7, clustered: bool = False) -> Database:
    """``clustered=True`` sorts orders by o_orderdate and lineitem by
    l_shipdate (time-ordered ingest, typical of real warehouses) — this is
    what makes zone-map morsel skipping effective (§Perf)."""
    rng = np.random.default_rng(seed)
    sf = scale_factor

    n_supp = max(int(10_000 * sf), 50)
    n_part = max(int(200_000 * sf), 200)
    n_cust = max(int(150_000 * sf), 150)
    n_ord = max(int(1_500_000 * sf), 1500)
    n_ps_per_part = 4

    tables: Dict[str, Table] = {}

    # -- region / nation ----------------------------------------------------
    tables["region"] = Table(
        "region",
        {
            "r_regionkey": np.arange(5, dtype=np.float64),
            "r_name": np.arange(5, dtype=np.float64),
        },
        {"r_name": REGIONS},
    )
    tables["nation"] = Table(
        "nation",
        {
            "n_nationkey": np.arange(25, dtype=np.float64),
            "n_name": np.arange(25, dtype=np.float64),
            "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.float64),
        },
        {"n_name": [n for n, _ in NATIONS]},
    )

    # -- supplier -------------------------------------------------------------
    tables["supplier"] = Table(
        "supplier",
        {
            "s_suppkey": np.arange(n_supp, dtype=np.float64),
            "s_nationkey": rng.integers(0, 25, n_supp).astype(np.float64),
            "s_acctbal": rng.uniform(-999.99, 9999.99, n_supp),
        },
    )

    # -- part ------------------------------------------------------------------
    tables["part"] = Table(
        "part",
        {
            "p_partkey": np.arange(n_part, dtype=np.float64),
            "p_colorcode": rng.integers(0, len(COLORS), n_part).astype(np.float64),
            "p_type": rng.integers(0, len(TYPES), n_part).astype(np.float64),
            "p_size": rng.integers(1, 51, n_part).astype(np.float64),
            "p_retailprice": 900.0 + rng.uniform(0, 1200, n_part),
        },
        {"p_colorcode": COLORS, "p_type": TYPES},
    )

    # -- partsupp (each part has 4 suppliers) ----------------------------------
    ps_part = np.repeat(np.arange(n_part), n_ps_per_part)
    ps_supp = (
        (ps_part * 13 + np.tile(np.arange(n_ps_per_part), n_part) * (n_supp // n_ps_per_part + 1))
        % n_supp
    )
    tables["partsupp"] = Table(
        "partsupp",
        {
            "ps_partkey": ps_part.astype(np.float64),
            "ps_suppkey": ps_supp.astype(np.float64),
            "ps_supplycost": rng.uniform(1.0, 1000.0, len(ps_part)),
            "ps_availqty": rng.integers(1, 10_000, len(ps_part)).astype(np.float64),
        },
    )

    # -- customer ----------------------------------------------------------------
    tables["customer"] = Table(
        "customer",
        {
            "c_custkey": np.arange(n_cust, dtype=np.float64),
            "c_mktsegment": rng.integers(0, 5, n_cust).astype(np.float64),
            "c_nationkey": rng.integers(0, 25, n_cust).astype(np.float64),
            "c_acctbal": rng.uniform(-999.99, 9999.99, n_cust),
        },
        {"c_mktsegment": SEGMENTS},
    )

    # -- orders ---------------------------------------------------------------------
    o_orderdate = rng.integers(MIN_DATE, MAX_ORDER_DATE + 1, n_ord).astype(np.float64)
    tables["orders"] = Table(
        "orders",
        {
            "o_orderkey": np.arange(n_ord, dtype=np.float64),
            "o_custkey": rng.integers(0, n_cust, n_ord).astype(np.float64),
            "o_orderdate": o_orderdate,
            "o_orderyear": (1992 + o_orderdate // 365.25).astype(np.float64),
            "o_shippriority": np.zeros(n_ord),
            "o_orderpriority": rng.integers(0, 5, n_ord).astype(np.float64),
            "o_totalprice": rng.uniform(850.0, 560_000.0, n_ord),
        },
        {"o_orderpriority": ORDER_PRIORITIES},
    )

    # -- lineitem (1..7 lines per order) ----------------------------------------------
    lines_per_order = rng.integers(1, 8, n_ord)
    l_orderkey = np.repeat(np.arange(n_ord), lines_per_order)
    n_li = len(l_orderkey)
    l_partkey = rng.integers(0, n_part, n_li)
    # pick one of the 4 suppliers of the part (FK-consistent with partsupp)
    psi = rng.integers(0, n_ps_per_part, n_li)
    l_suppkey = (l_partkey * 13 + psi * (n_supp // n_ps_per_part + 1)) % n_supp
    ship_lag = rng.integers(1, 122, n_li)
    l_shipdate = o_orderdate[l_orderkey] + ship_lag
    l_commitdate = o_orderdate[l_orderkey] + rng.integers(30, 91, n_li)
    l_receiptdate = l_shipdate + rng.integers(1, 31, n_li)
    quantity = rng.integers(1, 51, n_li).astype(np.float64)
    extprice = quantity * (900.0 + rng.uniform(0, 1200, n_li)) / 10.0
    # dbgen: returnflag = R|A (50/50) when receipt <= 1995-06-17 else N
    cutoff = days("1995-06-17")
    rflag = np.where(
        l_receiptdate <= cutoff, rng.integers(0, 2, n_li), 2
    ).astype(np.float64)
    lstatus = np.where(l_shipdate > days("1995-06-17"), 0, 1).astype(np.float64)

    if clustered:
        operm = np.argsort(o_orderdate, kind="stable")
        inv = np.empty_like(operm)
        inv[operm] = np.arange(n_ord)
        ot = tables["orders"]
        ot.columns = {k: v[operm] for k, v in ot.columns.items()}
        ot.columns["o_orderkey"] = np.arange(n_ord, dtype=np.float64)
        l_orderkey = inv[l_orderkey]
        o_orderdate = o_orderdate[operm]
        lperm = np.argsort(l_shipdate, kind="stable")
        (l_orderkey, l_partkey, l_suppkey, l_shipdate, l_commitdate, l_receiptdate,
         quantity, extprice, rflag, lstatus, psi, ship_lag) = (
            a[lperm] for a in (
                l_orderkey, l_partkey, l_suppkey, l_shipdate, l_commitdate,
                l_receiptdate, quantity, extprice, rflag, lstatus, psi, ship_lag,
            )
        )

    tables["lineitem"] = Table(
        "lineitem",
        {
            "l_orderkey": l_orderkey.astype(np.float64),
            "l_partkey": l_partkey.astype(np.float64),
            "l_suppkey": l_suppkey.astype(np.float64),
            "l_quantity": quantity,
            "l_extendedprice": extprice,
            "l_discount": rng.integers(0, 11, n_li).astype(np.float64) / 100.0,
            "l_tax": rng.integers(0, 9, n_li).astype(np.float64) / 100.0,
            "l_returnflag": rflag,
            "l_linestatus": lstatus,
            "l_shipdate": l_shipdate.astype(np.float64),
            "l_shipyear": (1992 + l_shipdate // 365.25).astype(np.float64),
            "l_commitdate": l_commitdate.astype(np.float64),
            "l_receiptdate": l_receiptdate.astype(np.float64),
            "l_shipmode": rng.integers(0, 7, n_li).astype(np.float64),
        },
        {"l_returnflag": RETURN_FLAGS, "l_linestatus": LINE_STATUS, "l_shipmode": SHIP_MODES},
    )

    return Database(tables, sf)


_cache: Dict = {}


def get_database(scale_factor: float = 0.05, seed: int = 7, clustered: bool = False) -> Database:
    key = (scale_factor, seed, clustered)
    if key not in _cache:
        _cache[key] = generate(scale_factor, seed, clustered)
    return _cache[key]
