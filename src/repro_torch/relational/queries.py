"""TPC-H query templates Q1 and Q3-Q10 as parameterized physical plans.

A query instance is a template with concrete parameter values (paper §6.1).
Template parameters are sampled uniformly from the benchmark's domains, so
exact duplicates are rare — overlap comes from related templates and
compatible operator requirements. Q2 is omitted (correlated subquery,
outside the supported plan class — same as the paper).

Each builder returns a fixed physical plan (join order pinned per template,
mirroring the paper's PostgreSQL-pinned plans); workload parameters change
only predicates and constants.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.plans import (
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
from ..core.predicates import And, Cmp, ColCmp, InSet, TRUE, pred_and
from .table import Database, days
from .tpch import COLORS, NATIONS, REGIONS, SEGMENTS, TYPES

REVENUE = BinOp("*", Col("l_extendedprice"), BinOp("-", Const(1.0), Col("l_discount")))


def _first_of_month(year: int, month: int) -> int:
    return days(f"{year:04d}-{month:02d}-01")


# ---------------------------------------------------------------------------
# Template builders: (db, params) -> plan
# ---------------------------------------------------------------------------


def q1_plan(db: Database, p: Dict) -> object:
    cutoff = days("1998-12-01") - p["delta"]
    scan = Scan(
        "lineitem",
        Cmp("l_shipdate", "<=", cutoff),
        (
            "l_returnflag",
            "l_linestatus",
            "l_quantity",
            "l_extendedprice",
            "l_discount",
            "l_tax",
            "l_shipdate",
        ),
    )
    disc_price = REVENUE
    charge = BinOp("*", disc_price, BinOp("+", Const(1.0), Col("l_tax")))
    agg = Aggregate(
        scan,
        ("l_returnflag", "l_linestatus"),
        (
            AggSpec("sum", Col("l_quantity"), name="sum_qty"),
            AggSpec("sum", Col("l_extendedprice"), name="sum_base_price"),
            AggSpec("sum", disc_price, name="sum_disc_price"),
            AggSpec("sum", charge, name="sum_charge"),
            AggSpec("avg", Col("l_quantity"), name="avg_qty"),
            AggSpec("avg", Col("l_extendedprice"), name="avg_price"),
            AggSpec("avg", Col("l_discount"), name="avg_disc"),
            AggSpec("count", None, name="count_order"),
        ),
    )
    return OrderBy(agg, ("l_returnflag", "l_linestatus"), (True, True))


def q3_plan(db: Database, p: Dict) -> object:
    seg, date = p["segment"], p["date"]
    customer = Scan("customer", Cmp("c_mktsegment", "==", seg), ("c_custkey",))
    orders = Scan(
        "orders",
        Cmp("o_orderdate", "<", date),
        ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"),
    )
    order_side = HashJoin(customer, orders, ("c_custkey",), ("o_custkey",), ())
    lineitem = Scan(
        "lineitem",
        Cmp("l_shipdate", ">", date),
        ("l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"),
    )
    join = HashJoin(
        order_side, lineitem, ("o_orderkey",), ("l_orderkey",), ("o_orderdate", "o_shippriority")
    )
    agg = Aggregate(
        join,
        ("l_orderkey", "o_orderdate", "o_shippriority"),
        (AggSpec("sum", REVENUE, name="revenue"),),
    )
    return OrderBy(agg, ("revenue", "o_orderdate"), (False, True), limit=10)


def q4_plan(db: Database, p: Dict) -> object:
    d0 = p["date"]
    d1 = d0 + 92  # + 3 months
    orders = Scan(
        "orders",
        And((Cmp("o_orderdate", ">=", d0), Cmp("o_orderdate", "<", d1))),
        ("o_orderkey", "o_orderpriority"),
    )
    lineitem = Scan(
        "lineitem",
        ColCmp("l_commitdate", "<", "l_receiptdate"),
        ("l_orderkey", "l_commitdate", "l_receiptdate"),
    )
    join = HashJoin(orders, lineitem, ("o_orderkey",), ("l_orderkey",), ("o_orderpriority", "o_orderkey"))
    agg = Aggregate(
        join,
        ("o_orderpriority",),
        (AggSpec("count", Col("o_orderkey"), distinct=True, name="order_count"),),
    )
    return OrderBy(agg, ("o_orderpriority",), (True,))


def q5_plan(db: Database, p: Dict) -> object:
    region, d0 = p["region"], p["date"]
    d1 = d0 + 365
    nat_reg = HashJoin(
        Scan("region", Cmp("r_name", "==", region), ("r_regionkey",)),
        Scan("nation", TRUE, ("n_nationkey", "n_regionkey", "n_name")),
        ("r_regionkey",),
        ("n_regionkey",),
        (),
    )
    customer = Scan("customer", TRUE, ("c_custkey", "c_nationkey"))
    orders = Scan(
        "orders",
        And((Cmp("o_orderdate", ">=", d0), Cmp("o_orderdate", "<", d1))),
        ("o_orderkey", "o_custkey"),
    )
    order_side = HashJoin(
        customer, orders, ("c_custkey",), ("o_custkey",), ("c_nationkey",)
    )
    supplier = Scan("supplier", TRUE, ("s_suppkey", "s_nationkey"))
    lineitem = Scan(
        "lineitem", TRUE, ("l_orderkey", "l_suppkey", "l_extendedprice", "l_discount")
    )
    j1 = HashJoin(order_side, lineitem, ("o_orderkey",), ("l_orderkey",), ("c_nationkey",))
    j2 = HashJoin(
        supplier,
        j1,
        ("s_suppkey",),
        ("l_suppkey",),
        ("s_nationkey",),
        post_filter=ColCmp("c_nationkey", "==", "s_nationkey"),
    )
    j3 = HashJoin(nat_reg, j2, ("n_nationkey",), ("s_nationkey",), ("n_name",))
    agg = Aggregate(j3, ("n_name",), (AggSpec("sum", REVENUE, name="revenue"),))
    return OrderBy(agg, ("revenue",), (False,))


def q6_plan(db: Database, p: Dict) -> object:
    d0, disc, qty = p["date"], p["discount"], p["quantity"]
    scan = Scan(
        "lineitem",
        And(
            (
                Cmp("l_shipdate", ">=", d0),
                Cmp("l_shipdate", "<", d0 + 365),
                Cmp("l_discount", ">=", round(disc - 0.01, 4)),
                Cmp("l_discount", "<=", round(disc + 0.01, 4)),
                Cmp("l_quantity", "<", qty),
            )
        ),
        ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice"),
    )
    agg = Aggregate(
        scan, (), (AggSpec("sum", BinOp("*", Col("l_extendedprice"), Col("l_discount")), name="revenue"),)
    )
    return OrderBy(agg, (), ())


def q7_plan(db: Database, p: Dict) -> object:
    n1, n2 = p["nation1"], p["nation2"]
    pair = InSet("n_name", frozenset((float(n1), float(n2))))
    supp_side = HashJoin(
        Scan("nation", pair, ("n_nationkey", "n_name")),
        Scan("supplier", TRUE, ("s_suppkey", "s_nationkey")),
        ("n_nationkey",),
        ("s_nationkey",),
        ("n_name",),
    )
    cust_side = HashJoin(
        Scan("nation", pair, ("n_nationkey", "n_name")),
        Scan("customer", TRUE, ("c_custkey", "c_nationkey")),
        ("n_nationkey",),
        ("c_nationkey",),
        ("n_name",),
    )
    orders = Scan("orders", TRUE, ("o_orderkey", "o_custkey"))
    lineitem = Scan(
        "lineitem",
        And(
            (
                Cmp("l_shipdate", ">=", days("1995-01-01")),
                Cmp("l_shipdate", "<=", days("1996-12-31")),
            )
        ),
        ("l_orderkey", "l_suppkey", "l_shipyear", "l_extendedprice", "l_discount"),
    )
    j1 = HashJoin(
        supp_side, lineitem, ("s_suppkey",), ("l_suppkey",), ("n_name",), payload_as=("supp_nation",)
    )
    j2 = HashJoin(orders, j1, ("o_orderkey",), ("l_orderkey",), ("o_custkey",))
    j3 = HashJoin(
        cust_side,
        j2,
        ("c_custkey",),
        ("o_custkey",),
        ("n_name",),
        payload_as=("cust_nation",),
        post_filter=ColCmp("supp_nation", "!=", "cust_nation"),
    )
    agg = Aggregate(
        j3,
        ("supp_nation", "cust_nation", "l_shipyear"),
        (AggSpec("sum", REVENUE, name="revenue"),),
    )
    return OrderBy(agg, ("supp_nation", "cust_nation", "l_shipyear"), (True, True, True))


def q8_plan(db: Database, p: Dict) -> object:
    ptype, nation, region = p["type"], p["nation"], p["region"]
    part = Scan("part", Cmp("p_type", "==", ptype), ("p_partkey",))
    supplier = Scan("supplier", TRUE, ("s_suppkey", "s_nationkey"))
    nat_reg = HashJoin(
        Scan("region", Cmp("r_name", "==", region), ("r_regionkey",)),
        Scan("nation", TRUE, ("n_nationkey", "n_regionkey")),
        ("r_regionkey",),
        ("n_regionkey",),
        (),
    )
    cust_region = HashJoin(
        nat_reg,
        Scan("customer", TRUE, ("c_custkey", "c_nationkey")),
        ("n_nationkey",),
        ("c_nationkey",),
        (),
    )
    orders = Scan(
        "orders",
        And(
            (
                Cmp("o_orderdate", ">=", days("1995-01-01")),
                Cmp("o_orderdate", "<=", days("1996-12-31")),
            )
        ),
        ("o_orderkey", "o_custkey", "o_orderyear"),
    )
    order_cust = HashJoin(
        cust_region, orders, ("c_custkey",), ("o_custkey",), ()
    )
    nation_name = Scan("nation", TRUE, ("n_nationkey", "n_name"))
    lineitem = Scan(
        "lineitem", TRUE, ("l_orderkey", "l_partkey", "l_suppkey", "l_extendedprice", "l_discount")
    )
    j1 = HashJoin(part, lineitem, ("p_partkey",), ("l_partkey",), ())
    j2 = HashJoin(supplier, j1, ("s_suppkey",), ("l_suppkey",), ("s_nationkey",))
    j3 = HashJoin(order_cust, j2, ("o_orderkey",), ("l_orderkey",), ("o_orderyear",))
    j4 = HashJoin(
        nation_name, j3, ("n_nationkey",), ("s_nationkey",), ("n_name",), payload_as=("supp_nation",)
    )
    vol = REVENUE
    agg = Aggregate(
        j4,
        ("o_orderyear",),
        (
            AggSpec("sum", WhereEq("supp_nation", float(nation), vol, Const(0.0)), name="nation_volume"),
            AggSpec("sum", vol, name="total_volume"),
        ),
    )
    return OrderBy(agg, ("o_orderyear",), (True,))


def q9_plan(db: Database, p: Dict) -> object:
    color = p["color"]
    part = Scan("part", Cmp("p_colorcode", "==", color), ("p_partkey",))
    supplier = Scan("supplier", TRUE, ("s_suppkey", "s_nationkey"))
    partsupp = Scan("partsupp", TRUE, ("ps_partkey", "ps_suppkey", "ps_supplycost"))
    orders = Scan("orders", TRUE, ("o_orderkey", "o_orderyear"))
    nation = Scan("nation", TRUE, ("n_nationkey", "n_name"))
    lineitem = Scan(
        "lineitem",
        TRUE,
        ("l_orderkey", "l_partkey", "l_suppkey", "l_quantity", "l_extendedprice", "l_discount"),
    )
    j1 = HashJoin(part, lineitem, ("p_partkey",), ("l_partkey",), ())
    j2 = HashJoin(
        partsupp, j1, ("ps_partkey", "ps_suppkey"), ("l_partkey", "l_suppkey"), ("ps_supplycost",)
    )
    j3 = HashJoin(supplier, j2, ("s_suppkey",), ("l_suppkey",), ("s_nationkey",))
    j4 = HashJoin(orders, j3, ("o_orderkey",), ("l_orderkey",), ("o_orderyear",))
    j5 = HashJoin(nation, j4, ("n_nationkey",), ("s_nationkey",), ("n_name",))
    profit = BinOp("-", REVENUE, BinOp("*", Col("ps_supplycost"), Col("l_quantity")))
    agg = Aggregate(j5, ("n_name", "o_orderyear"), (AggSpec("sum", profit, name="sum_profit"),))
    return OrderBy(agg, ("n_name", "o_orderyear"), (True, False))


def q10_plan(db: Database, p: Dict) -> object:
    d0 = p["date"]
    d1 = d0 + 92
    customer = Scan("customer", TRUE, ("c_custkey", "c_nationkey", "c_acctbal"))
    orders = Scan(
        "orders",
        And((Cmp("o_orderdate", ">=", d0), Cmp("o_orderdate", "<", d1))),
        ("o_orderkey", "o_custkey"),
    )
    cust_orders = HashJoin(
        customer,
        orders,
        ("c_custkey",),
        ("o_custkey",),
        ("c_custkey", "c_nationkey", "c_acctbal"),
    )
    nation = Scan("nation", TRUE, ("n_nationkey", "n_name"))
    lineitem = Scan(
        "lineitem",
        Cmp("l_returnflag", "==", 0.0),  # 'R'
        ("l_orderkey", "l_extendedprice", "l_discount", "l_returnflag"),
    )
    j1 = HashJoin(
        cust_orders,
        lineitem,
        ("o_orderkey",),
        ("l_orderkey",),
        ("c_custkey", "c_nationkey", "c_acctbal"),
    )
    j2 = HashJoin(nation, j1, ("n_nationkey",), ("c_nationkey",), ("n_name",))
    agg = Aggregate(
        j2,
        ("c_custkey", "n_name"),
        (AggSpec("sum", REVENUE, name="revenue"), AggSpec("max", Col("c_acctbal"), name="c_acctbal")),
    )
    return OrderBy(agg, ("revenue",), (False,), limit=20)


# ---------------------------------------------------------------------------
# Parameter samplers (uniform over benchmark domains, paper §6.1)
# ---------------------------------------------------------------------------


def _sample_params(template: str, rng: np.random.Generator) -> Dict:
    if template == "q1":
        return {"delta": int(rng.integers(60, 121))}
    if template == "q3":
        return {
            "segment": float(rng.integers(0, len(SEGMENTS))),
            "date": float(days("1995-03-01") + rng.integers(0, 31)),
        }
    if template == "q4":
        y = int(rng.integers(1993, 1998))
        m = int(rng.integers(1, 13)) if y < 1997 else int(rng.integers(1, 11))
        return {"date": float(_first_of_month(y, m))}
    if template == "q5":
        return {
            "region": float(rng.integers(0, len(REGIONS))),
            "date": float(_first_of_month(int(rng.integers(1993, 1998)), 1)),
        }
    if template == "q6":
        return {
            "date": float(_first_of_month(int(rng.integers(1993, 1998)), 1)),
            "discount": float(rng.integers(2, 10)) / 100.0,
            "quantity": float(rng.integers(24, 26)),
        }
    if template == "q7":
        n1 = int(rng.integers(0, 25))
        n2 = int(rng.integers(0, 24))
        if n2 >= n1:
            n2 += 1
        return {"nation1": float(n1), "nation2": float(n2)}
    if template == "q8":
        nation_idx = int(rng.integers(0, 25))
        region_idx = NATIONS[nation_idx][1]
        return {
            "nation": float(nation_idx),
            "region": float(region_idx),
            "type": float(rng.integers(0, len(TYPES))),
        }
    if template == "q9":
        return {"color": float(rng.integers(0, len(COLORS)))}
    if template == "q10":
        months = [(y, m) for y in (1993, 1994) for m in range(1, 13)] + [(1995, 1)]
        y, m = months[int(rng.integers(0, len(months)))]
        return {"date": float(_first_of_month(y, m))}
    raise KeyError(template)


BUILDERS = {
    "q1": q1_plan,
    "q3": q3_plan,
    "q4": q4_plan,
    "q5": q5_plan,
    "q6": q6_plan,
    "q7": q7_plan,
    "q8": q8_plan,
    "q9": q9_plan,
    "q10": q10_plan,
}

# Zipf rank order (the paper doesn't specify it). Q3 — the paper's running
# hash-join instance — ranks first, so higher template skew concentrates
# arrivals on join-state-compatible queries, matching the paper's Fig. 11
# narrative; the scan-only templates (Q1, Q6) rank mid/low.
DEFAULT_TEMPLATES = ["q3", "q10", "q1", "q5", "q4", "q7", "q8", "q6", "q9"]

_next_qid = [0]


def make_query(db: Database, template: str, params: Dict, arrival: float = 0.0) -> Query:
    _next_qid[0] += 1
    plan = BUILDERS[template](db, params)
    return Query(qid=_next_qid[0], template=template, plan=plan, params=params, arrival=arrival)


def sample_query(
    db: Database, rng: np.random.Generator, zipf_alpha: float = 1.0, arrival: float = 0.0,
    templates: Optional[List[str]] = None,
) -> Query:
    templates = templates or DEFAULT_TEMPLATES
    ranks = np.arange(1, len(templates) + 1, dtype=np.float64)
    w = ranks ** (-zipf_alpha)
    w /= w.sum()
    template = templates[int(rng.choice(len(templates), p=w))]
    return make_query(db, template, _sample_params(template, rng), arrival)
