"""The port's TPC-H data, query templates and reference executor against
the reference package's: the same seed gives identical columns (dtype
included), the same sampling gives the same queries, and the reference
executors give the same answers."""

import numpy as np
import pytest

from repro.relational import queries as ref_queries
from repro.relational import refexec as ref_refexec
from repro.relational import table as ref_table
from repro.relational import tpch as ref_tpch
from repro_torch.relational import queries, refexec, table, tpch


@pytest.fixture(scope="module")
def tdb():
    return tpch.get_database(0.01, seed=7)


def test_tpch_columns_identical(db, tdb):
    assert tdb.scale_factor == db.scale_factor
    assert sorted(tdb.tables) == sorted(db.tables)
    for name, t in db.tables.items():
        mine = tdb.tables[name]
        assert sorted(mine.columns) == sorted(t.columns), name
        for col, v in t.columns.items():
            assert mine.columns[col].dtype == v.dtype, (name, col)
            np.testing.assert_array_equal(mine.columns[col], v, err_msg=f"{name}.{col}")
        assert mine.dictionaries == t.dictionaries, name


def test_tpch_other_seed_and_scale_identical():
    a, b = ref_tpch.get_database(0.002, seed=11), tpch.get_database(0.002, seed=11)
    for name, t in a.tables.items():
        for col, v in t.columns.items():
            np.testing.assert_array_equal(b.tables[name].columns[col], v)


def test_database_from_numpy_copies(db):
    tdb = table.database_from_numpy(db.tables, db.scale_factor)
    li, ref_li = tdb.tables["lineitem"].columns, db.tables["lineitem"].columns
    for col, v in ref_li.items():
        np.testing.assert_array_equal(li[col], v)
        assert not np.shares_memory(li[col], v)
    raw = {n: (t.columns, t.dictionaries) for n, t in db.tables.items()}
    assert table.database_from_numpy(raw, 0.01).tables.keys() == db.tables.keys()


def test_days_encoding_identical():
    for d in ("1992-01-01", "1995-03-15", "1998-12-31"):
        assert table.days(d) == ref_table.days(d)


def test_sampled_queries_identical(db, tdb):
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(40):
        a = ref_queries.sample_query(db, rng_a)
        b = queries.sample_query(tdb, rng_b)
        assert (a.template, a.params) == (b.template, b.params)
    assert queries.DEFAULT_TEMPLATES == ref_queries.DEFAULT_TEMPLATES


@pytest.mark.parametrize("template", sorted(ref_queries.BUILDERS))
def test_refexec_identical(db, tdb, template):
    rng = np.random.default_rng(len(template))
    for _ in range(2):
        params = ref_queries._sample_params(template, rng)
        want = ref_refexec.execute(db, ref_queries.make_query(db, template, params).plan)
        got = refexec.execute(tdb, queries.make_query(tdb, template, params).plan)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{template}/{k}")
