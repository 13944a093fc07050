"""The frozen generator and sampler equal the port's; the plain reference
equals the port's answers, run through ``graftdb_torch`` on the CPU, for
each of the nine templates at SF 0.01."""

import numpy as np
import pytest

from graftbench import datagen, sampler
from graftbench.compare import Checker
from graftbench.reference.tpch_queries import TEMPLATES, Reference

TEMPLATE_NAMES = ["q1", "q3", "q4", "q5", "q6", "q7", "q8", "q9", "q10"]


@pytest.fixture(scope="module")
def tables():
    return datagen.generate(0.01, 2**33 + 5)


def test_generator_equals_the_ports(tables):
    from repro_torch.relational import tpch

    port = tpch.generate(0.01, 2**33 + 5)
    assert set(port.tables) == set(tables)
    for name, (cols, dicts) in tables.items():
        assert set(cols) == set(port[name].columns)
        for k, v in cols.items():
            np.testing.assert_array_equal(v, port[name].columns[k])
        assert dicts == port[name].dictionaries


def test_sampler_equals_the_ports():
    from repro_torch.relational import queries

    assert queries.DEFAULT_TEMPLATES == ["q3", "q10", "q1", "q5", "q4", "q7", "q8", "q6", "q9"]
    for t in TEMPLATE_NAMES:
        a, b = np.random.default_rng(9), np.random.default_rng(9)
        for _ in range(20):
            assert sampler.sample_params(t, a) == queries._sample_params(t, b)


@pytest.mark.parametrize("template", TEMPLATE_NAMES)
def test_reference_equals_the_port(tables, template):
    import graftdb_torch
    from repro_torch.relational import queries
    from repro_torch.relational.table import database_from_numpy

    db = database_from_numpy(tables, 0.01)
    rng = np.random.default_rng(31)
    insts = [(template, sampler.sample_params(template, rng)) for _ in range(3)]
    session = graftdb_torch.connect(db, graftdb_torch.EngineConfig(
        mode="graft", morsel_size=4096, device="cpu", workers=1, partitions=1))
    futs = [session.submit(queries.make_query(db, t, p)) for t, p in insts]
    session.run()
    checker = Checker(Reference(tables), tie=1e-6)
    for (t, p), f in zip(insts, futs):
        checker.check(t, p, f.result())
    session.close()
    assert checker.checked == 3
    assert checker.wrong_rows == 0
    assert checker.max_rel_err < 1e-12


def test_reference_order_and_limit(tables):
    ref = Reference(tables)
    rng = np.random.default_rng(4)
    for t in TEMPLATE_NAMES:
        res = ref.run(t, sampler.sample_params(t, rng))
        spec = TEMPLATES[t]
        assert set(spec.keys) <= set(res)
        if spec.order:
            col, asc = spec.order[0]
            v = res[col] if asc else -res[col]
            assert np.all(np.diff(v) >= 0)
