"""The port's copies of the engine's leaf modules — ``visibility``,
``hashindex`` and ``predicates`` — against the reference's, on random
inputs made with numpy. Every output must be identical."""

import numpy as np
import pytest

from repro.core import hashindex as ref_hashindex
from repro.core import predicates as ref_pred
from repro.core import visibility as ref_vis
from repro_torch.core import hashindex, predicates, visibility


def _words(rng, n):
    w = rng.integers(0, 1 << 63, n, dtype=np.uint64) << np.uint64(1)
    return w | rng.integers(0, 2, n, dtype=np.uint64)


@pytest.mark.parametrize("seed", range(3))
def test_visibility_word_ops_identical(seed):
    rng = np.random.default_rng(seed)
    words = _words(rng, 500)
    words[rng.random(500) < 0.3] = 0
    target = _words(rng, 64)
    t_ref, t_port = ref_vis.translation_table(target), visibility.translation_table(target)
    np.testing.assert_array_equal(t_port, t_ref)
    np.testing.assert_array_equal(
        visibility.translate_bits(words, t_port), ref_vis.translate_bits(words, t_ref)
    )
    np.testing.assert_array_equal(visibility.slot_popcounts(words), ref_vis.slot_popcounts(words))
    slots = rng.choice(64, 9, replace=False)
    np.testing.assert_array_equal(
        visibility.unpack_slots(words, slots), ref_vis.unpack_slots(words, slots)
    )
    for a, b in zip(visibility.split_words(words), ref_vis.split_words(words)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        visibility.join_words(*visibility.split_words(words)), words
    )
    for s in (0, 31, 32, 63):
        np.testing.assert_array_equal(visibility.bit_of(words, s), ref_vis.bit_of(words, s))
    a, b = words.copy(), words.copy()
    rows = rng.integers(0, 500, 40)
    visibility.or_bit(a, rows, 45)
    ref_vis.or_bit(b, rows, 45)
    np.testing.assert_array_equal(a, b)


def test_slot_allocator_sequence_identical():
    rng = np.random.default_rng(9)
    a, b = visibility.SlotAllocator(), ref_vis.SlotAllocator()
    live = []
    for step in range(300):
        if live and rng.random() < 0.4:
            q = live.pop(int(rng.integers(0, len(live))))
            a.release(q)
            b.release(q)
        elif len(live) < 64:
            live.append(step)
            assert a.get(step) == b.get(step)
        assert a.attached() == b.attached()
        assert all(a.mask(q) == b.mask(q) for q in live)
        assert a.try_get(10_000 + step) == b.try_get(10_000 + step)
        a.release(10_000 + step)
        b.release(10_000 + step)


@pytest.mark.parametrize("parts", [1, 3, 4, 16])
def test_key_partition_identical(parts):
    rng = np.random.default_rng(parts)
    keys = rng.integers(-(1 << 40), 1 << 40, 2000)
    np.testing.assert_array_equal(
        hashindex.key_partition(keys, parts), ref_hashindex.key_partition(keys, parts)
    )


def test_hash_index_streams_identical():
    rng = np.random.default_rng(1)
    a, b = hashindex.HashIndex(capacity=8), ref_hashindex.HashIndex(capacity=8)
    for _ in range(20):
        keys = rng.integers(0, 3000, int(rng.integers(1, 400)))
        for x, y in zip(a.lookup_or_insert(keys), b.lookup_or_insert(keys)):
            np.testing.assert_array_equal(x, y)
        probe = rng.integers(0, 4000, 300)
        np.testing.assert_array_equal(a.lookup(probe), b.lookup(probe))
    assert len(a) == len(b)


def test_multi_key_index_identical():
    rng = np.random.default_rng(2)
    a, b = hashindex.MultiKeyIndex(3), ref_hashindex.MultiKeyIndex(3)
    for _ in range(10):
        n = int(rng.integers(1, 300))
        cols = [
            rng.integers(0, 20, n).astype(np.float64),
            rng.choice([0.5, -0.0, 0.0, 7.25, np.inf], n),
            rng.integers(0, 5, n).astype(np.int64),
        ]
        for x, y in zip(a.lookup_or_insert(cols), b.lookup_or_insert(cols)):
            np.testing.assert_array_equal(x, y)
    assert a.n == b.n


ATTRS = ("a", "b", "c")


def _random_pred(mod, rng, depth=0):
    """One random predicate tree built from ``mod``'s AST classes; the same
    rng state builds the same tree in either package."""
    kind = rng.integers(0, 5 if depth < 2 else 3)
    attr = ATTRS[int(rng.integers(0, len(ATTRS)))]
    if kind == 0:
        op = mod._OPS[int(rng.integers(0, len(mod._OPS)))]
        return mod.Cmp(attr, op, float(rng.integers(-5, 6)))
    if kind == 1:
        return mod.InSet(attr, frozenset(float(v) for v in rng.integers(-3, 4, 3)))
    if kind == 2:
        return mod.TRUE
    if kind == 3:
        op = mod._COL_OPS[int(rng.integers(0, len(mod._COL_OPS)))]
        return mod.ColCmp(attr, op, ATTRS[int(rng.integers(0, len(ATTRS)))])
    return mod.pred_and(*(_random_pred(mod, rng, depth + 1) for _ in range(3)))


def _canon(conj):
    if conj is None:
        return None
    return sorted(
        (a, c.lo, c.lo_inc, c.hi, c.hi_inc, c.members) for a, c in conj.constraints.items()
    )


@pytest.mark.parametrize("seed", range(3))
def test_predicates_identical(seed):
    rng = np.random.default_rng(seed)
    cols = {a: rng.integers(-6, 7, 400).astype(np.float64) for a in ATTRS}
    cols["b"][::7] = np.nan
    for i in range(60):
        s = int(rng.integers(0, 1 << 30))
        p = _random_pred(predicates, np.random.default_rng(s))
        r = _random_pred(ref_pred, np.random.default_rng(s))
        np.testing.assert_array_equal(predicates.evaluate(p, cols), ref_pred.evaluate(r, cols))
        assert predicates.free_attrs(p) == ref_pred.free_attrs(r)
        cp, cr = predicates.Conjunction.from_pred(p), ref_pred.Conjunction.from_pred(r)
        assert _canon(cp) == _canon(cr)
        if cp is not None:
            np.testing.assert_array_equal(
                predicates.evaluate_conj(cp, cols), ref_pred.evaluate_conj(cr, cols)
            )
        s2 = int(rng.integers(0, 1 << 30))
        q = _random_pred(predicates, np.random.default_rng(s2))
        qr = _random_pred(ref_pred, np.random.default_rng(s2))
        assert predicates.prove_implies(p, q) == ref_pred.prove_implies(r, qr)
