"""The launch path of the fused chain (B1) and the probes (B2-B4), on the
CPU.

B1's kernel takes its argument block by value: ``chain_args`` lays it out
in host memory as ``[D, n_in] + chain_descriptor(spec, arrays)``, then the
inputs' pointers in ``input_kinds`` order and the outputs' places in the
flat buffer. B2's kernel takes the 64-bit lens mask by value, given on the
host, as B4's takes its 32-bit one; B3 returns its three outputs as the
rows of one buffer. ``TorchBackend`` stages every row input of a chain
call, and the keys of each probe, through one host buffer into one device
buffer, padded in place, and brings each call's output back with one copy.
These tests hold the block against the descriptor and the pointer order,
the staged rows against the padding the backend used to build with
``np.concatenate``, the probe with its mask by value against the
reference's Pallas kernel (interpret mode), and ``TorchBackend(device=
"cpu")`` sessions that reach each engine call against the reference
engine. Nothing here needs a card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import graftdb
import graftdb_torch
import repro_torch.api.backends as backends
from repro.kernels import hash_probe as ref_hp
from repro.kernels.ops import build_hash_table
from repro.relational import queries as ref_queries
from repro_torch.api.backends import TorchBackend, _Staging
from repro_torch.kernels import fused_chain, hash_probe
from repro_torch.kernels.hash_probe import EMPTY
from repro_torch.relational import queries
from repro_torch.relational.table import database_from_numpy

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tdb(db):
    return database_from_numpy(db.tables, db.scale_factor)


def _words(rng, *shape):
    return torch.from_numpy(
        rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)
    )


def _chain(n_stages, n=64, n_e=40, seed=0, grants=(2, 2), filt=(3, 2), sink=True):
    """A spec of ``n_stages`` stages (host keys, then keys gathered through
    the previous stage's entries), each with ``grants`` (count, attrs)
    compiled grants and a ``filt`` (members, attrs) interval filter whose
    first attr is per row and the rest entry-indexed, and its int32 CPU
    inputs; random words throughout."""
    rng = np.random.default_rng(seed)
    arrays, stages = [_words(rng, n), _words(rng, n)], []
    n_g, g_a = grants
    n_m, f_a = filt
    for s in range(n_stages):
        keys = rng.choice(1 << 16, n_e, replace=False).astype(np.int32)
        tk, _, te = (np.array(a) for a in build_hash_table(keys, np.ones(n_e, np.uint32)))
        pick = keys[rng.integers(0, n_e, n if s == 0 else n_e)]
        arrays += [torch.from_numpy(pick), torch.from_numpy(tk), torch.from_numpy(te)]
        arrays += [_words(rng, n_e), _words(rng, n_e), _words(rng, 8, 256), _words(rng, 8, 256)]
        if n_g:
            arrays += [_words(rng, n_e), _words(rng, n_e), _words(rng, n_g, 2),
                       _words(rng, n_g, 2), torch.ones(n_g, g_a, dtype=torch.int32),
                       _words(rng, n_g, g_a, 2), _words(rng, n_g, g_a, 2)]
            arrays += [_words(rng, n_e) for _ in range(2 * g_a)]
        srcs = (-1,) + (s,) * (f_a - 1)
        for src in srcs:
            arrays += [_words(rng, n if src == -1 else n_e) for _ in range(2)]
        arrays += [_words(rng, n_m, f_a, 2), _words(rng, n_m, f_a, 2),
                   torch.ones(n_m, f_a, dtype=torch.int32), _words(rng, n_m, 2)]
        stages.append((-1 if s == 0 else s - 1, n_g, g_a if n_g else 0, (n_m, srcs)))
    if sink:
        arrays += [_words(rng, 8, 256) for _ in range(4)]
    spec = (tuple(stages), sink)
    assert len(arrays) == len(fused_chain.input_kinds(spec))
    return spec, arrays


def _expected_block(spec, arrays, flat):
    """The block written out from the descriptor, ``input_kinds``' order and
    the offsets of ``output_sizes``."""
    desc = fused_chain.chain_descriptor(spec, arrays)
    n = arrays[0].shape[0]
    offs = np.cumsum([0] + fused_chain.output_sizes(spec, n)[:-1])
    return ([len(desc), len(arrays)] + desc + [a.data_ptr() for a in arrays]
            + [flat.data_ptr() + 4 * int(o) for o in offs])


def _flat(spec, n):
    return torch.empty(sum(fused_chain.output_sizes(spec, n)), dtype=torch.int32)


@pytest.mark.parametrize("n_stages,sink", [(1, False), (2, True), (fused_chain.MAX_STAGES, True)])
def test_chain_args_follow_descriptor_and_pointer_order(n_stages, sink):
    spec, arrays = _chain(n_stages, sink=sink, seed=n_stages)
    flat = _flat(spec, 64)
    block = fused_chain.chain_args(spec, arrays, flat)
    assert block.dtype == np.int64 and block.tolist() == _expected_block(spec, arrays, flat)
    assert len(block) <= fused_chain.MAX_ARG_WORDS
    out = fused_chain.chain_launch(spec, arrays)  # the plain version on the CPU
    assert torch.equal(out, fused_chain.chain_plain(spec, arrays))


def test_chain_args_hold_the_largest_engine_spec(tdb, monkeypatch):
    """Every chain the engine launches on the SF-0.01 workloads (sampled
    queries in graft and residual mode, and the grant wave) fits the
    kernel's small parameter struct (``FC_SMALL_WORDS`` = 224 words in
    ``csrc/fused_chain.cu``), and the largest round-trips to the
    descriptor and the pointer order."""
    seen = []
    orig = backends.chain_launch

    def spy(spec, arrays, **kw):
        flat = orig(spec, arrays, **kw)
        seen.append((len(fused_chain.chain_args(spec, arrays, flat)), spec, list(arrays), flat))
        return flat

    monkeypatch.setattr(backends, "chain_launch", spy)
    rng = np.random.default_rng(7)
    sampled = [queries.sample_query(tdb, rng, arrival=0.005 * i) for i in range(8)]
    grants = [queries.make_query(tdb, "q3", {"segment": 1.0, "date": d}, arrival=t)
              for d, t in ((750.0, 0.0), (760.0, 0.01), (750.0, 0.02), (800.0, 0.03))]
    for qs, mode in ((sampled, "graft"), (sampled, "residual"), (grants, "graft")):
        session = graftdb_torch.connect(tdb, graftdb_torch.EngineConfig(
            device="cpu", mode=mode, morsel_size=16384))
        session.submit_all([queries.make_query(tdb, q.template, q.params, arrival=q.arrival)
                            for q in qs])
        session.run()
    assert seen
    words, spec, arrays, flat = max(seen, key=lambda c: c[0])
    assert words <= 224
    assert fused_chain.chain_args(spec, arrays, flat).tolist() == _expected_block(
        spec, arrays, flat)
    assert any(st[1] for _, spec, _, _ in seen for st in spec[0])  # a grant stage


@pytest.mark.parametrize("case", ["stages", "words"])
def test_chain_spec_over_the_struct_raises(case):
    """A spec whose block does not fit the kernel's parameter struct raises,
    on the CPU as on the card: the plain version never serves it."""
    if case == "stages":
        spec, arrays = _chain(fused_chain.MAX_STAGES + 1, grants=(0, 0), filt=(1, 1))
    else:  # few stages, many grant attrs
        spec, arrays = _chain(3, grants=(1, 700), filt=(1, 1))
    with pytest.raises(ValueError, match="at most|more than"):
        fused_chain.chain_launch(spec, arrays)
    with pytest.raises(ValueError):
        fused_chain.chain_args(spec, arrays, _flat(spec, 64))


def _pad_row(a, npad, fill=0):
    """The backend's padding before its staging buffers: ``np.concatenate``
    with the fill, then the words' int32 bits."""
    if len(a) < npad:
        a = np.concatenate([a, np.full(npad - len(a), fill, dtype=a.dtype)])
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)


@pytest.mark.parametrize("n", [1, 7, 9, 100, 1000, 4097])
def test_staging_pads_rows_like_concatenate(n):
    rng = np.random.default_rng(n)
    npad = max(8, 1 << (n - 1).bit_length())
    words = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    keys = rng.integers(0, 2**31 - 2, n).astype(np.int64)
    stage = _Staging(torch.device("cpu"))
    for rows in range(2):  # the second call reuses the buffers
        stage.begin(3, npad)
        got = [stage.row(words), stage.row(keys, EMPTY), stage.row(words[::-1])]
        stage.upload()
        want = [_pad_row(words, npad), _pad_row(keys, npad, EMPTY), _pad_row(words[::-1], npad)]
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and g.is_contiguous()
            np.testing.assert_array_equal(g.numpy(), w)
    assert stage.fetch(got[1]).tolist() == want[1].tolist()


@pytest.mark.parametrize("slot", [0, 31, 32, 63])
def test_probe_lens64_mask_by_value_matches_reference(slot):
    """The mask given on the host, as a (lo, hi) pair and as a CPU int32
    tensor, against the reference's kernel in interpret mode, on the first
    and last slot of each half."""
    rng = np.random.default_rng(slot)
    n = 500
    keys = rng.choice(1 << 20, n, replace=False).astype(np.int32)
    words = rng.integers(0, 1 << 64, n, dtype=np.uint64) & ~(np.uint64(1) << np.uint64(slot))
    words[rng.random(n) < 0.5] |= np.uint64(1) << np.uint64(slot)
    evlo = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    evhi = (words >> np.uint64(32)).astype(np.uint32)
    tk, _, te = (np.asarray(a) for a in build_hash_table(keys, evlo))
    probe = np.concatenate([keys, (rng.choice(1 << 20, 300) + (1 << 22)).astype(np.int32)])
    rng.shuffle(probe)
    bit = 1 << slot
    pair = (bit & 0xFFFFFFFF, bit >> 32)
    want = np.asarray(ref_hp.hash_probe_lens64(
        probe, tk, te, evlo, evhi, np.array(pair, np.uint32), interpret=True))
    assert (want >= 0).any() and ((want < 0) & np.isin(probe, keys)).any()
    args = [torch.from_numpy(np.array(a).view(np.int32)) for a in (probe, tk, te, evlo, evhi)]
    tensor_mask = torch.from_numpy(np.array(pair, np.uint32).view(np.int32))
    for mask in (pair, tensor_mask):
        np.testing.assert_array_equal(hash_probe.hash_probe_lens64(*args, mask).numpy(), want)
        np.testing.assert_array_equal(
            hash_probe.hash_probe_lens64_plain(*args, mask).numpy(), want)


@pytest.mark.parametrize("mask", [torch.zeros(3, dtype=torch.int32),
                                  torch.zeros(2, dtype=torch.int64)])
def test_probe_lens64_refuses_other_masks(mask):
    args = [torch.zeros(8, dtype=torch.int32) for _ in range(5)]
    with pytest.raises(TypeError, match="query_mask"):
        hash_probe.hash_probe_lens64(*args, mask)


def _run(db, qs, connect, config, **cfg):
    session = connect(db, config(capture_explain=True, **cfg))
    futs = session.submit_all([
        dataclasses.replace(q, qid=10_000 + i) for i, q in enumerate(qs)])
    session.run()
    return session, futs


@pytest.mark.parametrize("member_major", [True, False])
def test_cpu_sessions_keep_results_counters_and_clock(db, tdb, member_major):
    """``TorchBackend(device="cpu")`` through the staging buffers: results,
    counters, backend stats, per-query stats and the clock equal the
    reference engine's (Pallas, interpret mode). With ``member_major`` the
    morsels take the fused chain, without it the single-query lens probe."""
    rng = np.random.default_rng(42_003)
    ref_qs = [ref_queries.sample_query(db, rng, arrival=0.01 * i) for i in range(4)]
    cfg = dict(mode="graft", morsel_size=16384, member_major=member_major)
    s_ref, f_ref = _run(db, ref_qs, graftdb.connect, graftdb.EngineConfig,
                        backend="pallas", **cfg)
    port_qs = [queries.make_query(tdb, q.template, q.params, arrival=q.arrival) for q in ref_qs]
    backend = TorchBackend(device="cpu")
    s_port, f_port = _run(tdb, port_qs, graftdb_torch.connect, graftdb_torch.EngineConfig,
                          backend=backend, **cfg)
    for a, b in zip(f_ref, f_port):
        ra, rb = a.result(), b.result()
        assert set(ra) == set(rb)
        for k in ra:
            np.testing.assert_array_equal(rb[k], ra[k])
        assert b.stats() == a.stats()
    assert dict(s_port.counters) == dict(s_ref.counters)
    assert s_port.backend.stats() == s_ref.backend.stats()
    assert s_port.now == s_ref.now
    if member_major:
        assert backend.chain_launches > 0
    else:
        assert backend.kernel_lens_probes > 0
    assert backend._staging.used > 0 and not backend._staging.pinned


def _q5_pair(make, db):
    """Two concurrent q5s: their shared pipeline declines the fused chain
    (q5's column-equality post-filter), so its stages probe through
    ``probe_visible_multi``."""
    return [make(db, "q5", {"region": 1.0, "date": d}, arrival=0.0) for d in (730.0, 800.0)]


@pytest.mark.parametrize("call", ["probe", "probe_visible_multi"])
def test_cpu_sessions_reach_probe_and_multi_probe(db, tdb, call, monkeypatch):
    """The engine's ``probe`` (B4, all-ones mask by value) and
    ``probe_visible_multi`` (B3, one ``[3, N]`` fetch) through the staging
    buffers: results, per-query stats, EXPLAIN GRAFT, counters, backend
    stats and the clock equal the reference engine's (Pallas, interpret
    mode). The per-member loops of four sampled queries reach ``probe``;
    two concurrent q5s reach ``probe_visible_multi``."""
    if call == "probe":
        rng = np.random.default_rng(42_003)
        ref_qs = [ref_queries.sample_query(db, rng, arrival=0.01 * i) for i in range(4)]
        cfg = dict(mode="graft", morsel_size=16384, member_major=False)
    else:
        ref_qs = _q5_pair(ref_queries.make_query, db)
        cfg = dict(mode="graft", morsel_size=16384)
    wrapper = "hash_probe_lens" if call == "probe" else "hash_probe_lens_multi64"
    launched = []
    orig = getattr(backends, wrapper)
    monkeypatch.setattr(backends, wrapper, lambda *a: launched.append(a) or orig(*a))
    s_ref, f_ref = _run(db, ref_qs, graftdb.connect, graftdb.EngineConfig,
                        backend="pallas", **cfg)
    port_qs = [queries.make_query(tdb, q.template, q.params, arrival=q.arrival) for q in ref_qs]
    backend = TorchBackend(device="cpu")
    s_port, f_port = _run(tdb, port_qs, graftdb_torch.connect, graftdb_torch.EngineConfig,
                          backend=backend, **cfg)
    for a, b in zip(f_ref, f_port):
        ra, rb = a.result(), b.result()
        assert set(ra) == set(rb)
        for k in ra:
            np.testing.assert_array_equal(rb[k], ra[k])
        assert b.stats() == a.stats()
        assert b.explain().render() == a.explain().render()
    assert dict(s_port.counters) == dict(s_ref.counters)
    assert s_port.backend.stats() == s_ref.backend.stats()
    assert s_port.now == s_ref.now
    assert launched
    if call == "probe":
        assert all(a[3] == 0xFFFFFFFF for a in launched)  # the mask by value
    assert all(a[0].data_ptr() == backend._staging.dev.data_ptr() for a in launched)
