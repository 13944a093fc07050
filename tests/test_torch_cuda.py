"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. The inputs are made with numpy from a seed; outputs are integers, so
equality is exact.

This file imports neither JAX nor the reference package, so it also runs
on a machine that has only PyTorch; there, run it without the repository's
``conftest.py``:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Every case needs a card and skips where none is visible.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_chain, hash_probe
from repro_torch.kernels.fused_chain import total_order_u32
from repro_torch.kernels.hash_probe import EMPTY, MULT

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _t(a, dev="cpu"):
    """numpy -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32)).to(dev)


def _table(keys, load=0.5):
    """Open-addressing table by unbounded linear probing in key order:
    (table keys, slot -> entry id)."""
    cap = 8
    while cap < len(keys) / load:
        cap *= 2
    tk = np.full(cap, EMPTY, np.int32)
    te = np.full(cap, -1, np.int32)
    for i, k in enumerate(keys):
        p = (int(k) * MULT) & 0xFFFFFFFF & (cap - 1)
        while tk[p] != EMPTY:
            p = (p + 1) & (cap - 1)
        tk[p], te[p] = k, i
    return tk, te


def _words(rng, *shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _probe_inputs(case, seed=0, n=4000):
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 20, n, replace=False).astype(np.int64)
    if case == "cluster":
        # a chain longer than MAX_PROBE on one home slot
        cap = 8
        while cap < n / 0.5:
            cap *= 2
        extra, k = [], 1 << 21
        while len(extra) < 24:
            if (k * MULT) & 0xFFFFFFFF & (cap - 1) == 5:
                extra.append(k)
            k += 1
        keys = np.concatenate([keys[: n - 24], extra])
    keys = keys.astype(np.int32)
    tk, te = _table(keys)
    evlo, evhi = _words(rng, n), _words(rng, n)
    if case == "zero_vis":
        dead = rng.random(n) < 0.5
        evlo[dead] = 0
        evhi[dead] = 0
    tv = np.where(te >= 0, evlo[np.maximum(te, 0)], 0).astype(np.uint32)
    probe = np.concatenate([keys, (rng.choice(1 << 20, n) + (1 << 22)).astype(np.int32)])
    rng.shuffle(probe)
    mask = np.array([1 << 7, 1 << 30], np.uint32)
    return probe, tk, tv, te, evlo, evhi, mask


@pytest.mark.parametrize("case", ["misses", "cluster", "zero_vis"])
def test_cuda_probes_match_plain(cuda, case):
    arrays = _probe_inputs(case)
    k, tk, tv, te, lo, hi, m = (_t(a, cuda) for a in arrays)
    c = [_t(a) for a in arrays]
    got = hash_probe.hash_probe_lens(k, tk, tv, m[:1])
    assert torch.equal(got.cpu(), hash_probe.hash_probe_lens_plain(c[0], c[1], c[2], c[6][:1]))
    got = hash_probe.hash_probe_lens64(k, tk, te, lo, hi, m)
    want = hash_probe.hash_probe_lens64_plain(c[0], c[1], c[3], c[4], c[5], c[6])
    assert torch.equal(got.cpu(), want)
    got = hash_probe.hash_probe_lens_multi64(k, tk, te, lo, hi)
    want = hash_probe.hash_probe_lens_multi64_plain(c[0], c[1], c[3], c[4], c[5])
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    torch.cuda.synchronize()


SPECIALS = np.array(
    [np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-324, -5e-324, 1.5, -1.5, 2.0, 1e300]
)


def _chain_inputs(seed, n=4096, n_e=3000):
    """Two stages (host keys, then keys gathered through stage 0's
    entries), each with compiled grants and an interval filter over a host
    and an entry-indexed column, ending in a build sink; float operands
    drawn from ``SPECIALS``."""
    rng = np.random.default_rng(seed)

    def enc(vals):
        return list(total_order_u32(vals))

    def bounds(shape):
        lh, ll = total_order_u32(rng.choice(SPECIALS, shape).ravel())
        hh, hl = total_order_u32(rng.choice(SPECIALS, shape).ravel())
        return (np.stack([lh, ll], -1).reshape(*shape, 2),
                np.stack([hh, hl], -1).reshape(*shape, 2))

    bits_lo, bits_hi = _words(rng, n), _words(rng, n)
    dead = rng.random(n) < 0.2
    bits_lo[dead] = 0
    bits_hi[dead] = 0
    arrays, stages = [bits_lo, bits_hi], []
    for s in range(2):
        keys = rng.choice(1 << 22, n_e, replace=False).astype(np.int32)
        tk, te = _table(keys)
        if s == 0:
            hits = keys[rng.integers(0, n_e, n)]
            arrays.append(np.where(rng.random(n) < 0.7, hits, rng.integers(1 << 23, 1 << 24, n))
                          .astype(np.int32))
        else:
            arrays.append(np.where(rng.random(n_e) < 0.8, keys[rng.integers(0, n_e, n_e)],
                                   1 << 25).astype(np.int32))
        arrays += [tk, te, _words(rng, n_e), _words(rng, n_e), _words(rng, 8, 256),
                   _words(rng, 8, 256)]
        glo, ghi = bounds((2, 2))
        arrays += [_words(rng, n_e), _words(rng, n_e), _words(rng, 2, 2), _words(rng, 2, 2),
                   rng.integers(0, 2, (2, 2)).astype(np.int32), glo, ghi]
        arrays += enc(rng.choice(SPECIALS, n_e)) + enc(rng.choice(SPECIALS, n_e))
        srcs = (-1, s)
        arrays += enc(rng.choice(SPECIALS, n)) + enc(rng.choice(SPECIALS, n_e))
        flo, fhi = bounds((3, 2))
        arrays += [flo, fhi, rng.integers(0, 2, (3, 2)).astype(np.int32), _words(rng, 3, 2)]
        stages.append((-1 if s == 0 else 0, 2, 2, (3, srcs)))
    arrays += [_words(rng, 8, 256) for _ in range(4)]
    return (tuple(stages), True), arrays


@pytest.mark.parametrize("seed", range(3))
def test_cuda_chain_matches_plain(cuda, seed):
    spec, arrays = _chain_inputs(seed)
    want = fused_chain.chain_plain(spec, [_t(a) for a in arrays])
    got = fused_chain.chain_launch(spec, [_t(a, cuda) for a in arrays])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    stats = fused_chain.split_outputs(spec, len(arrays[0]), want)[2 + len(spec[0])]
    assert int(stats[:, 1].sum()) > 0  # rows matched


@pytest.mark.parametrize("n", [8, 128, 256, 65_536])
def test_cuda_chain_row_counts(cuda, n):
    """Power-of-two row counts below, at and above one block."""
    spec, arrays = _chain_inputs(5, n=n, n_e=500)
    want = fused_chain.chain_plain(spec, [_t(a) for a in arrays])
    got = fused_chain.chain_launch(spec, [_t(a, cuda) for a in arrays])
    assert torch.equal(got.cpu(), want)


def test_cuda_wrappers_count_launches(cuda):
    from repro_torch.kernels import _build

    arrays = _probe_inputs("misses")
    k, tk, tv, te, lo, hi, m = (_t(a, cuda) for a in arrays)
    before = _build.launch_counts().get("hash_probe_lens64", 0)
    hash_probe.hash_probe_lens64(k, tk, te, lo, hi, m)
    assert _build.launch_counts()["hash_probe_lens64"] == before + 1
    c = [_t(a) for a in arrays]
    hash_probe.hash_probe_lens64(c[0], c[1], c[3], c[4], c[5], c[6])  # plain: not counted
    assert _build.launch_counts()["hash_probe_lens64"] == before + 1
