"""Models of two CUDA kernels' arithmetic, run on the CPU, where the kernels
cannot run.

The segmented sum (B7, ``csrc/seg_aggregate.cu``): a Python model of the
kernel's two passes, the bitonic sort of each chunk's (code, row) keys,
the runs summed in order into a float64, and the combine that
folds the chunk partials slab by slab in chunk order. It is held bit for
bit against ``seg_aggregate_plain`` (the order the kernel must keep), with
-0.0, +-inf and NaN among the values, and within rtol/atol 1e-4 of the
reference's Pallas kernel in interpret mode, the reference's own
tolerance.

Float32 flash attention (B9, ``fa_tf32x3_kernel``) takes each product as
three TF32 products. The model splits operands as the kernel does (the
TF32 rounding, to nearest as ``cvt.rna``, and the rest, which the tensor
core truncates to TF32) and adds each product's terms in float64: three
products (q, k, p and v split) stay within the float32 limit of rtol
1e-5 / atol 1e-4 of ``kernels/ref.py``'s oracle, and one TF32 product
does not.
"""

import math

import numpy as np
import pytest
import torch

from repro.kernels import seg_aggregate as ref_seg
from repro_torch.kernels import ref, seg_aggregate
from repro_torch.kernels.seg_aggregate import seg_chunk

torch.set_num_threads(2)

#: keys of one chunk's sort (the pass-1 block's threads), the sort code of a
#: row that matches no group, and the partials a combine block stages at once
SORT_WIDTH = 512
NONE = 1 << 31
SLAB = 128


# ---------------------------------------------------------------------------
# B7: the segmented sum's two passes
# ---------------------------------------------------------------------------


def bitonic_sort(keys):
    """The kernel's network over ``SORT_WIDTH`` keys: at step (k, j) key i
    meets key i ^ j, and the lower of the pair keeps the smaller key where
    i & k == 0 (an ascending run), the larger elsewhere."""
    idx = np.arange(SORT_WIDTH)
    k = 2
    while k <= SORT_WIDTH:
        j = k >> 1
        while j:
            other = keys[idx ^ j]
            keep_min = ((idx & j) == 0) == ((idx & k) == 0)
            keys = np.where(keep_min, np.minimum(keys, other), np.maximum(keys, other))
            j >>= 1
        k <<= 1
    return keys


def sort_pass(codes, vals, n_groups):
    """Pass 1: each chunk's keys code << 32 | row sorted (rows past the
    chunk hold the largest key), the values moved into sorted order, the
    runs of valid codes listed by their starts, and each run's values
    added in order into a float64 from +0.0 over a zero partial."""
    n, v = vals.shape
    chunk = seg_chunk(v)
    blocks = -(-n // chunk)
    part = np.zeros((blocks, n_groups, v), np.float64)
    for b in range(blocks):
        c = codes[b * chunk : (b + 1) * chunk].astype(np.int64)
        x = vals[b * chunk : (b + 1) * chunk].astype(np.float64)
        rows = len(c)
        code = np.where((c >= 0) & (c < n_groups), c, NONE).astype(np.uint64)
        keys = np.full(SORT_WIDTH, np.iinfo(np.uint64).max, np.uint64)
        keys[:rows] = code << np.uint64(32) | np.arange(rows, dtype=np.uint64)
        keys = bitonic_sort(keys)[:rows]
        s_code = (keys >> np.uint64(32)).astype(np.int64)
        s_vals = x[(keys & np.uint64(0xFFFFFFFF)).astype(np.int64)]
        assert np.array_equal(s_code, np.sort(code.astype(np.int64), kind="stable"))
        valid = s_code != NONE
        starts = np.flatnonzero(valid & np.r_[True, s_code[1:] != s_code[:-1]])
        bounds = np.r_[starts, valid.sum()]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            acc = np.zeros(v, np.float64)
            for i in range(lo, hi):
                acc = acc + s_vals[i]
            part[b, s_code[lo]] = acc
    return part


def combine_pass(part):
    """Pass 2: per output, the chunk partials in chunk order, slab by slab,
    into a float64 from +0.0; one rounding to float32."""
    acc = np.zeros(part.shape[1:], np.float64)
    for b0 in range(0, part.shape[0], SLAB):
        for b in range(b0, min(part.shape[0], b0 + SLAB)):
            acc = acc + part[b]
    return acc.astype(np.float32)


def seg_model(codes, vals, n_groups):
    with np.errstate(invalid="ignore", over="ignore"):
        return combine_pass(sort_pass(codes, vals, n_groups))


def same_bits(got, want):
    """Equal bits, and NaN exactly where ``want`` is NaN (IEEE 754 leaves a
    NaN's sign and payload open)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    return got.shape == want.shape and np.array_equal(np.isnan(got), nan) and np.array_equal(
        got.view(np.uint32)[~nan], want.view(np.uint32)[~nan])


def _values(rng, n, v):
    return (rng.normal(size=(n, v)) * 10.0 ** rng.integers(-6, 7, (n, v))).astype(np.float32)


def _case(name):
    """(codes, values, n_groups) of a named case."""
    rng = np.random.default_rng(len(name))
    if name == "outside_groups":  # codes below 0 and at or above G
        n, v, g = 1500, 1, 6
        return rng.integers(-3, g + 3, n).astype(np.int32), _values(rng, n, v), g
    if name == "empty_chunk":  # the second chunk matches no group
        n, v, g = 1536, 1, 8
        codes = rng.integers(0, g, n).astype(np.int32)
        codes[512:1024] = rng.choice([-1, g, 1 << 30], 512)
        return codes, _values(rng, n, v), g
    if name == "group_in_one_row":
        n, v, g = 700, 2, 64
        codes = np.full(n, -1, np.int32)
        codes[[123, 650]] = [5, 63]
        return codes, _values(rng, n, v), g
    if name == "no_rows":
        return np.zeros(0, np.int32), np.zeros((0, 1), np.float32), 8
    if name.startswith("rows_"):  # a chunk's edge: 511, 512, 513 rows
        n, v, g = int(name[5:]), 1, 8
        return rng.integers(-1, g + 1, n).astype(np.int32), _values(rng, n, v), g
    if name == "more_groups_than_threads":
        n, v, g = 1100, 1, 700
        return rng.integers(0, g, n).astype(np.int32), _values(rng, n, v), g
    if name.startswith("columns_"):  # V > 1: chunks of 512, 204 and 1 rows
        v = int(name[8:])
        n = {3: 1300, 40: 500, 8192: 5}[v]
        return rng.integers(-1, 5, n).astype(np.int32), _values(rng, n, v), 4
    if name == "specials":  # -0.0, +-inf and NaN among the values
        n, v, g = 1100, 2, 5
        codes = rng.choice(np.array([-1, 0, 1, 3, 4, g], np.int32), n)
        vals = _values(rng, n, v)
        vals[rng.choice(n, 40, replace=False)] = -0.0
        codes[[7, 600, 1000]] = 2  # group 2: only -0.0, so its sum is +0.0
        vals[[7, 600, 1000]] = -0.0
        special = {10: (0, np.inf), 520: (1, np.nan), 30: (3, np.inf), 1050: (3, -np.inf),
                   40: (4, -np.inf), 41: (-1, np.nan)}  # group 3: inf - inf; row 41 matches none
        for row, (code, x) in special.items():
            codes[row], vals[row] = code, x
        return codes, vals, g
    raise ValueError(name)


SEG_CASES = ["outside_groups", "empty_chunk", "group_in_one_row", "no_rows", "rows_511",
             "rows_512", "rows_513", "more_groups_than_threads", "columns_3", "columns_40",
             "columns_8192", "specials"]


@pytest.mark.parametrize("name", SEG_CASES)
def test_seg_model_matches_plain_bits(name):
    codes, vals, g = _case(name)
    got = seg_model(codes, vals, g)
    want = seg_aggregate.seg_aggregate_plain(torch.from_numpy(codes), torch.from_numpy(vals), g)
    assert same_bits(got, want.numpy())
    if name == "specials":
        assert got[2].view(np.uint32).tolist() == [0, 0]  # +0.0, not -0.0
        assert np.isposinf(got[0]).all() and np.isneginf(got[4]).all()
        assert np.isnan(got[1]).all() and np.isnan(got[3]).all()


@pytest.mark.parametrize("n,v,g", [(1000, 1, 8), (1300, 4, 37), (600, 40, 3)])
def test_seg_model_matches_reference_kernel(n, v, g):
    """The reference adds in float32 in the MXU's order: its own tolerance."""
    rng = np.random.default_rng(n + v + g)
    codes = rng.integers(-1, g + 2, n).astype(np.int32)
    vals = rng.normal(size=(n, v)).astype(np.float32)
    want = np.asarray(ref_seg.seg_aggregate(codes, vals, g, interpret=True))
    np.testing.assert_allclose(seg_model(codes, vals, g), want, rtol=1e-4, atol=1e-4)


def test_bitonic_model_sorts_any_keys():
    rng = np.random.default_rng(0)
    for _ in range(20):
        keys = rng.integers(0, 1 << 40, SORT_WIDTH, dtype=np.uint64)
        keys[rng.random(SORT_WIDTH) < 0.3] = np.iinfo(np.uint64).max
        assert np.array_equal(bitonic_sort(keys), np.sort(keys))


# ---------------------------------------------------------------------------
# B9 float32: three TF32 products against one
# ---------------------------------------------------------------------------


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does and the kernel's integer
    rounding does for finite values."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_truncated(x):
    """What the tensor core reads of a float32 operand: its top 19 bits."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """The kernel's split: hi = tf32(x), lo = x - hi (exact in float32), of
    which the tensor core reads the truncation; hi + lo is within 2^-21 |x|
    of x."""
    hi = tf32(x)
    return hi, tf32_truncated(np.asarray(x, np.float32) - hi)


def product(a, b, products):
    """a @ b with float32 operands as the tensor cores take them, each
    product's terms added in float64: one TF32 product (of the rounded
    operands), or three (of the split ones)."""
    if products == 1:
        return tf32(a).astype(np.float64) @ tf32(b).astype(np.float64)
    (ah, al), (bh, bl) = split(a), split(b)
    f = np.float64
    return ah.astype(f) @ bl.astype(f) + al.astype(f) @ bh.astype(f) + ah.astype(f) @ bh.astype(f)


def attention_model(q, k, v, window, products):
    """Causal (windowed) attention with both products emulated: scores in
    float32, scaled and masked as the kernel does, p unrounded float32."""
    _, s, dh = q.shape
    scale = np.float32(1.0 / math.sqrt(dh))
    sc = product(q, k.transpose(0, 2, 1), products).astype(np.float32) * scale
    pos = np.arange(s)
    ok = pos[:, None] >= pos[None, :]
    if window is not None:
        ok &= pos[:, None] - pos[None, :] < window
    sc = np.where(ok, sc, np.float32(-1e30))
    p = np.exp(sc - sc.max(-1, keepdims=True)).astype(np.float32)
    return (product(p, v, products) / p.sum(-1, dtype=np.float64)[..., None]).astype(np.float32)


def test_tf32_split_keeps_float32():
    x = np.random.default_rng(1).normal(size=10_000).astype(np.float32)
    hi, lo = split(x)
    low_bits = np.uint32(0x1FFF)
    assert not (hi.view(np.uint32) & low_bits).any() and not (lo.view(np.uint32) & low_bits).any()
    assert np.abs(tf32(x) - x).max() > 1e-5  # one TF32 value loses float32's digits
    rest = np.abs(hi.astype(np.float64) + lo - x) / np.abs(x)
    assert rest.max() <= 2.0 ** -21


@pytest.mark.parametrize("dh,window", [(64, None), (128, None), (256, None), (256, 100)])
def test_three_tf32_products_hold_the_float32_limit(dh, window):
    """rtol 1e-5 / atol 1e-4 of the oracle: three products hold it (well
    within), one product does not (rows that see few keys output about v
    itself, and one TF32 rounding of v is off by up to 2^-11 |v|)."""
    rng = np.random.default_rng(dh)
    q, k, v = (rng.normal(size=(2, 256, dh)).astype(np.float32) for _ in range(3))
    want = ref.flash_attention_ref(*(torch.from_numpy(t) for t in (q, k, v)),
                                   window=window).numpy()
    limit = 1e-4 + 1e-5 * np.abs(want)
    three = np.abs(attention_model(q, k, v, window, 3) - want) / limit
    one = np.abs(attention_model(q, k, v, window, 1) - want) / limit
    assert three.max() < 0.1, three.max()
    assert one.max() > 1.0, one.max()
