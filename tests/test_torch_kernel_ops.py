"""The port's kernel-ops entry point (``ops.attention``,
``ops.linear_recurrence``) and its oracles against the reference's.

Every case feeds the same numpy-made inputs to the reference (its Pallas
kernels in interpret mode, as its own tests run them, or its ``ref.py``
oracles) and to the port on CPU tensors, where the wrappers run their
plain PyTorch versions. bf16 inputs are rounded once, by JAX, and handed
to the port as the same values. Tolerances are the reference's own
(``tests/test_kernels.py``) but in bf16 attention: rtol 1e-5 / atol 1e-4
in float32 attention, the recurrence rtol/atol 1e-4, the RG-LRU layer
2e-4. In bf16 attention the reference's atol of 0.2 would pass an output
that left out a 64-key tile, so there each element must lie within
2e-2 |want| + 0.1 rms(want's row), the row being one query's output
vector, as ``chip_smoke.py`` holds the kernel on the card. Both plain
versions are also held against the port's own model layers (``rg_lru``
and ``layers.attention``, which the LM path runs instead of the kernels,
as the reference's does). The CUDA kernels themselves are held against
these plain versions, and against those layers, in
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from _torch_lm import head_group, rglru_inputs
from repro_torch.kernels import flash_attention, linrec, ops, ref
from repro_torch.models import layers

torch.set_num_threads(2)



def _assert_attention_close(got, want, dtype):
    """float32: rtol 1e-5 / atol 1e-4; bf16: |got - want| <= 2e-2 |want| +
    0.1 rms(want's row) everywhere."""
    got, want = _f32(got), _f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        return
    diff = np.abs(got - want)
    limit = 2e-2 * np.abs(want) + 0.1 * np.sqrt(np.mean(np.square(want), -1, keepdims=True))
    assert (diff <= limit).all(), f"off by {diff.max()}, {(diff > limit).sum()} elements over"


def _jax_and_torch(x, dtype):
    """``x`` rounded to ``dtype`` once, as a JAX array and as a tensor."""
    xj = jnp.asarray(x.astype(np.float32)).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    return xj, xt


def _qkv(bh, s, dh, dtype, seed):
    rng = np.random.default_rng(seed)
    pairs = [_jax_and_torch(rng.normal(size=(bh, s, dh)), dtype) for _ in range(3)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _recurrence(b, s, d, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 0.999, size=(b, s, d)).astype(np.float32)
    bb = (rng.normal(size=(b, s, d)) * 0.2).astype(np.float32)
    return a, bb


# ---------------------------------------------------------------------------
# ops.attention / ops.linear_recurrence against the reference's kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bh,s,dh", [(1, 128, 64), (2, 256, 128), (3, 384, 64)])
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_reference_kernel(bh, s, dh, window, dtype):
    (qj, kj, vj), (qt, kt, vt) = _qkv(bh, s, dh, dtype, bh * s + dh)
    want = _f32(ref_ops.attention(qj, kj, vj, window=window, interpret=True))
    got = ops.attention(qt, kt, vt, window=window, device="cpu")
    assert got.dtype == qt.dtype and got.device.type == "cpu"
    _assert_attention_close(got, want, dtype)


@pytest.mark.parametrize("dh", [120, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_wide_and_odd_heads_match_reference_oracle(dh, dtype):
    """dh 120 (h2o-danube-3-4b) and 256 (recurrentgemma-9b), windowed,
    against the reference's full-softmax oracle."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, 256, dh, dtype, dh)
    want = _f32(ref_ref.flash_attention_ref(qj, kj, vj, window=96))
    got = ops.attention(qt, kt, vt, window=96, device="cpu")
    _assert_attention_close(got, want, dtype)


def test_attention_takes_numpy_inputs():
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 128, 32)).astype(np.float32) for _ in range(3))
    want = _f32(ref_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = ops.attention(q, k, v, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b,s,d", [(1, 256, 128), (2, 512, 256), (3, 1024, 128),
                                   (1, 8192, 128)])
def test_linear_recurrence_matches_reference_kernel(b, s, d):
    a, bb = _recurrence(b, s, d, b + s + d)
    want = np.asarray(ref_ops.linear_recurrence(jnp.asarray(a), jnp.asarray(bb), interpret=True))
    got = ops.linear_recurrence(a, bb, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_linear_recurrence_matches_rglru_layer():
    """The gates of the reference's RG-LRU layer through the port's
    recurrence give the layer's own output."""
    from repro.models.recurrent import _rg_lru_gates, rg_lru

    rng = np.random.default_rng(0)
    p = {
        "w_a": jnp.asarray(rng.normal(size=(128, 128)) * 0.05, jnp.float32),
        "w_x": jnp.asarray(rng.normal(size=(128, 128)) * 0.05, jnp.float32),
        "lam": jnp.asarray(rng.uniform(-4, -2, 128), jnp.float32),
    }
    x = jnp.asarray(rng.normal(size=(2, 256, 128)) * 0.3, jnp.float32)
    a, b = _rg_lru_gates(p, x)
    got = ops.linear_recurrence(np.asarray(a), np.asarray(b), device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(rg_lru(p, x), np.float32),
                               rtol=2e-4, atol=2e-4)


def test_linear_recurrence_matches_port_rglru_layer():
    """The port's own RG-LRU layer: its gates through the recurrence's
    plain version give the layer's output (the reference's
    ``test_linrec_matches_rglru_semantics`` shapes and limits)."""
    from repro_torch.models.recurrent import _rg_lru_gates, rg_lru

    p, x = rglru_inputs("cpu")
    a, b = _rg_lru_gates(p, x)
    got = ops.linear_recurrence(a, b, device="cpu")
    torch.testing.assert_close(got, rg_lru(p, x), rtol=2e-4, atol=2e-4)


def test_attention_matches_port_attention_layer():
    """One head group of recurrentgemma-9b through the attention's plain
    version gives the port's ``layers.attention`` (float32 limits), at a
    window the sequence exceeds (the card test runs the model's 2,048)."""
    cfg, p, x, q, k, v = head_group(256, "cpu")
    want = layers.attention(p, x, cfg, window=64)[0]
    got = ops.attention(q, k, v, window=64, device="cpu")
    torch.testing.assert_close(got.transpose(0, 1).reshape(want.shape), want,
                               rtol=1e-5, atol=1e-4)


def test_linear_recurrence_casts_inputs_to_float32():
    a, bb = _recurrence(1, 256, 128, 9)
    a64 = torch.from_numpy(a.astype(np.float64))
    got = ops.linear_recurrence(a64, bb, device="cpu")
    assert got.dtype == torch.float32
    assert torch.equal(got, ops.linear_recurrence(a, bb, device="cpu"))


# ---------------------------------------------------------------------------
# the port's oracles against the reference's
# ---------------------------------------------------------------------------


def test_hash_probe_oracle_matches_reference():
    rng = np.random.default_rng(2)
    keys = rng.choice(1 << 20, 300, replace=False).astype(np.int32)
    vis = rng.integers(0, 1 << 32, 300, dtype=np.uint64).astype(np.uint32)
    tk, tv, _ = ref_ops.build_hash_table(keys, vis)
    pk = np.concatenate([keys[::2], (rng.choice(1 << 20, 100) + (1 << 21)).astype(np.int32)])
    qm = np.array([1 << 3], np.uint32)
    want = np.asarray(ref_ref.hash_probe_lens_ref(jnp.asarray(pk), tk, tv, jnp.asarray(qm)))

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x)).view(np.int32))

    got = ref.hash_probe_lens_ref(t(pk), t(tk), t(tv), t(qm))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any() and (want < 0).any()


def test_seg_aggregate_oracle_matches_reference():
    rng = np.random.default_rng(4)
    codes = rng.integers(-2, 40, 3000).astype(np.int32)
    vals = rng.normal(size=(3000, 3)).astype(np.float32)
    want = np.asarray(ref_ref.seg_aggregate_ref(jnp.asarray(codes), jnp.asarray(vals), 37))
    got = ref.seg_aggregate_ref(torch.from_numpy(codes), torch.from_numpy(vals), 37)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_oracle_matches_reference(window, dtype):
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, 256, 64, dtype, 17)
    want = _f32(ref_ref.flash_attention_ref(qj, kj, vj, window=window))
    got = ref.flash_attention_ref(qt, kt, vt, window=window)
    assert got.dtype == qt.dtype
    _assert_attention_close(got, want, dtype)


def test_linrec_oracle_matches_reference():
    a, bb = _recurrence(2, 300, 16, 3)
    want = np.asarray(ref_ref.linrec_ref(jnp.asarray(a), jnp.asarray(bb)))
    got = ref.linrec_ref(torch.from_numpy(a), torch.from_numpy(bb))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def test_linrec_plain_fixes_the_kernel_order():
    """The plain version runs the kernel's three passes: per chunk of
    ``CHUNK`` steps the composition (product of a, h from 0), the carry
    into each chunk through those compositions, then each chunk from its
    carry; every product and sum rounded apart. Held bit for bit against
    that order written out in numpy float32."""
    a, bb = _recurrence(2, 512, 128, 21)
    got = linrec.linrec(torch.from_numpy(a), torch.from_numpy(bb)).numpy()
    chunk, (nb, s, d) = linrec.CHUNK, a.shape
    want = np.empty_like(a)
    for i in range(nb):
        carry = np.zeros(d, np.float32)
        for c0 in range(0, s, chunk):
            comp_a, comp_b = np.ones(d, np.float32), np.zeros(d, np.float32)
            h = carry
            for t in range(c0, c0 + chunk):
                comp_b = a[i, t] * comp_b + bb[i, t]
                comp_a = comp_a * a[i, t]
                h = a[i, t] * h + bb[i, t]
                want[i, t] = h
            carry = comp_a * carry + comp_b
    np.testing.assert_array_equal(got, want)
    # the chunked order is not the step-by-step one
    assert not np.array_equal(got, ref.linrec_ref(torch.from_numpy(a), torch.from_numpy(bb)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_plain_skips_nothing_that_matters(dtype):
    """Rows whose first 64-key tiles lie wholly before their window add
    p = 1 there (the running max is still -1e30) and have it wiped by
    alpha = 0 at their first visible key, so the result equals attention
    over the visible keys alone."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 384, 16)).astype(np.float32)).to(dtype)
               for _ in range(3))
    got = flash_attention.flash_attention_plain(q, k, v, 70).float()
    qf, kf, vf = q.float(), k.float(), v.float()
    for t in (0, 69, 70, 200, 383):
        lo = max(0, t - 69)
        w = torch.softmax(qf[0, t] @ kf[0, lo : t + 1].T / 4.0, -1)
        want = w.to(dtype).float() @ vf[0, lo : t + 1]
        torch.testing.assert_close(got[0, t], want, rtol=2e-2, atol=2e-2)


def test_bf16_attention_limit_catches_a_dropped_tile():
    """An output that leaves out each row's first 64-key tile once the row
    sees 512 keys passes the reference's bf16 tolerance (atol 0.2) at a
    causal [1, 2048, 128], but not the row-scaled limit, which the plain
    version meets."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2048, 128)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    want = ref.flash_attention_ref(q, k, v)
    pos = torch.arange(2048)
    keep = (pos[:, None] >= pos[None, :]) & ~((pos[:, None] >= 512) & (pos[None, :] < 64))
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / np.sqrt(128)
    a = torch.softmax(torch.where(keep, scores, -1e30), -1)
    dropped = torch.einsum("bqk,bkd->bqd", a.to(torch.bfloat16).float(), v.float())
    np.testing.assert_allclose(_f32(dropped), _f32(want), rtol=2e-2, atol=2e-1)
    with pytest.raises(AssertionError):
        _assert_attention_close(dropped.to(torch.bfloat16), want, "bfloat16")
    _assert_attention_close(flash_attention.flash_attention_plain(q, k, v), want, "bfloat16")


# ---------------------------------------------------------------------------
# the error contract
# ---------------------------------------------------------------------------


def _zeros(*shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(*shape, dtype=dtype, device=device)


@pytest.mark.parametrize("case,err", [
    ("seq_not_tile_aligned", ValueError),
    ("head_too_wide", ValueError),
    ("shapes_differ", ValueError),
    ("dtypes_differ", TypeError),
    ("float16", TypeError),
    ("mixed_devices", ValueError),
    ("not_cpu_or_cuda", ValueError),
    ("window_zero", ValueError),
])
def test_attention_error_contract(case, err):
    q = _zeros(1, 128, 64)
    args = {
        "seq_not_tile_aligned": (_zeros(1, 192, 64),) * 3,
        "head_too_wide": (_zeros(1, 128, 512),) * 3,
        "shapes_differ": (q, q, _zeros(1, 256, 64)),
        "dtypes_differ": (q, q, q.to(torch.bfloat16)),
        "float16": (q.half(),) * 3,
        "mixed_devices": (q, q, _zeros(1, 128, 64, device="meta")),
        "not_cpu_or_cuda": (_zeros(1, 128, 64, device="meta"),) * 3,
        "window_zero": (q, q, q),
    }[case]
    window = 0 if case == "window_zero" else None
    with pytest.raises(err):
        flash_attention.flash_attention(*args, window=window)


@pytest.mark.parametrize("case", ["seq_not_tile_aligned", "channels_not_tile_aligned",
                                  "shapes_differ", "mixed_devices", "not_cpu_or_cuda"])
def test_linear_recurrence_error_contract(case):
    a = _zeros(1, 256, 128)
    args = {
        "seq_not_tile_aligned": (_zeros(1, 128, 128),) * 2,
        "channels_not_tile_aligned": (_zeros(1, 256, 64),) * 2,
        "shapes_differ": (a, _zeros(1, 512, 128)),
        "mixed_devices": (a, _zeros(1, 256, 128, device="meta")),
        "not_cpu_or_cuda": (_zeros(1, 256, 128, device="meta"),) * 2,
    }[case]
    with pytest.raises(ValueError):
        linrec.linrec(*args)
