"""Causal, optionally sliding-window, attention with an online softmax.

``flash_attention`` ports the reference's Pallas kernel
(``src/repro/kernels/flash_attention.py`` ``_flash_kernel``: 128 x 128
tiles, the KV tiles as its sequential grid dimension) to hand-written CUDA
(``csrc/flash_attention.cu``; the note at its top says what bounds it and
how it is built), both on the tensor cores: bf16 through ``wgmma`` fed by
TMA, float32 through ``mma.sync`` with each product taken as three TF32
products (each operand split into its TF32 rounding and the rest,
``a_hi b_lo + a_lo b_hi + a_hi b_hi``), which holds float32's limits where
one TF32 product does not. The layout is the reference's, ``[BH, S,
dh]``, and so are the semantics: scores accumulated in float32 and scaled
by 1/sqrt(dh), masked scores -1e30, float32 ``m``, ``l`` and ``acc``,
``p`` rounded to ``v``'s type before the P.V product (not rounded in
float32), the output ``acc / max(l, 1e-30)`` in ``q``'s type.

The plain version walks 64-key tiles (the bf16 kernel's) in the same
online softmax, every tile for every row (a tile the kernels skip adds exactly
nothing there), so in bf16 it rounds ``p`` at the same running maxima.
They add their products in other orders, so they agree within float32
rounding, not bit for bit: the tests and ``chip_smoke.py`` hold them, and
both against the full-softmax oracle, within rtol 1e-5 / atol 1e-4 in
float32 (the reference's tolerance) and, in bf16, within 2e-2 |want| + 0.1
rms(want's row), the row being one query's output.
"""

from __future__ import annotations

import math
import numbers

import torch
import torch.nn.functional as F

from . import _build

#: the reference's sequence tile (``flash_attention.py`` BLOCK_Q, BLOCK_K)
SEQ_MULTIPLE = 128
#: keys per tile of the kernels' online softmax
BLOCK_K = 64
#: the largest head width the kernels' register tiles hold
MAX_HEAD_DIM = 256
#: head-width tiers of the kernels; the kernels take rows of a multiple of 8
#: elements (a bf16 TMA row is a multiple of 16 bytes, a float32 row a whole
#: number of 16-byte copies), so rows of another width are padded with zero
#: columns to their tier
WIDTH_TIERS = (64, 128, 256)
ROW_MULTIPLE = 8
#: the byte boundary the kernels need each operand's base address on
ALIGN = 16
NEG = -1e30
DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, window):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k and v of one shape [BH, S, dh], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: q, k and v all float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, v on {v.device}")
    _, s, dh = q.shape
    if s % SEQ_MULTIPLE:
        raise ValueError(f"flash_attention: S ({s}) must be a multiple of {SEQ_MULTIPLE}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head width {dh} outside [1, {MAX_HEAD_DIM}]")
    if window is not None and (isinstance(window, bool)
                               or not isinstance(window, numbers.Integral) or window < 1):
        raise ValueError(f"flash_attention: window must be None or an int >= 1, got {window!r}")


def flash_attention_plain(q, k, v, window=None):
    """The kernels' online softmax over 64-key tiles, in PyTorch."""
    bh, s, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    qf, kf, vf = q.float(), k.float(), v.float()
    dev = q.device
    m = torch.full((bh, s), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros(bh, s, dtype=torch.float32, device=dev)
    acc = torch.zeros(bh, s, dh, dtype=torch.float32, device=dev)
    qpos = torch.arange(s, device=dev)[:, None]
    for k0 in range(0, s, BLOCK_K):
        sc = torch.matmul(qf, kf[:, k0 : k0 + BLOCK_K].transpose(1, 2)) * scale
        kpos = torch.arange(k0, k0 + BLOCK_K, device=dev)[None, :]
        ok = qpos >= kpos
        if window is not None:
            ok &= qpos - kpos < window
        sc = torch.where(ok, sc, NEG)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = torch.matmul(p.to(v.dtype).float(), vf[:, k0 : k0 + BLOCK_K])
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def flash_attention(q, k, v, *, window=None):
    """``q``, ``k``, ``v`` ``[BH, S, dh]`` (all float32 or all bfloat16,
    S a multiple of 128, dh <= 256) -> causal attention ``[BH, S, dh]`` in
    ``q``'s type; with ``window``, query t sees keys (t - window, t]."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {q.device}; the kernel runs on a CUDA card")
    # the kernels read rows from 16-byte aligned bases (TMA, cp.async): a
    # view that starts elsewhere in its storage is copied to its own
    q, k, v = (t.contiguous() if t.data_ptr() % ALIGN == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    bh, s, dh = q.shape
    width = dh
    if dh % ROW_MULTIPLE:
        width = next(t for t in WIDTH_TIERS if t >= dh)
        q, k, v = (F.pad(t, (0, width - dh)) for t in (q, k, v))
    o = torch.empty_like(q)
    fn = _build.bind("flash_attention", "fa_flash_attention", 4, 6, 1)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, width,
        0 if window is None else min(int(window), s), int(q.dtype == torch.bfloat16), dh,
        _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_attention")
    _build.count_launch("flash_attention")
    return o if width == dh else o[..., :dh].contiguous()
