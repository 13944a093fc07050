"""Common transformer layers: RMSNorm, (partial) RoPE, GQA attention with
optional sliding window and KV cache, and gated MLPs.

A port of the reference's ``models/layers.py``. Every product is a plain
torch ``einsum``, as the reference's are plain ``jnp``; the kernel-ops
entry point's flash attention (``repro_torch.kernels.ops.attention``) is
held against ``attention`` in the tests, not called from here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

# chunk length for memory-bounded (flash-style) attention on long
# sequences: scores materialize per q-chunk only ([B, KV, rep, QCHUNK, S]
# float32)
QCHUNK_THRESHOLD = 2048
QCHUNK = 1024

#: the additive bias of a masked score, in float32
NEG_BIAS = -1e30


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU, which is ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(dt)


# ---------------------------------------------------------------------------
# RoPE (partial rotary supported: stablelm 25%, chatglm 50%)
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, frac: float, theta: float) -> torch.Tensor:
    """x: [B, S, H, dh]; positions: [B, S] (int). Rotates the first
    ``frac * dh`` dims (rounded down to even), passes the rest through."""
    dh = x.shape[-1]
    rot = int(dh * frac)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    ang = positions.float()[:, :, None, None] * freqs  # [B,S,1,half]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: Optional[int]):
    """[Sq, Sk] additive bias in float32."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    return torch.where(ok, 0.0, NEG_BIAS).float()


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    positions: Optional[torch.Tensor] = None,
    kv_source: Optional[torch.Tensor] = None,
    use_rope: bool = True,
) -> torch.Tensor:
    """Full-sequence attention (training/prefill). GQA: H query heads grouped
    over KV heads. Sequences beyond QCHUNK_THRESHOLD are computed QCHUNK
    queries at a time (S must then be a multiple of QCHUNK)."""
    B, S, D = x.shape
    H, KV, dh = cfg.n_heads_padded, cfg.n_kv_heads, cfg.d_head
    if positions is None:
        positions = _positions(B, S, x.device)
    kv_in = x if kv_source is None else kv_source
    Sk = kv_in.shape[1]
    kv_positions = positions if kv_source is None else _positions(B, Sk, x.device)

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dgk->bsgk", kv_in, p["wk"])
    v = torch.einsum("bsd,dgk->bsgk", kv_in, p["wv"])
    if use_rope and kv_source is None:
        q = rope(q, positions, cfg.rope_frac, cfg.rope_theta)
        k = rope(k, kv_positions, cfg.rope_frac, cfg.rope_theta)

    rep = H // KV
    qg = q.reshape(B, S, KV, rep, dh)
    scale = 1.0 / math.sqrt(dh)

    def block(q_blk, qpos_blk):
        s = torch.einsum("bqgrk,btgk->bgrqt", q_blk, k).float() * scale
        bias = _mask_bias(qpos_blk, kv_positions[0], causal and kv_source is None, window)
        s = s + bias[None, None, None]
        a = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.einsum("bgrqt,btgk->bqgrk", a, v)

    if S <= QCHUNK_THRESHOLD:
        o = block(qg, positions[0])
    else:
        nchunk = S // QCHUNK
        qg_c = qg.reshape(B, nchunk, QCHUNK, KV, rep, dh)
        pos_c = positions[0].reshape(nchunk, QCHUNK)
        o = torch.cat([block(qg_c[:, i], pos_c[i]) for i in range(nchunk)], dim=1)

    o = o.reshape(B, S, H, dh)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def attention_decode(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    pos: int,
    cfg,
    *,
    window: Optional[int] = None,
    cross: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against a KV cache. cache: {'k','v'}: [B, Smax, KV, dh].
    ``pos`` is the current position. The new K/V are written into the
    cache in place (at ``min(pos, Smax - 1)``, where the reference's
    ``dynamic_update_slice`` clamps its start); the cache is returned. For
    cross-attention the cache is the (precomputed) encoder memory and is
    not written."""
    B, S1, D = x.shape  # S1 == 1
    H, KV, dh = cfg.n_heads_padded, cfg.n_kv_heads, cfg.d_head
    pos = int(pos)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k, v = cache["k"], cache["v"]
    Smax = k.shape[1]
    if not cross:
        posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        k_new = torch.einsum("bsd,dgk->bsgk", x, p["wk"])
        v_new = torch.einsum("bsd,dgk->bsgk", x, p["wv"])
        q = rope(q, posb, cfg.rope_frac, cfg.rope_theta)
        k_new = rope(k_new, posb, cfg.rope_frac, cfg.rope_theta)
        at = min(pos, Smax - 1)
        k[:, at] = k_new[:, 0].to(k.dtype)
        v[:, at] = v_new[:, 0].to(v.dtype)
    rep = H // KV
    qg = q.reshape(B, 1, KV, rep, dh)
    scale = 1.0 / math.sqrt(dh)
    s = torch.einsum("bqgrk,btgk->bgrqt", qg, k).float() * scale
    kpos = torch.arange(Smax, dtype=torch.int32, device=x.device)
    ok = kpos[None] <= pos if not cross else torch.ones((1, Smax), dtype=torch.bool,
                                                        device=x.device)
    if window is not None and not cross:
        ok = ok & (pos - kpos[None] < window)
    s = s + torch.where(ok, 0.0, NEG_BIAS)[:, None, None, None, :]
    a = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bgrqt,btgk->bqgrk", a, v).reshape(B, 1, H, dh)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, p["w_gate"])
        u = torch.einsum("bsd,df->bsf", x, p["w_up"])
        return torch.einsum("bsf,fd->bsd", F.silu(g) * u, p["w_down"])
    if kind == "gelu":
        h = gelu(torch.einsum("bsd,df->bsf", x, p["w_up"]))
        return torch.einsum("bsf,fd->bsd", h, p["w_down"])
    if kind == "rwkv_cm":  # rwkv channel-mix: squared-relu key, receptance gate
        kx = torch.einsum("bsd,df->bsf", x, p["w_up"])
        kx = torch.square(F.relu(kx))
        r = torch.sigmoid(torch.einsum("bsd,de->bse", x, p["w_recept"]))
        return r * torch.einsum("bsf,fd->bsd", kx, p["w_down"])
    raise ValueError(kind)
