"""Recurrent blocks: RG-LRU (recurrentgemma/Griffin) and RWKV6 (Finch).

A port of the reference's ``models/recurrent.py``.

RG-LRU: real-gated linear recurrent unit. h_t = a_t * h_{t-1} +
sqrt(1-a_t^2) * (i_t * x_t), a_t = exp(-c * softplus(L) * r_t). The scan
is a first-order elementwise linear recurrence, computed as a log-depth
doubling scan of the combine (a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2).
A running product of the decays (a cumprod) would underflow. The
kernel-ops recurrence (``repro_torch.kernels.ops.linear_recurrence``)
computes the same recurrence; the tests hold it against ``rg_lru``.

RWKV6: data-dependent per-channel decay linear attention. Per head,
S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] v_t[j];
o_t[j] = sum_i r_t[i] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j]).
Computed chunk-parallel (intra-chunk products + inter-chunk state carry).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import gelu

RG_LRU_C = 8.0


# ---------------------------------------------------------------------------
# RG-LRU (recurrentgemma)
# ---------------------------------------------------------------------------


def _rg_lru_gates(p, x):
    r = torch.sigmoid(torch.einsum("bsr,ro->bso", x, p["w_a"]))
    i = torch.sigmoid(torch.einsum("bsr,ro->bso", x, p["w_x"]))
    log_a = -RG_LRU_C * F.softplus(p["lam"].float()) * r.float()
    a = torch.exp(log_a)
    gated = (i * x).float() * torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return a, gated


RG_CHUNK = 512


def _scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the combine (a1, b1), (a2, b2) ->
    (a1 a2, b1 a2 + b2), by doubling: log2(S) steps. Returns (A, B) with
    h_t = A_t h_{-1} + B_t."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def rg_lru(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, R] -> [B, S, R].

    Chunked: a sequential loop over S/RG_CHUNK chunks carrying h [B, R],
    with a log-depth scan inside each chunk, as in the reference."""
    B, S, R = x.shape
    a, b = _rg_lru_gates(p, x)
    if S <= RG_CHUNK or S % RG_CHUNK != 0:
        return _scan(a, b)[1].to(x.dtype)
    h0 = torch.zeros((B, R), dtype=torch.float32, device=x.device)
    hs = []
    for c in range(S // RG_CHUNK):
        sl = slice(c * RG_CHUNK, (c + 1) * RG_CHUNK)
        A, Bv = _scan(a[:, sl], b[:, sl])
        h = A * h0[:, None] + Bv
        h0 = h[:, -1]
        hs.append(h)
    return torch.cat(hs, dim=1).to(x.dtype)


def rg_lru_decode(
    p: Dict[str, torch.Tensor], x: torch.Tensor, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-step recurrence. x: [B, 1, R]; h: [B, R]."""
    a, b = _rg_lru_gates(p, x)
    h_new = a[:, 0] * h + b[:, 0]
    return h_new.to(x.dtype)[:, None], h_new


def causal_conv1d(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width W. x: [B,S,R]; p['conv_w']: [W, R]."""
    W = p["conv_w"].shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i : i + x.shape[1]] * p["conv_w"][i]
    return out + p["conv_b"]


def causal_conv1d_decode(p, x, buf):
    """x: [B,1,R], buf: [B, W-1, R] previous inputs."""
    win = torch.cat([buf, x], dim=1)  # [B, W, R]
    out = torch.einsum("bwr,wr->br", win, p["conv_w"]) + p["conv_b"]
    return out[:, None], win[:, 1:]


def recurrent_block(p, x, cfg):
    """Griffin recurrent block: (gelu gate branch) * (conv -> RG-LRU branch)."""
    g = gelu(torch.einsum("bsd,dr->bsr", x, p["w_gate_in"]))
    y = torch.einsum("bsd,dr->bsr", x, p["w_rec_in"])
    y = causal_conv1d(p, y)
    y = rg_lru(p, y)
    return torch.einsum("bsr,rd->bsd", g * y, p["w_out"])


def recurrent_block_decode(p, x, state, cfg):
    """Returns (out, new state); ``state`` is left as it was."""
    g = gelu(torch.einsum("bsd,dr->bsr", x, p["w_gate_in"]))
    y = torch.einsum("bsd,dr->bsr", x, p["w_rec_in"])
    y, conv_buf = causal_conv1d_decode(p, y, state["conv"])
    y, h = rg_lru_decode(p, y, state["h"])
    out = torch.einsum("bsr,rd->bsd", g * y, p["w_out"])
    return out, {"conv": conv_buf, "h": h}


# ---------------------------------------------------------------------------
# RWKV6 time-mix (chunked linear attention with data-dependent decay)
# ---------------------------------------------------------------------------


def _decay(p, xw):
    """Finch's data-dependent decay w in (0, 1) from the mixed input, by a
    low-rank MLP. The floor exp(wlog) <= 5 bounds the per-chunk exponent
    so the chunked relative-decay factorization stays inside float32's
    range (5 * chunk(16) = 80 < log(fp32_max) ~ 88)."""
    dd = torch.tanh(torch.einsum("bsd,dl->bsl", xw, p["w_dec1"]))
    wlog = p["w_dec0"] + torch.einsum("bsl,lk->bsk", dd, p["w_dec2"])
    wlog = torch.clamp(wlog.float(), max=1.609)
    return torch.exp(-torch.exp(wlog))


def _rwkv_proj(p, x, cfg):
    """Token-shift mixing + r/k/v/g and data-dependent decay w."""
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.rwkv_head_dim
    xx = F.pad(x, (0, 0, 1, 0))[:, :-1]  # previous token

    def mix(mu):
        return x * mu + xx * (1.0 - mu)

    r = torch.einsum("bsd,dk->bsk", mix(p["mu_r"]), p["w_r"]).reshape(B, S, H, dh)
    k = torch.einsum("bsd,dk->bsk", mix(p["mu_k"]), p["w_k"]).reshape(B, S, H, dh)
    v = torch.einsum("bsd,dk->bsk", mix(p["mu_v"]), p["w_v"]).reshape(B, S, H, dh)
    g = F.silu(torch.einsum("bsd,dk->bsk", mix(p["mu_g"]), p["w_g"]))
    w = _decay(p, mix(p["mu_w"])).reshape(B, S, H, dh)
    return r, k, v, g, w


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and held in float32: the reference feeds its
    chunk products bf16 inputs and accumulates them in float32
    (``preferred_element_type``). A bf16 product would round its output
    too, on the card, so the port multiplies the rounded values in
    float32."""
    return t.to(torch.bfloat16).float()


def rwkv_time_mix(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.rwkv_head_dim
    r, k, v, g, w = _rwkv_proj(p, x, cfg)
    u = p["u"].reshape(H, dh)

    T = cfg.rwkv_chunk
    n = S // T if S % T == 0 else None
    if n is None:  # pad to chunk multiple; padded steps decay by w = 1
        pad = T - S % T
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
        n = (S + pad) // T

    def chunks(t):  # [B, n*T, H, dh] -> [n, B, H, T, dh]
        return t.reshape(B, n, T, H, dh).permute(1, 0, 3, 2, 4).float()

    rc, kc, vc, wc = chunks(r), chunks(k), chunks(v), chunks(w)
    tri = torch.tril(torch.ones((T, T), dtype=torch.float32, device=x.device), -1)
    S_carry = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device)
    outs = []
    for c in range(n):
        rc_, kc_, vc_, wc_ = rc[c], kc[c], vc[c], wc[c]  # [B,H,T,dh]
        logw = torch.log(torch.clamp(wc_, min=1e-30))
        cw = torch.cumsum(logw, dim=2)  # inclusive cumulative log-decay
        Wtot = torch.exp(cw[:, :, -1])  # [B,H,dh]
        decay_to_t = torch.exp(cw - logw)  # prod_{tau < t}
        r_in = _bf16(rc_ * decay_to_t)
        # inter-chunk: o_inter[t] = (r_t * decay_to_t) @ S
        o_inter = torch.einsum("bhtk,bhkv->bhtv", r_in, _bf16(S_carry))
        # intra-chunk: A[t,s] = sum_i r_t[i] k_s[i] prod_{s<tau<t} w_tau[i], s<t
        k_out = _bf16(kc_ * torch.exp(cw[:, :, -1:] - cw))
        k_rel = _bf16(kc_ * torch.exp(-cw))
        A = torch.einsum("bhtk,bhsk->bhts", r_in, k_rel) * tri
        vb = _bf16(vc_)
        o_intra = torch.einsum("bhts,bhsv->bhtv", _bf16(A), vb)
        # diagonal bonus term: u * k_t
        diag = torch.einsum("bhtk,bhtk->bht", rc_, kc_ * u[None, :, None, :])
        o_diag = diag[..., None] * vc_
        # state update: S' = S * Wtot + sum_s k_s (prod_{s<tau<=end} w) v_s
        S_carry = S_carry * Wtot[..., None] + torch.einsum("bhsk,bhsv->bhkv", k_out, vb)
        outs.append(o_inter + o_intra + o_diag)
    oc = torch.stack(outs)  # [n, B, H, T, dh]
    o = oc.permute(1, 0, 3, 2, 4).reshape(B, -1, H, dh)[:, :S]
    o = _rwkv_groupnorm(p, o).to(x.dtype) * g.reshape(B, S, H, dh)
    return torch.einsum("bsk,kd->bsd", o.reshape(B, S, H * dh), p["w_o"])


def _rwkv_groupnorm(p, o):
    """Per-head norm with the population variance and eps 64e-5."""
    mean = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, unbiased=False)
    return (o - mean) * torch.rsqrt(var + 64e-5) * p["ln_w"].reshape(
        1, 1, *p["ln_w"].shape
    ) + p["ln_b"].reshape(1, 1, *p["ln_b"].shape)


def rwkv_time_mix_decode(p, x, state, cfg):
    """One step. state['S']: [B,H,dh,dh] float32. Returns (out, new state);
    ``state`` is left as it was."""
    B, S1, D = x.shape
    H, dh = cfg.n_heads, cfg.rwkv_head_dim
    # token-shift uses the previous input stored in state
    xx = state["x_prev"][:, None]

    def mix(mu):
        return x * mu + xx * (1.0 - mu)

    r = torch.einsum("bsd,dk->bsk", mix(p["mu_r"]), p["w_r"]).reshape(B, H, dh)
    k = torch.einsum("bsd,dk->bsk", mix(p["mu_k"]), p["w_k"]).reshape(B, H, dh)
    v = torch.einsum("bsd,dk->bsk", mix(p["mu_v"]), p["w_v"]).reshape(B, H, dh)
    g = F.silu(torch.einsum("bsd,dk->bsk", mix(p["mu_g"]), p["w_g"]))
    w = _decay(p, mix(p["mu_w"])).reshape(B, H, dh)
    u = p["u"].reshape(H, dh)

    Sm = state["S"]
    rf, kf, vf = r.float(), k.float(), v.float()
    bonus = (u[None] * kf)[..., None] * vf[:, :, None, :]
    o = torch.einsum("bhk,bhkv->bhv", rf, Sm + bonus)
    S_new = Sm * w[..., None] + kf[..., None] * vf[:, :, None, :]
    o = _rwkv_groupnorm(p, o.reshape(B, 1, H, dh))[:, 0]
    o = (o * g.reshape(B, H, dh)).reshape(B, 1, H * dh).to(x.dtype)
    out = torch.einsum("bsk,kd->bsd", o, p["w_o"])
    return out, {"S": S_new, "x_prev": x[:, 0]}
