"""Inputs shared by the CPU and card tests that hold the kernel-ops entry
point (``ops.linear_recurrence``, B8; ``ops.attention``, B9) against the
port's model layers (``rg_lru``, ``layers.attention``). Imports only
torch, numpy and the port."""

import math

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers


def rglru_inputs(device):
    """The RG-LRU parameters and input of the reference's
    ``test_linrec_matches_rglru_semantics``: width 128, ``[2, 256, 128]``."""
    rng = np.random.default_rng(0)
    p = {
        "w_a": rng.normal(size=(128, 128)) * 0.05,
        "w_x": rng.normal(size=(128, 128)) * 0.05,
        "lam": rng.uniform(-4, -2, 128),
    }
    x = rng.normal(size=(2, 256, 128)) * 0.3
    p = {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in p.items()}
    return p, torch.from_numpy(x.astype(np.float32)).to(device)


def head_group(seq, device):
    """One head group of recurrentgemma-9b's local attention (16 query
    heads over one KV head, d_head 256, d_model 4,096 = 16 * 256), float32,
    over ``seq`` positions. Returns (cfg, params, x, q, k, v): ``wo`` is the
    identity, so ``layers.attention(params, x, cfg, window=w)[0]`` is the
    heads' output ``[seq, 16 * 256]`` itself; q, k and v are that call's
    projected and rotated heads as ``[16, seq, 256]`` (the KV head repeated
    for each query head), the kernel-ops layout."""
    cfg = get_config("recurrentgemma-9b")
    D, H, dh = cfg.d_model, cfg.n_heads_padded, cfg.d_head
    assert cfg.n_kv_heads == 1 and H * dh == D
    rng = np.random.default_rng(1)

    def w(*shape):
        return torch.from_numpy((rng.normal(size=shape) / math.sqrt(D)).astype(np.float32))

    p = {"wq": w(D, H, dh), "wk": w(D, 1, dh), "wv": w(D, 1, dh),
         "wo": torch.eye(D).reshape(H, dh, D)}
    p = {k: v.to(device) for k, v in p.items()}
    x = torch.from_numpy(rng.normal(size=(1, seq, D)).astype(np.float32)).to(device)
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None]
    q = layers.rope(torch.einsum("bsd,dhk->bshk", x, p["wq"]), pos, cfg.rope_frac, cfg.rope_theta)
    k = layers.rope(torch.einsum("bsd,dgk->bsgk", x, p["wk"]), pos, cfg.rope_frac, cfg.rope_theta)
    v = torch.einsum("bsd,dgk->bsgk", x, p["wv"])
    heads = [t[0].transpose(0, 1).expand(H, seq, dh).contiguous() for t in (q, k, v)]
    return (cfg, p, x, *heads)


def spread_params(tree, seed=0):
    """A copy of a parameter tree of numpy arrays (the reference's
    ``init_params`` as numpy) whose constant-initialised leaves are drawn
    at random from ``seed``: norm weights and biases, the RWKV decay base,
    token-shift mixes and the conv bias. At their initial values (zeros,
    0.5) the RWKV head norm's weight zeroes the whole time-mix and every
    norm is the same, so no comparison could see them."""
    rng = np.random.default_rng(seed)

    def draw(name, a):
        if name == "ln_w":
            return 1.0 + 0.1 * rng.normal(size=a.shape)
        if name.startswith(("ln", "final_norm", "enc_final_norm", "conv_b")):
            return 0.1 * rng.normal(size=a.shape)
        if name == "w_dec0":
            return 0.5 * rng.normal(size=a.shape)
        if name.startswith("mu"):
            return rng.uniform(0.0, 1.0, size=a.shape)
        return a

    def walk(t, name=""):
        if isinstance(t, dict):
            return {k: walk(t[k], k) for k in sorted(t)}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return np.asarray(draw(name, t), dtype=t.dtype)

    return walk(tree)
