"""Model assembly: parameter trees, training forward, prefill, and decode.

A port of the reference's ``models/model.py`` that keeps its parameter
tree: ``groups`` is a list of repetition groups (one per repetition
pattern, e.g. recurrentgemma's ("rec", "rec", "attn") period), each a dict
of blocks whose leaves carry a leading repetition dim; beside it
``embed``, ``final_norm``, ``lm_head`` (unless tied) and, for an
encoder-decoder, ``enc_groups`` and ``enc_final_norm``. Where the
reference scans a group with ``lax.scan``, the port loops over its
repetitions in eager torch.

Modes:
* forward_train: full-sequence forward to the final hidden states,
* prefill: full-sequence, also returns the per-layer KV caches,
* decode_step: one token against ring-buffer KV caches / recurrent
  states, written in place (``launch.serve.fork`` copies a cache).

``params_from_numpy`` / ``params_to_numpy`` carry a parameter tree across
as numpy arrays of the same nesting, so that the reference's parameters
can be computed on here.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from .layers import attention, attention_decode, mlp, rms_norm, rope
from .moe import moe_ffn
from .recurrent import (
    recurrent_block,
    recurrent_block_decode,
    rwkv_time_mix,
    rwkv_time_mix_decode,
)

# ---------------------------------------------------------------------------
# Devices and trees
# ---------------------------------------------------------------------------


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for the card where none is
    visible raises, since nothing here carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} needs a CUDA card and none is visible; pass "
            "device='cpu' to run on the CPU"
        )
    return dev


def tree_map(fn: Callable, tree, is_leaf: Callable[[Any], bool]):
    """``fn`` over the leaves of a tree of dicts and lists."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, is_leaf) for v in tree]
    raise TypeError(f"not a leaf, dict or list: {type(tree).__name__}")


def _is_shape(x) -> bool:
    return isinstance(x, tuple)


def _is_shape_dtype(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def params_from_numpy(tree, device="cuda"):
    """A tree of numpy arrays (the reference's parameters or cache, as
    ``np.asarray`` of each leaf, same nesting) as tensors on ``device``,
    each keeping its dtype."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree,
                    lambda x: isinstance(x, np.ndarray))


def params_to_numpy(tree):
    """The tensors of a tree as numpy arrays (on the host), same nesting."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree,
                    lambda x: isinstance(x, torch.Tensor))


# ---------------------------------------------------------------------------
# Layer grouping
# ---------------------------------------------------------------------------


def layer_groups(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """[(pattern, n_repetitions)] covering cfg.n_layers decoder layers."""
    pattern = cfg.block_pattern or ("attn",)
    period = len(pattern)
    n_full, rem = divmod(cfg.n_layers, period)
    groups = []
    if n_full:
        groups.append((tuple(pattern), n_full))
    if rem:
        groups.append((tuple(pattern[:rem]), 1))
    return groups


def _block_kinds(pattern: Tuple[str, ...]) -> List[str]:
    return [f"{k}{i}" for i, k in enumerate(pattern)]


def _rep(tree, r: int):
    """Repetition ``r`` of a group's (or a group cache's) stacked leaves:
    views, so a write lands in the stacked tensor."""
    return {k: _rep(v, r) if isinstance(v, dict) else v[r] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def _attn_defs(cfg, cross=False):
    D, H, KV, dh = cfg.d_model, cfg.n_heads_padded, cfg.n_kv_heads, cfg.d_head
    pre = "c" if cross else ""
    return {
        f"{pre}wq": (D, H, dh),
        f"{pre}wk": (D, KV, dh),
        f"{pre}wv": (D, KV, dh),
        f"{pre}wo": (H, dh, D),
    }


def _ffn_defs(cfg, moe_layer: bool):
    D, F = cfg.d_model, cfg.d_ff
    if moe_layer:
        mc = cfg.moe
        E, Fe = mc.n_experts, mc.d_ff_expert
        d = {
            "router": (D, E),
            "w_gate": (E, D, Fe),
            "w_up": (E, D, Fe),
            "w_down": (E, Fe, D),
        }
        if mc.n_shared:
            d.update(
                shared_gate=(D, Fe * mc.n_shared),
                shared_up=(D, Fe * mc.n_shared),
                shared_down=(Fe * mc.n_shared, D),
            )
        return d
    if cfg.mlp_kind == "swiglu":
        return {"w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}
    if cfg.mlp_kind == "gelu":
        return {"w_up": (D, F), "w_down": (F, D)}
    if cfg.mlp_kind == "rwkv_cm":
        return {"w_up": (D, F), "w_down": (F, D), "w_recept": (D, D)}
    raise ValueError(cfg.mlp_kind)


def _block_defs(cfg, kind: str, cross: bool) -> Dict[str, Tuple[int, ...]]:
    D, R = cfg.d_model, cfg.lru_dim
    if kind.startswith("attn"):
        moe_layer = cfg.moe is not None and not kind.startswith("attn_dense")
        d = {"ln1": (D,), "ln2": (D,)}
        d.update(_attn_defs(cfg))
        d.update(_ffn_defs(cfg, moe_layer))
        if cross:
            d["ln_cross"] = (D,)
            d.update(_attn_defs(cfg, cross=True))
        return d
    if kind.startswith("rec"):
        d = {
            "ln1": (D,),
            "ln2": (D,),
            "w_gate_in": (D, R),
            "w_rec_in": (D, R),
            "conv_w": (cfg.conv_width, R),
            "conv_b": (R,),
            "w_a": (R, R),
            "w_x": (R, R),
            "lam": (R,),
            "w_out": (R, D),
        }
        d.update(_ffn_defs(cfg, False))
        return d
    if kind.startswith("rwkv"):
        K = cfg.n_heads * cfg.rwkv_head_dim
        d = {
            "ln1": (D,),
            "ln2": (D,),
            "w_r": (D, K),
            "w_k": (D, K),
            "w_v": (D, K),
            "w_g": (D, K),
            "w_o": (K, D),
            "w_dec0": (K,),
            "w_dec1": (D, 64),
            "w_dec2": (64, K),
            "u": (K,),
            "ln_w": (cfg.n_heads, cfg.rwkv_head_dim),
            "ln_b": (cfg.n_heads, cfg.rwkv_head_dim),
            "mu_r": (D,),
            "mu_k": (D,),
            "mu_v": (D,),
            "mu_g": (D,),
            "mu_w": (D,),
        }
        d.update(_ffn_defs(cfg, False))
        return d
    raise ValueError(kind)


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """Shape tree (tuples) for the whole model."""
    Vp, D = cfg.vocab_padded, cfg.d_model
    cross = cfg.n_encoder_layers > 0
    tree: Dict[str, Any] = {"embed": (Vp, D), "final_norm": (D,)}
    if not cfg.tied_embeddings:
        tree["lm_head"] = (D, Vp)
    groups = []
    for pattern, n_rep in layer_groups(cfg):
        g = {}
        for name, kind in zip(_block_kinds(pattern), pattern):
            g[name] = {
                k: (n_rep,) + shape for k, shape in _block_defs(cfg, kind, cross).items()
            }
        groups.append(g)
    tree["groups"] = groups
    if cross:
        eg = {
            "attn0": {
                k: (cfg.n_encoder_layers,) + s
                for k, s in _block_defs(cfg, "attn", False).items()
            }
        }
        tree["enc_groups"] = [eg]
        tree["enc_final_norm"] = (D,)
    return tree


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16):
    """The parameter tree as ``meta`` tensors: shapes and dtypes, no
    storage."""
    return tree_map(lambda s: torch.empty(s, dtype=dtype, device="meta"),
                    param_defs(cfg), _is_shape)


def _init_leaf(name: str, shape, gen: torch.Generator, dev, dtype) -> torch.Tensor:
    """One leaf by the reference's rule for its name."""
    f32 = dict(dtype=torch.float32, device=dev)
    if name.startswith(("ln", "final_norm", "enc_final_norm", "conv_b", "w_dec0")):
        return torch.zeros(shape, dtype=dtype, device=dev)
    if name.startswith("mu"):
        return torch.full(shape, 0.5, dtype=dtype, device=dev)
    if name == "lam":
        # so that the decay a = exp(-c*softplus(lam)) ~ U(0.9, 0.99)
        return torch.empty(shape, **f32).uniform_(-4.0, -2.0, generator=gen).to(dtype)
    if name == "u":
        return (torch.randn(shape, generator=gen, **f32) * 0.1).to(dtype)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = 0.02 if name == "embed" else 1.0 / math.sqrt(max(fan_in, 1))
    return (torch.randn(shape, generator=gen, **f32) * scale).to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=torch.float32):
    """Random parameters drawn from ``generator`` (on ``device``), leaf by
    leaf in the reference's order (its tree's sorted keys), each by the
    reference's rule for its name. The values are not the reference's:
    ``jax.random`` and torch's generators draw other bits."""
    dev = resolve_device(device)

    def build(tree, name=""):
        if _is_shape(tree):
            return _init_leaf(name, tree, generator, dev, dtype)
        if isinstance(tree, list):
            return [build(v) for v in tree]
        return {k: build(tree[k], k) for k in sorted(tree)}

    return build(param_defs(cfg))


# ---------------------------------------------------------------------------
# Blocks (forward)
# ---------------------------------------------------------------------------


def _cross_params(p):
    return {"wq": p["cwq"], "wk": p["cwk"], "wv": p["cwv"], "wo": p["cwo"]}


def _ffn_apply(cfg, p, x):
    if cfg.moe is not None and "router" in p:
        return moe_ffn(p, x, cfg)
    return mlp(p, x, cfg.mlp_kind)


def _block_apply(cfg, kind: str, p, x, *, causal=True, memory=None):
    if kind.startswith("attn"):
        window = cfg.attn_window if causal else None
        x = x + attention(p, rms_norm(p["ln1"], x), cfg, causal=causal, window=window)
        if memory is not None:
            x = x + attention(_cross_params(p), rms_norm(p["ln_cross"], x), cfg,
                              causal=False, kv_source=memory, use_rope=False)
        x = x + _ffn_apply(cfg, p, rms_norm(p["ln2"], x))
    elif kind.startswith("rec"):
        x = x + recurrent_block(p, rms_norm(p["ln1"], x), cfg)
        x = x + mlp(p, rms_norm(p["ln2"], x), cfg.mlp_kind)
    elif kind.startswith("rwkv"):
        x = x + rwkv_time_mix(p, rms_norm(p["ln1"], x), cfg)
        x = x + mlp(p, rms_norm(p["ln2"], x), cfg.mlp_kind)
    else:
        raise ValueError(kind)
    return x


def _run_groups(cfg, groups_params, patterns, x, *, causal, memory):
    for (pattern, n_rep), gp in zip(patterns, groups_params):
        kinds = _block_kinds(pattern)
        for r in range(n_rep):
            pp = _rep(gp, r)
            for name, kind in zip(kinds, pattern):
                x = _block_apply(cfg, kind, pp[name], x, causal=causal, memory=memory)
    return x


def encode(cfg: ModelConfig, params, src_embeds: torch.Tensor) -> torch.Tensor:
    """The encoder stack over ``src_embeds``: the decoder's cross-attention
    memory [B, S_src, D]."""
    m = src_embeds.to(params["embed"].dtype)
    m = _run_groups(cfg, params["enc_groups"], [(("attn",), cfg.n_encoder_layers)], m,
                    causal=False, memory=None)
    return rms_norm(params["enc_final_norm"], m)


# ---------------------------------------------------------------------------
# Public forward passes
# ---------------------------------------------------------------------------


def embed_tokens(cfg, params, tokens):
    return params["embed"][tokens]


def forward_train(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """-> final hidden states [B, S, D]."""
    x = embed_tokens(cfg, params, batch["tokens"]).to(params["embed"].dtype)
    if cfg.frontend == "vision_stub":
        x = torch.cat([batch["prefix_embeds"].to(x.dtype), x], dim=1)
    memory = encode(cfg, params, batch["src_embeds"]) if cfg.n_encoder_layers else None
    x = _run_groups(cfg, params["groups"], layer_groups(cfg), x, causal=True, memory=memory)
    return rms_norm(params["final_norm"], x)


def lm_head_weight(cfg, params):
    if cfg.tied_embeddings:
        return params["embed"].T
    return params["lm_head"]


def loss_fn(cfg: ModelConfig, params, batch, chunk: int = 1024):
    """Chunked softmax cross-entropy over the first (S // chunk) * chunk
    targets, as in the reference (the [B,S,V] logits never materialize at
    once). Forward only."""
    hidden = forward_train(cfg, params, batch)
    targets = batch["targets"]
    S = targets.shape[1]
    hidden = hidden[:, -S:]  # vlm: loss over the text suffix only
    W = lm_head_weight(cfg, params)
    chunk = min(chunk, S)
    n = S // chunk
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n):
        h = hidden[:, c * chunk : (c + 1) * chunk]
        t = targets[:, c * chunk : (c + 1) * chunk].long()
        logits = torch.einsum("bsd,dv->bsv", h, W).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t[..., None])[..., 0]
        total = total + torch.sum(lse - gold)
    return total / (targets.shape[0] * n * chunk)


# ---------------------------------------------------------------------------
# Serving: prefill & decode
# ---------------------------------------------------------------------------


def cache_defs(cfg: ModelConfig, batch: int, cache_len: int, dtype=torch.bfloat16):
    """Shape/dtype tree of the decode cache (ring-buffer KV / recurrent)."""
    KV, dh, R, D = cfg.n_kv_heads, cfg.d_head, cfg.lru_dim, cfg.d_model
    H = cfg.n_heads
    cross = cfg.n_encoder_layers > 0
    groups = []
    for pattern, n_rep in layer_groups(cfg):
        g = {}
        for name, kind in zip(_block_kinds(pattern), pattern):
            if kind.startswith("attn"):
                cap = cache_len if cfg.attn_window is None else min(cache_len, cfg.attn_window)
                ent = {
                    "k": ((n_rep, batch, cap, KV, dh), dtype),
                    "v": ((n_rep, batch, cap, KV, dh), dtype),
                    "pos": ((n_rep, cap), torch.int32),
                }
                if cross:
                    src = max(cache_len // 4, 1)
                    ent["ck"] = ((n_rep, batch, src, KV, dh), dtype)
                    ent["cv"] = ((n_rep, batch, src, KV, dh), dtype)
                g[name] = ent
            elif kind.startswith("rec"):
                g[name] = {
                    "h": ((n_rep, batch, R), torch.float32),
                    "conv": ((n_rep, batch, cfg.conv_width - 1, R), dtype),
                }
            elif kind.startswith("rwkv"):
                g[name] = {
                    "S": ((n_rep, batch, H, cfg.rwkv_head_dim, cfg.rwkv_head_dim),
                          torch.float32),
                    "x_prev": ((n_rep, batch, D), dtype),
                }
        groups.append(g)
    return groups


def abstract_cache(cfg, batch, cache_len, dtype=torch.bfloat16):
    """The decode cache as ``meta`` tensors."""
    return tree_map(lambda sd: torch.empty(sd[0], dtype=sd[1], device="meta"),
                    cache_defs(cfg, batch, cache_len, dtype), _is_shape_dtype)


def init_cache(cfg, batch, cache_len, dtype=torch.bfloat16, device="cuda"):
    """An empty decode cache on ``device``: zeros, and ring positions of
    -2^30 (no slot holds a position yet)."""
    dev = resolve_device(device)

    def mk(sd):
        shape, dt = sd
        if dt == torch.int32:
            return torch.full(shape, -(1 << 30), dtype=torch.int32, device=dev)
        return torch.zeros(shape, dtype=dt, device=dev)

    return tree_map(mk, cache_defs(cfg, batch, cache_len, dtype), _is_shape_dtype)


def _attn_ring_decode(p, x, c, pos: int, cfg, window):
    """Ring-buffer KV decode: slot = pos % capacity, masked by stored pos.
    Writes the new K/V and position into ``c`` in place."""
    B = x.shape[0]
    H, KV, dh = cfg.n_heads_padded, cfg.n_kv_heads, cfg.d_head
    cap = c["k"].shape[1]
    slot = pos % cap
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    k_new = rope(torch.einsum("bsd,dgk->bsgk", x, p["wk"]), posb, cfg.rope_frac, cfg.rope_theta)
    v_new = torch.einsum("bsd,dgk->bsgk", x, p["wv"])
    q = rope(q, posb, cfg.rope_frac, cfg.rope_theta)
    k, v, posbuf = c["k"], c["v"], c["pos"]
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    posbuf[slot] = pos
    rep = H // KV
    qg = q.reshape(B, 1, KV, rep, dh)
    s = torch.einsum("bqgrk,btgk->bgrqt", qg, k).float() / math.sqrt(dh)
    ok = (posbuf >= 0) & (posbuf <= pos)
    if window is not None:
        ok &= pos - posbuf < window
    s = s + torch.where(ok, 0.0, -1e30)[None, None, None, None, :]
    a = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bgrqt,btgk->bqgrk", a, v).reshape(B, 1, H, dh)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def _write(c, new):
    """Copy a block's new recurrent state into its cache entry, in place."""
    for k, v in new.items():
        c[k].copy_(v)


def _block_decode(cfg, kind, p, c, x, pos: int):
    """One block of one decode step; ``c`` (this repetition's cache entry,
    views of the stacked cache) is updated in place."""
    if kind.startswith("attn"):
        x = x + _attn_ring_decode(p, rms_norm(p["ln1"], x), c, pos, cfg, cfg.attn_window)
        if "ck" in c:  # cross-attention against precomputed encoder memory
            o, _ = attention_decode(_cross_params(p), rms_norm(p["ln_cross"], x),
                                    {"k": c["ck"], "v": c["cv"]}, pos, cfg, cross=True)
            x = x + o
        return x + _ffn_apply(cfg, p, rms_norm(p["ln2"], x))
    if kind.startswith("rec"):
        o, st = recurrent_block_decode(p, rms_norm(p["ln1"], x), c, cfg)
    elif kind.startswith("rwkv"):
        o, st = rwkv_time_mix_decode(p, rms_norm(p["ln1"], x), c, cfg)
    else:
        raise ValueError(kind)
    _write(c, st)
    x = x + o
    return x + mlp(p, rms_norm(p["ln2"], x), cfg.mlp_kind)


def decode_step(cfg: ModelConfig, params, cache, token, pos):
    """One decode step. token: [B, 1] int tensor; pos: the position (int).
    Writes the step into ``cache`` in place. Returns (logits [B, 1, Vp]
    float32, cache)."""
    pos = int(pos)
    x = embed_tokens(cfg, params, token).to(params["embed"].dtype)
    for (pattern, n_rep), gp, gc in zip(layer_groups(cfg), params["groups"], cache):
        kinds = _block_kinds(pattern)
        for r in range(n_rep):
            pp, cc = _rep(gp, r), _rep(gc, r)
            for name, kind in zip(kinds, pattern):
                x = _block_decode(cfg, kind, pp[name], cc[name], x, pos)
    x = rms_norm(params["final_norm"], x)
    logits = torch.einsum("bsd,dv->bsv", x, lm_head_weight(cfg, params)).float()
    return logits, cache


def prefill(cfg: ModelConfig, params, batch):
    """Full-sequence forward that also returns the attention layers' KV
    caches (per group, {block: {'k', 'v'}} stacked over repetitions,
    [n_rep, B, S, KV, dh]) and the last-position logits [B, Vp]. As in the
    reference, recurrent / rwkv states are not returned: serving builds
    them by decode-mode prefill."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens).to(params["embed"].dtype)
    memory = encode(cfg, params, batch["src_embeds"]) if cfg.n_encoder_layers else None
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    caches = []
    for (pattern, n_rep), gp in zip(layer_groups(cfg), params["groups"]):
        kinds = _block_kinds(pattern)
        per_rep: List[Dict[str, Dict[str, torch.Tensor]]] = []
        for r in range(n_rep):
            pp = _rep(gp, r)
            cc = {}
            for name, kind in zip(kinds, pattern):
                if kind.startswith("attn"):
                    p = pp[name]
                    h = rms_norm(p["ln1"], x)
                    k = rope(torch.einsum("bsd,dgk->bsgk", h, p["wk"]), positions,
                             cfg.rope_frac, cfg.rope_theta)
                    v = torch.einsum("bsd,dgk->bsgk", h, p["wv"])
                    cc[name] = {"k": k, "v": v}
                x = _block_apply(cfg, kind, pp[name], x, causal=True, memory=memory)
            per_rep.append(cc)
        caches.append({
            name: {kk: torch.stack([c[name][kk] for c in per_rep]) for kk in ("k", "v")}
            for name in per_rep[0]
        })
    x = rms_norm(params["final_norm"], x)
    logits = torch.einsum("bd,dv->bv", x[:, -1], lm_head_weight(cfg, params)).float()
    return logits, caches


def input_specs(cfg: ModelConfig, shape: Dict, dtype=torch.bfloat16) -> Dict[str, Any]:
    """``meta`` tensors standing in for every model input of a given
    workload shape: no storage."""
    B, S = shape["global_batch"], shape["seq_len"]
    kind = shape["kind"]

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if kind in ("train", "prefill"):
        if kind == "train":
            n_text = S - cfg.n_prefix_embeds if cfg.frontend == "vision_stub" else S
            out = {"tokens": sds((B, n_text), torch.int32),
                   "targets": sds((B, n_text), torch.int32)}
        else:
            out = {"tokens": sds((B, S), torch.int32)}
        if cfg.frontend == "vision_stub":
            out["prefix_embeds"] = sds((B, cfg.n_prefix_embeds, cfg.d_model), dtype)
        if cfg.n_encoder_layers:
            out["src_embeds"] = sds((B, max(S // 4, 1), cfg.d_model), dtype)
        return out
    if kind == "decode":
        return {"token": sds((B, 1), torch.int32), "pos": sds((), torch.int32)}
    raise ValueError(kind)
