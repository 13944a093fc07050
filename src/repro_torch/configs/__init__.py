"""Config registry: the 10 assigned architectures + reduced smoke variants."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from .base import ModelConfig, MoECfg

from . import (  # noqa: E402
    chatglm3_6b,
    dbrx_132b,
    h2o_danube_3_4b,
    llama4_maverick_400b_a17b,
    pixtral_12b,
    recurrentgemma_9b,
    rwkv6_7b,
    seamless_m4t_large_v2,
    stablelm_3b,
    starcoder2_7b,
)

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        recurrentgemma_9b,
        llama4_maverick_400b_a17b,
        dbrx_132b,
        h2o_danube_3_4b,
        stablelm_3b,
        starcoder2_7b,
        chatglm3_6b,
        rwkv6_7b,
        pixtral_12b,
        seamless_m4t_large_v2,
    )
}

ARCH_IDS: List[str] = list(ARCHS)


def get_config(name: str) -> ModelConfig:
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small layers/width, few experts, tiny
    embedding tables — runs a forward/train step on CPU."""
    cfg = ARCHS[name]
    pattern = cfg.block_pattern
    n_layers = max(2, len(pattern) if pattern else 2)
    updates = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_head=16,
        d_ff=128,
        vocab=512,
        lru_dim=64,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        n_prefix_embeds=8,
        n_heads_padded=0,
        vocab_padded=0,
    )
    if cfg.family == "ssm":
        updates.update(n_heads=4, n_kv_heads=4, rwkv_head_dim=16)
    if cfg.moe is not None:
        updates["moe"] = MoECfg(
            n_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=128,
            n_shared=cfg.moe.n_shared,
        )
    if cfg.attn_window is not None:
        updates["attn_window"] = 16
    new = dataclasses.replace(cfg, **updates)
    new.__post_init__()
    return new


# ---------------------------------------------------------------------------
# Assigned input shapes (seq_len x global_batch). decode_*/long_* lower
# serve_step (one new token against a seq_len KV cache), not train_step.
# ---------------------------------------------------------------------------

SHAPES: Dict[str, Dict] = {
    "train_4k": {"kind": "train", "seq_len": 4_096, "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32_768, "global_batch": 32},
    "decode_32k": {"kind": "decode", "seq_len": 32_768, "global_batch": 128},
    "long_500k": {"kind": "decode", "seq_len": 524_288, "global_batch": 1},
}


def cells() -> List[tuple]:
    """All (arch, shape) cells. long_500k only for sub-quadratic archs
    (pure full-attention archs skip it — DESIGN.md §Arch-applicability)."""
    out = []
    for a, cfg in ARCHS.items():
        for s in SHAPES:
            if s == "long_500k" and not cfg.subquadratic:
                continue
            out.append((a, s))
    return out
