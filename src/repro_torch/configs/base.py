"""Model configuration schema for the 10 assigned architectures.

Divisibility handling for the production mesh (model axis = 16):

* query heads are padded up to a multiple of 16 when needed (llama4 40->48,
  starcoder2 36->48); the MODEL_FLOPS / HLO_FLOPS ratio in §Roofline exposes
  the padding overhead,
* KV heads are never padded — when kv_heads % 16 != 0 the KV tensors are
  replicated across the model axis (GQA/MQA KV is small) and the decode KV
  cache is sharded on the *sequence* dim instead (split-KV decode),
* vocab is padded to a multiple of 16 (seamless 256206 -> 256208... next
  multiple handled in __post_init__).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # shared (always-on) experts
    capacity_factor: float = 1.25


@dataclass
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0

    # attention flavor
    attn_window: Optional[int] = None  # SWA / local-attention window
    rope_frac: float = 1.0  # fraction of head dims rotated (partial RoPE)
    rope_theta: float = 10_000.0

    # moe
    moe: Optional[MoECfg] = None
    moe_every: int = 1  # apply MoE FFN every k-th layer (1 = all layers)

    # hybrid (recurrentgemma): layer pattern, e.g. ("rec", "rec", "attn")
    block_pattern: Optional[Tuple[str, ...]] = None
    lru_dim: int = 0  # RG-LRU recurrence width (defaults to d_model)
    conv_width: int = 4

    # ssm (rwkv6)
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 64

    # enc-dec (audio)
    n_encoder_layers: int = 0  # >0 => encoder-decoder
    frontend: Optional[str] = None  # 'vision_stub' | 'audio_stub'
    n_prefix_embeds: int = 1024  # stub patch/frame positions in train shapes

    # activation / norm
    mlp_kind: str = "swiglu"  # swiglu | gelu
    tied_embeddings: bool = False

    # training
    optimizer: str = "adamw"  # adamw (fp32 master+moments) | adamw_bf16
    remat: bool = True
    seq_shard_activations: bool = True

    # long-context capability (sub-quadratic): run long_500k?
    subquadratic: bool = False

    # padded dims (filled in __post_init__)
    n_heads_padded: int = 0
    vocab_padded: int = 0

    def __post_init__(self):
        if self.d_head == 0:
            self.d_head = self.d_model // self.n_heads
        if self.lru_dim == 0:
            self.lru_dim = self.d_model
        self.n_heads_padded = _round_up(self.n_heads, 16)
        self.vocab_padded = _round_up(self.vocab, 16)

    # -- parameter counting (MODEL_FLOPS denominator) -----------------------
    def param_counts(self) -> Dict[str, float]:
        D, V = self.d_model, self.vocab_padded
        dh = self.d_head
        H, KV = self.n_heads_padded, self.n_kv_heads
        attn = D * H * dh + 2 * D * KV * dh + H * dh * D
        if self.mlp_kind == "swiglu":
            dense_ffn = 3 * D * self.d_ff
        else:
            dense_ffn = 2 * D * self.d_ff
        total = 0.0
        active = 0.0
        n_dec = self.n_layers
        pattern = self.block_pattern or ("attn",)
        for i in range(n_dec):
            kind = pattern[i % len(pattern)]
            if kind == "rec":
                R = self.lru_dim
                blk = 2 * D * R + R * D + self.conv_width * R + 2 * R * R + R
                blk += dense_ffn
                total += blk
                active += blk
            elif kind == "rwkv":
                tm = 4 * D * D + D * dh + 2 * (D * 64 + 64 * D)  # time-mix + decay lora
                cm = 2 * D * self.d_ff
                total += tm + cm
                active += tm + cm
            else:  # attn layer (kind 'attn' = MoE ffn when configured; 'attn_dense' = dense ffn)
                total += attn
                active += attn
                if self.moe is not None and not kind.startswith("attn_dense"):
                    e_ffn = 3 * D * self.moe.d_ff_expert
                    total += (self.moe.n_experts + self.moe.n_shared) * e_ffn
                    total += D * self.moe.n_experts  # router
                    active += (self.moe.top_k + self.moe.n_shared) * e_ffn
                else:
                    total += dense_ffn
                    active += dense_ffn
        if self.n_encoder_layers:
            enc = self.n_encoder_layers * (attn + dense_ffn)
            cross = n_dec * attn  # cross-attention in each decoder layer
            total += enc + cross
            active += enc + cross
        emb = V * D * (1 if self.tied_embeddings else 2)
        total += emb
        active += emb
        return {"total": total, "active": active}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
