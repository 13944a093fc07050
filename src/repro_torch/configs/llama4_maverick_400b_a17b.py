"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, shared expert, early
fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Full attention -> long_500k is SKIPPED (DESIGN.md §Arch-applicability).
adamw_bf16 optimizer: 400B params with fp32 master+moments exceed v5e HBM on
a single pod; bf16 moments fit (§Dry-run memory analysis).
"""

from .base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,  # padded to 48 for the 16-way model axis
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    moe=MoECfg(n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1),
    # Maverick interleaves dense and MoE FFN layers 1:1 -> ~400B total / ~17B active
    block_pattern=("attn", "attn_dense"),
    mlp_kind="swiglu",
    optimizer="adamw_bf16",
)
