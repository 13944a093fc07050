"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427; unverified]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    attn_window=2048,  # local attention
    block_pattern=("rec", "rec", "attn"),
    lru_dim=4096,
    mlp_kind="swiglu",
    tied_embeddings=True,
    subquadratic=True,  # bounded window + O(1) recurrent state -> long_500k runs
)
