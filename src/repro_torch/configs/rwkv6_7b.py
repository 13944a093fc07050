"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay linear
recurrence [arXiv:2404.05892; hf]. O(1) state -> long_500k RUNS."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # rwkv head_dim 64 -> 4096/64 heads
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    block_pattern=("rwkv",),
    rwkv_head_dim=64,
    rwkv_chunk=16,
    mlp_kind="rwkv_cm",  # rwkv channel-mix (relu^2 gated)
    subquadratic=True,
)
