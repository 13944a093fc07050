"""starcoder2-7b [dense] — GQA kv=4, RoPE [arXiv:2402.19173; hf].
Full attention -> long_500k SKIPPED. 36 heads padded to 48 for TP=16."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    mlp_kind="gelu",
)
