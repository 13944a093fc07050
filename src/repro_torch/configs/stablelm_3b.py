"""stablelm-3b [dense] — MHA (kv = heads), partial rotary (25%)
[hf:stabilityai/stablelm-2-1_6b; unverified]. Full attention ->
long_500k SKIPPED."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
    rope_frac=0.25,
    mlp_kind="swiglu",
)
