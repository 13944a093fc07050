"""chatglm3-6b [dense] — 2d/partial RoPE (half dims), GQA kv=2
[arXiv:2406.12793; hf]. Full attention -> long_500k SKIPPED."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    rope_frac=0.5,  # ChatGLM rotary applies to half the head dims
    mlp_kind="swiglu",
)
