"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; unverified]. SWA window bounds the KV cache ->
long_500k RUNS (sub-quadratic)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    attn_window=4096,  # mistral-lineage SWA
    mlp_kind="swiglu",
    subquadratic=True,
)
