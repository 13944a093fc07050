"""pixtral-12b [vlm] — pixtral-ViT frontend (STUB: input_specs supplies
precomputed patch embeddings) + mistral-nemo-style decoder backbone
[hf:mistralai/Pixtral-12B-2409; unverified]. Full attention ->
long_500k SKIPPED."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    frontend="vision_stub",
    n_prefix_embeds=1024,  # image patch positions inside the train sequence
    mlp_kind="swiglu",
)
