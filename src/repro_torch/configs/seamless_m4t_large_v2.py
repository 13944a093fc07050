"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal
[arXiv:2308.11596; hf]. Speech frontend is a STUB (input_specs supplies
precomputed frame embeddings). Decode shapes lower the DECODER step with
stub encoder memory. Full attention both stacks -> long_500k SKIPPED."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,  # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,  # padded to 256208 for TP=16
    frontend="audio_stub",
    mlp_kind="gelu",
)
