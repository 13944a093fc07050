"""Model zoo for the 10 assigned architectures, ported from the reference's
``models``: dense GQA/SWA transformers, MoE (top-k, shared experts),
RG-LRU hybrid, RWKV6, encoder-decoder, and VLM/audio backbones with stub
modality frontends. Plain torch functions over the reference's parameter
tree."""

from .model import (
    abstract_params,
    forward_train,
    init_params,
    input_specs,
    loss_fn,
)
