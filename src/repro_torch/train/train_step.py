"""Training step: loss -> grads -> AdamW, with optional microbatch
(gradient-accumulation) loop.

A port of the reference's ``train/train_step.py``. Gradients come from
``torch.autograd.grad`` of ``models.model.loss_fn`` (each period
rematerialized where ``cfg.remat`` is set); microbatch gradients
accumulate into float32 zeros in microbatch order and are scaled by
``1/n`` at the end, as the reference's ``lax.scan`` does. The update is
written into the parameters and the optimizer state in place
(``optim.adamw_update``).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from ..models.model import loss_fn, resolve_device, tree_leaves, tree_map
from .optim import adamw_update, global_norm


def value_and_grad(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """(loss, gradient tree of ``params``' nesting). The parameters
    themselves are not marked: autograd runs on detached aliases of them."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params, torch.is_tensor)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss = loss_fn(cfg, live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(t): torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)}
    return loss.detach(), tree_map(lambda t: by_leaf[id(t)], live, torch.is_tensor)


def make_train_step(
    cfg: ModelConfig,
    act_spec=None,
    n_microbatches: int = 1,
    lr: float = 3e-4,
    device="cuda",
):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), on ``device`` (the card unless the caller asks for the CPU;
    asking for the card where none is visible raises here). ``batch`` may
    hold numpy arrays or tensors; ``params`` and ``opt_state`` must lie on
    ``device`` and are updated in place. ``act_spec`` is accepted, as in
    the reference, and places nothing (``models.shardctx``)."""
    dev = resolve_device(device)

    def compute_grads(params, batch):
        if n_microbatches == 1:
            return value_and_grad(cfg, params, batch)
        mb = next(iter(batch.values())).shape[0] // n_microbatches
        tot_l = torch.zeros((), dtype=torch.float32, device=dev)
        tot_g = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params,
                         torch.is_tensor)
        acc = tree_leaves(tot_g)
        for i in range(n_microbatches):
            l, g = value_and_grad(cfg, params, {k: v[i * mb : (i + 1) * mb]
                                                for k, v in batch.items()})
            tot_l = tot_l + l
            for a, b in zip(acc, tree_leaves(g)):
                a.add_(b.float())
            del g
        inv = 1.0 / n_microbatches
        for a in acc:
            a.mul_(inv)
        return tot_l * inv, tot_g

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, grads = compute_grads(params, batch)
        params, opt_state = adamw_update(params, grads, opt_state, kind=cfg.optimizer, lr=lr)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        return params, opt_state, metrics

    return train_step
