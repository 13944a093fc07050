"""Optimizers, in plain torch over the reference's parameter trees.

* ``adamw``      — fp32 master weights + fp32 moments (default).
* ``adamw_bf16`` — bf16 moments, no separate master (params updated in
  their own dtype). Used by the 100B+ configs (dbrx-132b,
  llama4-maverick-400b-a17b).

A port of the reference's ``train/optim.py``. The state has the
reference's nesting (``step``, ``master``, ``m``, ``v``), so
``models.model.params_from_numpy`` / ``params_to_numpy`` carry it across.
``adamw_update`` updates the parameters and the state in place, leaf by
leaf, in the reference's order of operations (clip scale, bias
corrections, ``u``, decoupled weight decay): at a full model's width the
reference's out-of-place tree of new leaves would not fit on one card
beside the parameters, master, moments and gradients.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models.model import tree_leaves, tree_map

KINDS = ("adamw", "adamw_bf16")


def init_opt_state(params, kind: str = "adamw"):
    """The optimizer state of ``params``, on their device. ``master`` is a
    float32 copy that never aliases the parameters."""
    if kind not in KINDS:
        raise ValueError(kind)
    device = tree_leaves(params)[0].device
    moment = torch.float32 if kind == "adamw" else torch.bfloat16
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=moment), params, torch.is_tensor),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=moment), params, torch.is_tensor),
    }
    if kind == "adamw":
        state["master"] = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params,
                                   torch.is_tensor)
    return state


def abstract_opt_state(abstract_p, kind: str = "adamw"):
    """The state of ``meta`` parameters (``models.model.abstract_params``):
    shapes and dtypes, no storage."""
    return init_opt_state(abstract_p, kind)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32, the
    leaves summed in the reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree)))


def adamw_update(
    params,
    grads,
    opt_state,
    *,
    kind: str = "adamw",
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
) -> Tuple[Any, Dict]:
    """One AdamW step, written into ``params`` and ``opt_state`` in place;
    returns them. ``grads`` is read only."""
    if kind not in KINDS:
        raise ValueError(kind)
    with torch.no_grad():
        step = opt_state["step"] + 1
        gnorm = global_norm(grads)
        clip = torch.tensor(clip_norm, dtype=torch.float32, device=gnorm.device)
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        stepf = step.float()
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
        masters = tree_leaves(opt_state["master"]) if kind == "adamw" else None
        for i, (p, g, m, v) in enumerate(zip(tree_leaves(params), tree_leaves(grads),
                                             tree_leaves(opt_state["m"]),
                                             tree_leaves(opt_state["v"]))):
            g = g.float() * scale
            m32, v32 = m.float(), v.float()  # the moments themselves where float32
            m32.mul_(b1).add_(g * (1 - b1))
            t = g * (1 - b2)
            v32.mul_(b2).add_(t.mul_(g))
            del g, t
            den = v32 / bc2
            u = (m32 / bc1).div_(den.sqrt_().add_(eps))
            del den
            base = masters[i] if masters is not None else p.float()
            u.add_(base * weight_decay).mul_(lr)
            base.sub_(u)
            del u
            for dst, src in ((m, m32), (v, v32), (p, base)):
                if dst is not src:
                    dst.copy_(src)
        opt_state["step"].copy_(step)
    return params, opt_state
