"""Mixture-of-experts FFN: top-k routing with capacity-bounded
scatter/gather dispatch (no dense one-hot product: dispatch is pure data
movement, the expert products are the only FLOPs).

A port of the reference's ``models/moe.py``. Its ``.at[...].set`` and
``.at[...].max`` with ``mode="drop"`` become scatters into ``E*C + 1``
slots whose last slot, where dropped assignments land, is sliced off.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import mlp


def route(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router's top-k: (weights renormalised to sum 1, expert ids),
    each [B, S, K]."""
    logits = torch.einsum("bsd,de->bse", x, p["router"]).float()
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(gates, cfg.moe.top_k, dim=-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return topw, topi


def moe_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]."""
    mc = cfg.moe
    B, S, D = x.shape
    E, K = mc.n_experts, mc.top_k
    C = max(1, int(math.ceil(S * K / E * mc.capacity_factor)))

    topw, topi = route(p, x, cfg)

    # position-in-expert via cumulative count of earlier assignments. The
    # one-hot is a compare, not F.one_hot: that takes another path on each
    # device (a scatter on the card, a checked scatter on the CPU, a
    # compare on meta), so the op counter would count each differently
    experts = torch.arange(E, dtype=topi.dtype, device=x.device)
    onehot = (topi[..., None] == experts).to(torch.int32)  # [B,S,K,E]
    flat = onehot.reshape(B, S * K, E)
    pos_flat = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat  # count before slot
    pos = (pos_flat.reshape(B, S, K, E) * onehot).sum(-1)  # [B,S,K]
    keep = pos < C  # capacity drop

    s_idx = torch.arange(S, device=x.device)[None, :, None].expand(B, S, K)
    safe_pos = torch.where(keep, pos, 0)
    slot_flat = topi * C + safe_pos  # [B,S,K] flat slot index into [E*C]
    flat_src = torch.where(keep, s_idx, S)  # S = out of range -> dropped
    # kept assignments own distinct slots; dropped ones all land in slot E*C
    idx = torch.where(keep, slot_flat, E * C).reshape(B, S * K)
    slot_src = torch.zeros((B, E * C + 1), dtype=torch.int64, device=x.device).scatter_(
        1, idx, flat_src.reshape(B, S * K))[:, : E * C]
    slot_used = torch.zeros((B, E * C + 1), dtype=x.dtype, device=x.device).scatter_reduce_(
        1, idx, keep.to(x.dtype).reshape(B, S * K), reduce="amax")[:, : E * C]

    # dispatch: gather tokens into [B, E, C, D]; an unused slot's gather
    # (index 0) is zeroed by the used mask
    gidx = torch.clamp(slot_src, max=S - 1)[..., None].expand(B, E * C, D)
    xd = torch.gather(x, 1, gidx).reshape(B, E, C, D) * slot_used.reshape(B, E, C, 1)

    # expert FFN (swiglu)
    g = torch.einsum("becd,edf->becf", xd, p["w_gate"])
    u = torch.einsum("becd,edf->becf", xd, p["w_up"])
    yd = torch.einsum("becf,efd->becd", F.silu(g) * u, p["w_down"])

    # combine: each (token, k) gathers its slot output, weighted
    cidx = slot_flat.reshape(B, S * K, 1).expand(B, S * K, D)
    y = torch.gather(yd.reshape(B, E * C, D), 1, cidx).reshape(B, S, K, D)
    w = (topw.to(x.dtype) * keep.to(x.dtype))[..., None]
    out = (y * w).sum(dim=2)

    if mc.n_shared:
        out = out + mlp(
            {"w_gate": p["shared_gate"], "w_up": p["shared_up"], "w_down": p["shared_down"]},
            x,
            "swiglu",
        )
    return out
