"""Independent oracles of the port's kernels, in plain PyTorch: a copy of
the reference's ``src/repro/kernels/ref.py``.

Each computes its kernel's function by another algorithm than the kernel
and its plain version (a dense compare for the probe, a scatter-add for
the grouped sum, a full softmax for attention, a step-by-step loop for
the recurrence). The tests and ``chip_smoke.py`` hold the kernels against
them; nothing on a main path calls them.
"""

from __future__ import annotations

import math

import torch


def hash_probe_lens_ref(probe_keys, table_keys, table_vis, query_mask):
    """For each probe key the slot of the matching, query-visible entry in
    the open-addressing table, else -1 (unique keys). Vis words and mask
    are int32 tensors holding uint32 bits."""
    eq = probe_keys[:, None] == table_keys[None, :]  # [N, T]
    vis = (table_vis & query_mask[0]) != 0
    hit = eq & vis[None, :]
    idx = torch.argmax(hit.to(torch.uint8), dim=1).to(torch.int32)  # first hit
    return torch.where(hit.any(dim=1), idx, -1)


def seg_aggregate_ref(codes, values, n_groups):
    """Float32 group sums; codes outside ``[0, n_groups)`` are dropped."""
    codes = codes.to(torch.int64)
    values = values.to(torch.float32)
    keep = (codes >= 0) & (codes < n_groups)
    out = torch.zeros(n_groups, *values.shape[1:], dtype=torch.float32, device=values.device)
    return out.index_add_(0, codes[keep], values[keep])


def flash_attention_ref(q, k, v, *, window=None):
    """Causal (windowed) attention by a full softmax over ``[BH, S, S]``
    scores. As in the reference, the scores are formed in the input type
    and the probabilities rounded to ``v``'s type."""
    _, s, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bqd,bkd->bqk", q, k).to(torch.float32) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    ok = qpos >= kpos
    if window is not None:
        ok &= qpos - kpos < window
    scores = torch.where(ok, scores, -1e30)
    a = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", a.to(v.dtype), v).to(q.dtype)


def linrec_ref(a, b):
    """h_t = a_t h_{t-1} + b_t, h_0 = 0, one step at a time, in float32."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    h = torch.zeros(a.shape[0], a.shape[2], dtype=torch.float32, device=a.device)
    out = torch.empty_like(a32)
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out
