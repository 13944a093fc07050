"""Gradient compression: int8 error-feedback quantized all-reduce.

Optional (off by default). Each leaf is quantized to int8 with a per-leaf
fp32 scale before the reduce; the quantization error is carried in a
residual buffer and added back next step (error feedback keeps convergence
unbiased to first order). Saves ~4x gradient collective bytes when the
interconnect term dominates.

A port of the reference's ``train/compress.py``: ``torch.round``, like
``jnp.round``, rounds half to even, so the same gradients and residuals
give the same bits.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..models.model import tree_map


def init_residuals(params) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params, torch.is_tensor)


def _one(g, r):
    g = g.float() + r
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale, g - q.float() * scale


def _zip_map(fn, a, b):
    """``fn`` over the leaves of two trees of the same nesting."""
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_zip_map(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def compress(grads, residuals) -> Tuple[Any, Any, Any]:
    """-> (int8 grads, fp32 scales, new residuals)."""
    out = _zip_map(_one, grads, residuals)
    return tuple(tree_map(lambda t: t[i], out, lambda x: isinstance(x, tuple)) for i in range(3))


def decompress(q, scales) -> Any:
    return _zip_map(lambda qq, ss: qq.float() * ss, q, scales)
