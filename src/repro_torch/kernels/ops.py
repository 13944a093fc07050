"""Public wrappers of the port's kernels, on an explicit device.

A port of the reference's ``src/repro/kernels/ops.py``: the hash-table
build (on the host, and by the batch-insert kernel), the fused-lens probe
and the segmented sum of the engine, and the kernel-ops entry points
``attention`` (flash attention) and ``linear_recurrence``. Each takes
array-likes, moves them to ``device`` (the CUDA card unless the caller
asks for the CPU, where the kernels' plain versions run) and returns
tensors there.
"""

from __future__ import annotations

import numpy as np
import torch

from .flash_attention import flash_attention
from .hash_probe import EMPTY, MULT, hash_build_insert, hash_probe_lens
from .linrec import linrec
from .seg_aggregate import seg_aggregate


def _i32(a, device) -> torch.Tensor:
    """An int32 tensor on ``device``; uint32 words keep their bits."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32).contiguous()
    a = np.ascontiguousarray(a)
    a = a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)
    return torch.from_numpy(a).to(device)


def _tensor(a, device) -> torch.Tensor:
    """A contiguous tensor on ``device`` that keeps ``a``'s type."""
    if not isinstance(a, torch.Tensor):
        # writable too: torch warns on a read-only array (such as a view of a JAX array)
        a = torch.from_numpy(np.require(a, requirements="CW"))
    return a.to(device).contiguous()


def build_hash_table(keys, vis, load: float = 0.5, device: str = "cuda"):
    """Host-side open-addressing build (unbounded linear probing in key
    order), in the SoA layout the probe kernels consume. Returns
    ``(table_keys, table_vis, table_entry_idx)``, int32 tensors on
    ``device`` (the vis words as uint32 bits)."""
    keys = np.asarray(keys)
    vis = np.asarray(vis, dtype=np.uint32)
    n = len(keys)
    cap = 1 << max(int(np.ceil(np.log2(max(n / load, 8)))), 3)
    mask = cap - 1
    tk = np.full(cap, EMPTY, np.int32)
    tv = np.zeros(cap, np.uint32)
    te = np.full(cap, -1, np.int32)
    pos = (keys.astype(np.uint64) * np.uint64(MULT)).astype(np.int64) & mask
    for i in range(n):
        p = int(pos[i])
        while tk[p] != EMPTY:
            p = (p + 1) & mask
        tk[p] = keys[i]
        tv[p] = vis[i]
        te[p] = i
    return _i32(tk, device), _i32(tv, device), _i32(te, device)


def build_insert(keys, capacity=None, device: str = "cuda"):
    """Batch build of the open-addressing table by the insert kernel (the
    device-side counterpart of ``build_hash_table``). Returns
    ``(table_keys, table_entry, ok)``; ``ok[0] == 0`` flags duplicate keys
    or over-long probe chains."""
    n = len(keys)
    if capacity is None:
        # default to <= 25% load: keeps clusters well inside the kernel's
        # bounded probe scan (callers managing their own tables pass cap)
        capacity = 8
        while capacity < 4 * n:
            capacity *= 2
    return hash_build_insert(_i32(keys, device), capacity)


def probe(probe_keys, table_keys, table_vis, query_mask, device: str = "cuda"):
    """Per probe key the matched slot if its vis word ANDs the 32-bit
    ``query_mask`` non-zero, else -1. The mask goes to the kernel by value,
    as a host integer."""
    if isinstance(query_mask, torch.Tensor):
        query_mask = query_mask.cpu().numpy()
    mask = int(np.asarray(query_mask).reshape(1)[0])
    return hash_probe_lens(
        _i32(probe_keys, device), _i32(table_keys, device), _i32(table_vis, device), mask,
    )


def segmented_sum(codes, values, n_groups, device: str = "cuda"):
    """``[n_groups, V]`` float32 group sums of ``values`` ``[N, V]``."""
    if isinstance(values, torch.Tensor):
        vals = values.to(device=device, dtype=torch.float32).contiguous()
    else:
        vals = torch.from_numpy(np.ascontiguousarray(values, dtype=np.float32)).to(device)
    return seg_aggregate(_i32(codes, device), vals, n_groups)


def attention(q, k, v, window=None, device: str = "cuda"):
    """Causal attention over ``[BH, S, dh]`` float32 or bfloat16 inputs,
    with ``window`` a sliding window; returns ``q``'s type."""
    return flash_attention(_tensor(q, device), _tensor(k, device), _tensor(v, device),
                           window=window)


def linear_recurrence(a, b, device: str = "cuda"):
    """``h_t = a_t h_{t-1} + b_t`` over ``[B, S, D]``, as float32."""
    return linrec(_tensor(a, device), _tensor(b, device))
