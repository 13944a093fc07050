"""Segmented aggregation: the grouped sum behind a shared aggregate state
(paper §4.5).

``seg_aggregate`` ports the reference's Pallas kernel
(``src/repro/kernels/seg_aggregate.py`` ``_seg_kernel``, a one-hot matrix
product on the TPU's MXU) to hand-written CUDA (``csrc/seg_aggregate.cu``;
the note at its top says what bounds it and how it is built). The result
is float32, as in the reference, so the engine takes it only when asked
(``TorchBackend(use_agg_kernel=True)``).

The kernel fixes the order of every addition: rows are cut into chunks of
``seg_chunk(V)`` rows; within a chunk each group's values are added in
ascending row order into a float64, and the chunk partials are added in
chunk order before one rounding to float32. Its first pass sorts each
chunk's (code, row) pairs and sums each group's run, which holds the
group's rows in that same order; its second pass loads all chunk
partials of an output at once and then adds them in chunk order. The
plain version repeats that order exactly, so kernel and plain version
give the same bits, and the same inputs give the same bits on every run.
Against the reference, which adds in float32 in the MXU's order, results
agree within float32 rounding (rtol/atol 1e-4 in the tests, as the
reference's own tests use).
"""

from __future__ import annotations

import torch

from . import _build

#: rows per chunk at most, and the floats of one chunk's values that one
#: block stages in shared memory
MAX_CHUNK = 512
_CHUNK_FLOATS = 8192


def seg_chunk(v: int) -> int:
    """Rows per chunk for ``v`` value columns."""
    return max(1, min(MAX_CHUNK, _CHUNK_FLOATS // max(v, 1)))


def _check(codes, values, n_groups):
    if codes.dtype != torch.int32 or values.dtype != torch.float32:
        raise TypeError("seg_aggregate: codes are int32 and values float32 tensors")
    if codes.device != values.device:
        raise ValueError(f"seg_aggregate: codes on {codes.device}, values on {values.device}")
    if values.dim() != 2 or codes.shape != values.shape[:1]:
        raise ValueError("seg_aggregate: codes [N] and values [N, V] expected")
    if not (codes.is_contiguous() and values.is_contiguous()):
        raise ValueError("seg_aggregate: operands must be contiguous")
    if n_groups < 0 or values.shape[1] > _CHUNK_FLOATS:
        raise ValueError(f"seg_aggregate: n_groups {n_groups} or V {values.shape[1]} out of range")


def seg_aggregate_plain(codes, values, n_groups):
    n, v = values.shape
    dev = values.device
    chunk = seg_chunk(v)
    blocks = (n + chunk - 1) // chunk
    part = torch.zeros(blocks * n_groups, v, dtype=torch.float64, device=dev)
    c = codes.to(torch.int64)
    rows = torch.nonzero((c >= 0) & (c < n_groups)).squeeze(1)  # ascending
    if rows.numel():
        bucket = (rows // chunk) * n_groups + c[rows]
        order = torch.argsort(bucket, stable=True)  # rows ascend within a bucket
        sb, rows = bucket[order], rows[order]
        idx = torch.arange(sb.numel(), device=dev)
        first = torch.ones_like(sb, dtype=torch.bool)
        first[1:] = sb[1:] != sb[:-1]
        rank = idx - torch.cummax(torch.where(first, idx, 0), 0).values
        # step k adds every bucket's k-th row: one add per bucket per step,
        # so each bucket sums its rows in ascending order
        by_rank = torch.argsort(rank, stable=True)
        dst, src = sb[by_rank], values[rows[by_rank]].to(torch.float64)
        off = 0
        for cnt in torch.bincount(rank).tolist():
            d = dst[off : off + cnt]
            part[d] = part[d] + src[off : off + cnt]
            off += cnt
    part = part.view(blocks, n_groups, v)
    out = torch.zeros(n_groups, v, dtype=torch.float64, device=dev)
    for b in range(blocks):
        out += part[b]
    return out.to(torch.float32)


def seg_aggregate(codes, values, n_groups):
    """Per-group sums: ``out[g, v]`` adds ``values[r, v]`` over the rows
    with ``codes[r] == g``; codes outside ``[0, n_groups)`` match nothing.
    ``codes`` int32 ``[N]``, ``values`` float32 ``[N, V]``; returns float32
    ``[n_groups, V]``."""
    _check(codes, values, n_groups)
    if codes.device.type == "cpu":
        return seg_aggregate_plain(codes, values, n_groups)
    partial, out = seg_buffers(n_groups, values)
    seg_launch(codes, values, partial, out)
    return out


def seg_buffers(n_groups, values):
    """The float64 chunk partials and the float32 ``[n_groups, V]`` output
    that one kernel call on ``values`` writes."""
    n, v = values.shape
    blocks = -(-n // seg_chunk(v))
    return (torch.empty(blocks * n_groups * v, dtype=torch.float64, device=values.device),
            torch.empty(n_groups, v, dtype=torch.float32, device=values.device))


def seg_launch(codes, values, partial, out):
    """Launch the kernel's two passes on checked CUDA operands into
    ``seg_buffers``' ``partial`` and ``out``; raises when the C entry point
    refuses the call or it fails to launch."""
    n, v = values.shape
    fn = _build.bind("seg_aggregate", "sa_seg_aggregate", 4, 4, 1)
    err = fn(
        codes.data_ptr(), values.data_ptr(), partial.data_ptr(), out.data_ptr(),
        n, v, out.shape[0], seg_chunk(v), _build.stream_ptr(codes.device),
    )
    _build.check(err, "seg_aggregate")
    _build.count_launch("seg_aggregate")
