"""First-order linear recurrence: h_t = a_t * h_{t-1} + b_t, elementwise
over channels, with h_0 = 0 — the RG-LRU primitive of recurrentgemma.

``linrec`` ports the reference's Pallas kernel
(``src/repro/kernels/linrec.py`` ``_linrec_kernel``, a doubling scan of
256-step chunks with a carry across its sequential grid) to hand-written
CUDA (``csrc/linrec.cu``: one launch, a chained scan that reads ``a`` and
``b`` once; the note at its top says what bounds it and how it is built).

The kernel fixes the order of every operation: the sequence is cut into
chunks of ``CHUNK`` steps; each chunk's composition (the product of its
``a`` and its ``h`` started from 0) is built step by step, the carry into
each chunk is walked chunk by chunk over those compositions, and each chunk
is scanned again from its carry. Every step rounds its product and its sum
apart (no FMA). The plain version repeats that order exactly, so kernel and
plain version give the same bits. Against the reference's doubling scan,
results agree within float32 rounding (rtol/atol 1e-4 in the tests, the
reference's own).
"""

from __future__ import annotations

import functools

import torch

from . import _build

#: the reference's tile contract (``linrec.py`` BLOCK_S, BLOCK_D)
SEQ_MULTIPLE = 256
CHANNEL_MULTIPLE = 128
#: steps per chunk, one warp's in the kernel (divides SEQ_MULTIPLE)
CHUNK = 64


def _check(a, b):
    if a.shape != b.shape or a.dim() != 3:
        raise ValueError(f"linrec: a and b of one shape [B, S, D], got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"linrec: a on {a.device}, b on {b.device}")
    _, s, d = a.shape
    if s % SEQ_MULTIPLE or d % CHANNEL_MULTIPLE:
        raise ValueError(f"linrec: S ({s}) must be a multiple of {SEQ_MULTIPLE} and D ({d}) "
                         f"of {CHANNEL_MULTIPLE}")


def linrec_plain(a, b):
    """The kernel's function in PyTorch, in the kernel's order: the chunks'
    compositions, the carries walked over them, each chunk from its carry."""
    nb, s, d = a.shape
    nc = s // CHUNK
    a4, b4 = a.view(nb, nc, CHUNK, d), b.view(nb, nc, CHUNK, d)
    comp_a = torch.ones(nb, nc, d, dtype=torch.float32, device=a.device)
    comp_b = torch.zeros(nb, nc, d, dtype=torch.float32, device=a.device)
    for t in range(CHUNK):  # 1. each chunk's composition
        comp_b = a4[:, :, t] * comp_b + b4[:, :, t]
        comp_a = comp_a * a4[:, :, t]
    carry = torch.empty_like(comp_a)
    h = torch.zeros(nb, d, dtype=torch.float32, device=a.device)
    for c in range(nc):  # 2. the h entering each chunk
        carry[:, c] = h
        h = comp_a[:, c] * h + comp_b[:, c]
    out = torch.empty_like(a4)
    h = carry
    for t in range(CHUNK):  # 3. each chunk again from its carry
        h = a4[:, :, t] * h + b4[:, :, t]
        out[:, :, t] = h
    return out.view(nb, s, d)


@functools.cache
def _lr_linrec():
    return (_build.bind("linrec", "lr_scratch_words", 0, 3, restype="longlong"),
            _build.bind("linrec", "lr_linrec", 4, 3, 1))


def linrec(a, b):
    """``a``, ``b`` ``[B, S, D]`` -> float32 ``h`` ``[B, S, D]`` with
    h_t = a_t h_{t-1} + b_t and h_0 = 0. Inputs are cast to float32 first;
    S must be a multiple of 256 and D of 128."""
    _check(a, b)
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    if a.device.type == "cpu":
        return linrec_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"linrec: tensors on {a.device}; the kernel runs on a CUDA card")
    nb, s, d = a.shape
    words, run = _lr_linrec()
    h = torch.empty_like(a)
    scratch = torch.empty(words(nb, s, d), dtype=torch.int32, device=a.device)
    err = run(a.data_ptr(), b.data_ptr(), h.data_ptr(), scratch.data_ptr(), nb, s, d,
              _build.stream_ptr(a.device))
    _build.check(err, "linrec")
    _build.count_launch("linrec")
    return h


def launch_info(shape):
    """The launch the kernel makes for ``a`` of ``shape`` ``[B, S, D]``:
    ``blocks`` (of the grid), ``threads`` (of a block) and
    ``blocks_per_sm`` (how many blocks an SM holds at once). Reads the
    card; launches nothing."""
    nb, s, d = shape
    out = torch.zeros(3, dtype=torch.int64)
    err = _build.bind("linrec", "lr_launch_info", 1, 3)(out.data_ptr(), nb, s, d)
    _build.check(err, "linrec launch_info")
    return dict(zip(("blocks", "threads", "blocks_per_sm"), out.tolist()))
