"""Fused morsel stage chain (DESIGN.md §13): one launch per morsel chain.

One launch runs a morsel's entire packed stage chain — hash probe →
lens-word translation → grant-predicate visibility → interval-matrix stage
filter, for every stage in sequence — plus the build-sink word
translation, over device-resident state mirrors. The host hands over the
morsel's packed ownership words and per-row probe keys once and gets back
the final words, per-stage matched entry indices, per-stage
alive/matched counts, per-slot survivor counts, and the sink's
visibility/extent words. Everything that must stay bit-exact in float64 is
reconstructed host-side from the entry indices; the launch only computes
set membership, so results are bit-identical to the NumPy member-major
path.

This ports the reference's Pallas kernel (``src/repro/kernels/
fused_chain.py`` ``_build_kernel``) to one hand-written CUDA kernel
(``csrc/fused_chain.cu``; its opening note says what bounds it on the H100
and what the design does about it). The Pallas version is specialised per
chain spec; the CUDA kernel is generic and reads the spec from an int64
descriptor (``chain_descriptor``), so a new wave shape never needs a
compile. The reference's representation is kept unchanged, so the kernel
takes the exact arrays the Pallas launch takes:

* every packed uint64 word — ownership bits, lens words, translation
  tables, sink masks — travels as a (lo, hi) uint32 pair, held here in
  int32 tensors with the same bits;
* float64 predicate operands are encoded host-side through the monotone
  total-order map ``total_order_u32`` onto (hi, lo) uint32 pairs, so
  unsigned lexicographic compares reproduce IEEE ``>=``/``<=`` exactly,
  including -0.0 == 0.0 and NaN failing every constrained interval.

``chain_launch`` runs the CUDA kernel for CUDA tensors and ``chain_plain``
— the same function in plain PyTorch — for CPU tensors. Both return one
flat int32 buffer; ``split_outputs`` cuts it into the reference's output
tuple. The kernel takes its arguments by value: ``chain_args`` lays out
the int64 block (descriptor, input and output pointers) in host memory,
and the C entry launches with it as a kernel parameter, so a launch
copies nothing to the device and waits for nothing.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .hash_probe import EMPTY, MAX_PROBE, MULT

__all__ = [
    "total_order_u32",
    "total_order_bound",
    "input_kinds",
    "chain_descriptor",
    "output_sizes",
    "split_outputs",
    "chain_args",
    "chain_plain",
    "chain_launch",
]

_SIGN = np.uint64(0x8000000000000000)
_LO32 = 0xFFFFFFFF
#: the most int64 words and stages an argument block may hold: the kernel
#: parameter struct's size (``FC_MAX_WORDS``, ``FC_MAX_STAGES`` in
#: ``csrc/fused_chain.cu``, which says how they were bounded)
MAX_ARG_WORDS = 4032
MAX_STAGES = 32
#: words of one [8, 256] byte-lane translation half-table
TABLE_WORDS = 2048


def total_order_u32(vals: np.ndarray):
    """Monotone total-order encoding of float64 onto (hi, lo) uint32 pairs.

    ``a <= b`` (IEEE, finite or infinite) iff ``enc(a) <= enc(b)`` as
    unsigned 64-bit lexicographic pairs. ``-0.0`` is canonicalized to
    ``+0.0`` first so the two zeros encode equal; NaNs land strictly
    outside the [-inf, +inf] band on their sign's side, so every
    constrained interval compare rejects them — exactly IEEE semantics
    for ``(x >= lo) & (x <= hi)``."""
    v = np.ascontiguousarray(np.asarray(vals, dtype=np.float64) + 0.0)
    b = v.view(np.uint64)
    m = np.where((b & _SIGN) != 0, ~b, b | _SIGN)
    hi = (m >> np.uint64(32)).astype(np.uint32)
    lo = (m & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def total_order_bound(x: float):
    """Scalar :func:`total_order_u32` for predicate bounds."""
    hi, lo = total_order_u32(np.array([x], dtype=np.float64))
    return int(hi[0]), int(lo[0])


# -- chain spec ---------------------------------------------------------------
#
# spec = (stages, sink)
#   stages: tuple of (key_mode, n_grants, grant_attrs, filt)
#     key_mode    -1  => per-row host-encoded int32 keys
#                 s>=0 => keys gathered from an entry-indexed int32 column
#                         mirror through stage s's matched entry index
#     n_grants    number of compiled grant predicates ORed into this
#                 stage's lens resolution (0 = grant-free)
#     grant_attrs union count of bound attrs across this stage's grants
#     filt        None, or (n_members, attr_srcs): an interval stage-filter
#                 matrix over attr_srcs, each -1 (per-row host pair) or an
#                 origin stage index (entry-indexed mirror pair)
#   sink: True when the chain ends in a build sink (emit per-row
#         beneficiary-visibility and extent words from the final bits)


def input_kinds(spec):
    """Canonical flat input traversal for a chain spec.

    Returns a list of ``"row"`` (morsel-length, block-tiled) /
    ``"full"`` (whole-array-per-block: tables, mirrors, parameter
    matrices) markers, in the exact order the host must assemble inputs
    and the kernel consumes them:

    ``bits_lo, bits_hi``, then per stage: key array; ``tkeys, tentry``;
    ``evis_lo, evis_hi``; ``ttab_lo, ttab_hi``; grants block
    (``eem_lo, eem_hi, gbit[G,2], gallow[G,2], gcon[G,A], glo[G,A,2],
    ghi[G,A,2]``, then per grant attr its mirror pair); filter block
    (per attr its value pair, then ``flo[M,A,2], fhi[M,A,2], fcon[M,A],
    fbit[M,2]``); finally the sink's two table pairs."""
    stages, sink = spec
    kinds = ["row", "row"]
    for key_mode, n_grants, grant_attrs, filt in stages:
        kinds.append("row" if key_mode == -1 else "full")
        kinds += ["full"] * 6
        if n_grants:
            kinds += ["full"] * 7
            kinds += ["full"] * (2 * grant_attrs)
        if filt is not None:
            _, srcs = filt
            for src in srcs:
                kinds += ["row", "row"] if src == -1 else ["full", "full"]
            kinds += ["full"] * 4
    if sink:
        kinds += ["full"] * 4
    return kinds


def _unpack(spec, arrays):
    """Group the flat input list by stage, in ``input_kinds`` order."""
    stages, sink = spec
    it = iter(arrays)
    bl, bh = next(it), next(it)
    per_stage = []
    for key_mode, n_grants, grant_attrs, filt in stages:
        d = {k: next(it) for k in ("key", "tkeys", "tentry", "evlo", "evhi", "ttlo", "tthi")}
        if n_grants:
            for k in ("eemlo", "eemhi", "gbit", "gallow", "gcon", "glo", "ghi"):
                d[k] = next(it)
            d["gattrs"] = [(next(it), next(it)) for _ in range(grant_attrs)]
        if filt is not None:
            d["fvals"] = [(next(it), next(it)) for _ in filt[1]]
            for k in ("flo", "fhi", "fcon", "fbit"):
                d[k] = next(it)
        per_stage.append(d)
    sink_tabs = [next(it) for _ in range(4)] if sink else None
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} inputs beyond the chain spec's traversal")
    return bl, bh, per_stage, sink_tabs


def chain_descriptor(spec, arrays):
    """The kernel's int64 spec descriptor: ``[n_stages, sink]`` then per
    stage ``key_mode, n_grants, grant_attrs, table_capacity, n_members
    (-1 = no filter), n_fattrs, fattr_src...``."""
    stages, sink = spec
    _, _, per_stage, _ = _unpack(spec, arrays)
    desc = [len(stages), int(bool(sink))]
    for (key_mode, n_grants, grant_attrs, filt), d in zip(stages, per_stage):
        srcs = list(filt[1]) if filt is not None else []
        desc += [
            key_mode,
            n_grants,
            grant_attrs,
            d["tkeys"].shape[0],
            filt[0] if filt is not None else -1,
            len(srcs),
        ] + srcs
    return desc


def output_sizes(spec, n):
    """Element counts of the outputs, in order: bits lo/hi, one entry
    array per stage, ``stats[S,3]``, ``slots[64]``, then the sink's four
    word arrays."""
    stages, sink = spec
    s = len(stages)
    return [n, n] + [n] * s + [3 * s, 64] + ([n] * 4 if sink else [])


def split_outputs(spec, n, flat):
    """Cut the flat output buffer into the reference's output tuple
    ``(bits_lo, bits_hi, entry_0..entry_{S-1}, stats[S,3], slots[64]
    [, sink_vis_lo, sink_vis_hi, sink_em_lo, sink_em_hi])``. Works on a
    tensor or a numpy array; returns views."""
    n_stages = len(spec[0])
    out, off = [], 0
    for size in output_sizes(spec, n):
        out.append(flat[off : off + size])
        off += size
    out[2 + n_stages] = out[2 + n_stages].reshape(n_stages, 3)
    return tuple(out)


class _Layout:
    """What a launch needs of a spec, worked out once per spec: the input
    count, the indices of the row inputs and of the translation tables,
    the block's static head (``[D, n_in] + descriptor``, table capacities
    0) with the positions the capacities go to and the inputs they come
    from, and each output's offset in the flat buffer as ``a n + b``."""

    __slots__ = ("n_in", "rows", "tables", "head", "caps", "outs", "out_words")

    def __init__(self, spec):
        stages, sink = spec
        if len(stages) > MAX_STAGES:
            raise ValueError(f"a chain takes at most {MAX_STAGES} stages, got {len(stages)}")
        kinds = input_kinds(spec)
        self.n_in = len(kinds)
        self.rows = tuple(i for i, k in enumerate(kinds) if k == "row")
        desc = [len(stages), int(bool(sink))]
        caps, tables, pi = [], [], 2
        for key_mode, n_grants, grant_attrs, filt in stages:
            srcs = list(filt[1]) if filt is not None else []
            caps.append((2 + len(desc) + 3, pi + 1))  # table_capacity <- tkeys
            desc += [key_mode, n_grants, grant_attrs, 0,
                     filt[0] if filt is not None else -1, len(srcs)] + srcs
            tables += [pi + 5, pi + 6]
            pi += 7 + (7 + 2 * grant_attrs if n_grants else 0)
            pi += 2 * len(srcs) + 4 if filt is not None else 0
        if sink:
            tables += [pi, pi + 1, pi + 2, pi + 3]
        self.head = [len(desc), self.n_in] + desc
        self.caps = tuple(caps)
        self.tables = tuple(tables)
        outs, a, b = [], 0, 0
        for s1, s2 in zip(output_sizes(spec, 1), output_sizes(spec, 2)):
            outs.append((a, b))  # each size is (s2 - s1) n + (2 s1 - s2)
            a, b = a + s2 - s1, b + 2 * s1 - s2
        self.outs = tuple(outs)
        self.out_words = (a, b)
        words = len(self.head) + self.n_in + len(outs)
        if words > MAX_ARG_WORDS:
            raise ValueError(
                f"the chain's argument block takes {words} words, more than the "
                f"kernel's {MAX_ARG_WORDS}"
            )


@functools.lru_cache(maxsize=512)
def _layout(spec) -> _Layout:
    return _Layout(spec)


def chain_args(spec, arrays, flat):
    """The kernel's by-value argument block, int64 in host memory:
    ``[D, n_in] + chain_descriptor(spec, arrays)``, then the data pointers
    of ``arrays`` (in :func:`input_kinds` order) and of each output's
    place in ``flat`` (in :func:`output_sizes` order). Raises when the
    spec does not fit the kernel's parameter struct."""
    lay = _layout(spec)
    n = arrays[0].shape[0]
    block = list(lay.head)
    for pos, src in lay.caps:
        block[pos] = arrays[src].shape[0]
    base = flat.data_ptr()
    block += [a.data_ptr() for a in arrays]
    block += [base + 4 * (a * n + b) for a, b in lay.outs]
    return np.array(block, dtype=np.int64)


def _u(x):
    """uint32 bits held in int32 -> the unsigned value in int64."""
    return x.to(torch.int64) & _LO32


def _ge(xh, xl, bh, bl):
    """(xh, xl) >= (bh, bl), unsigned lexicographic — IEEE >= on
    total-order-encoded float64. Operands are int64 unsigned values."""
    return (xh > bh) | ((xh == bh) & (xl >= bl))


def _le(xh, xl, bh, bl):
    return (xh < bh) | ((xh == bh) & (xl <= bl))


def _translate(bl, bh, tlo, thi):
    """8 byte-lane gathers: OR the split translation tables over every
    byte of the (lo, hi) word pair — ``core.visibility.translate_bits``.
    The arithmetic ``>>`` of int32 is masked to the byte."""
    olo = torch.zeros_like(bl)
    ohi = torch.zeros_like(bh)
    for b in range(4):
        idx = ((bl >> (8 * b)) & 0xFF).to(torch.int64)
        olo = olo | tlo[b][idx]
        ohi = ohi | thi[b][idx]
    for b in range(4):
        idx = ((bh >> (8 * b)) & 0xFF).to(torch.int64)
        olo = olo | tlo[4 + b][idx]
        ohi = ohi | thi[4 + b][idx]
    return olo, ohi


def chain_plain(spec, arrays):
    """The chain in plain PyTorch: the reference kernel's arithmetic, step
    for step, on int32 tensors. Returns the flat int32 output buffer."""
    stages, sink = spec
    bl, bh, per_stage, sink_tabs = _unpack(spec, arrays)
    dev = bl.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    entries, stats = [], []
    for (key_mode, n_grants, grant_attrs, filt), d in zip(stages, per_stage):
        alive = (bl | bh) != 0
        if key_mode == -1:
            keys = d["key"]
        else:
            e = entries[key_mode]
            ok = e >= 0
            keys = torch.where(ok, d["key"][torch.where(ok, e, 0).to(torch.int64)], EMPTY)
        keys = torch.where(alive, keys, EMPTY).to(torch.int64)
        tkeys = d["tkeys"]
        cap_mask = tkeys.shape[0] - 1
        pos = ((keys & _LO32) * MULT) & cap_mask
        found = torch.full(keys.shape, -1, dtype=torch.int64, device=dev)
        done = keys == EMPTY
        for _ in range(MAX_PROBE):
            if bool(done.all()):
                break
            slot_keys = tkeys[pos]
            hit = (slot_keys == keys) & ~done
            empty = (slot_keys == EMPTY) & ~done
            found = torch.where(hit, pos, found)
            done = done | hit | empty
            pos = (pos + 1) & cap_mask
        matched = found >= 0
        entry = torch.where(matched, d["tentry"][torch.where(matched, found, 0)], -1)
        entries.append(entry)
        safe_e = torch.where(matched, entry, 0).to(torch.int64)
        vlo = torch.where(matched, d["evlo"][safe_e], zero)
        vhi = torch.where(matched, d["evhi"][safe_e], zero)
        plo, phi = _translate(vlo, vhi, d["ttlo"], d["tthi"])
        if n_grants:
            elo = torch.where(matched, d["eemlo"][safe_e], zero)
            ehi = torch.where(matched, d["eemhi"][safe_e], zero)
            gvals = [(_u(gh[safe_e]), _u(gl[safe_e])) for gh, gl in d["gattrs"]]
            gallow, gbit, gcon = d["gallow"], d["gbit"], d["gcon"]
            glo, ghi = _u(d["glo"]), _u(d["ghi"])
            for g in range(n_grants):
                gok = ((elo & gallow[g, 0]) | (ehi & gallow[g, 1])) != 0
                for a in range(grant_attrs):
                    xh, xl = gvals[a]
                    inb = _ge(xh, xl, glo[g, a, 0], glo[g, a, 1]) & _le(
                        xh, xl, ghi[g, a, 0], ghi[g, a, 1]
                    )
                    gok = gok & (inb | (gcon[g, a] == 0))
                plo = plo | torch.where(gok, gbit[g, 0], zero)
                phi = phi | torch.where(gok, gbit[g, 1], zero)
        nbl = bl & torch.where(matched, plo, zero)
        nbh = bh & torch.where(matched, phi, zero)
        m_post = matched & ((nbl | nbh) != 0)
        bl, bh = nbl, nbh
        if filt is not None:
            n_members, srcs = filt
            vals = []
            for a, src in enumerate(srcs):
                vh, vl = d["fvals"][a]
                if src == -1:
                    vals.append((_u(vh), _u(vl)))
                else:
                    e2 = entries[src]
                    s2 = torch.where(e2 >= 0, e2, 0).to(torch.int64)
                    vals.append((_u(vh[s2]), _u(vl[s2])))
            flo, fhi, fcon, fbit = _u(d["flo"]), _u(d["fhi"]), d["fcon"], d["fbit"]
            fblo = torch.zeros_like(bl)
            fbhi = torch.zeros_like(bh)
            fmlo = torch.zeros_like(bl)
            fmhi = torch.zeros_like(bh)
            for m in range(n_members):
                okm = None
                for a in range(len(srcs)):
                    xh, xl = vals[a]
                    inb = _ge(xh, xl, flo[m, a, 0], flo[m, a, 1]) & _le(
                        xh, xl, fhi[m, a, 0], fhi[m, a, 1]
                    )
                    oka = inb | (fcon[m, a] == 0)
                    okm = oka if okm is None else okm & oka
                fblo = fblo | torch.where(okm, fbit[m, 0], zero)
                fbhi = fbhi | torch.where(okm, fbit[m, 1], zero)
                fmlo = fmlo | fbit[m, 0]
                fmhi = fmhi | fbit[m, 1]
            bl = bl & (~fmlo | fblo)
            bh = bh & (~fmhi | fbhi)
        stats.append(torch.stack([alive.sum(), matched.sum(), m_post.sum()]))
    slot_counts = torch.stack(
        [((bl >> j) & 1).sum() for j in range(32)]
        + [((bh >> j) & 1).sum() for j in range(32)]
    )
    out = [bl, bh] + [e.to(torch.int32) for e in entries]
    out += [torch.stack(stats).reshape(-1), slot_counts]
    if sink:
        stlo, sthi, selo, sehi = sink_tabs
        out += list(_translate(bl, bh, stlo, sthi))
        out += list(_translate(bl, bh, selo, sehi))
    return torch.cat([o.to(torch.int32) for o in out])


def _check_inputs(lay, arrays):
    """The contract's guard, in one pass: every input a contiguous int32
    tensor on the first one's device, the rows of one power-of-two length
    >= 8, each translation table [8, 256]."""
    if len(arrays) != lay.n_in:
        raise ValueError(f"chain spec takes {lay.n_in} inputs, got {len(arrays)}")
    first = arrays[0]
    n = first.shape[0]
    if n < 8 or n & (n - 1):
        raise ValueError(f"row arrays must have a power-of-two length >= 8, got {n}")
    where = first.get_device()
    for a in arrays:
        if a.dtype is not torch.int32 or not a.is_contiguous():
            raise TypeError("chain inputs are contiguous int32 tensors")
        if a.get_device() != where:
            raise ValueError(f"chain inputs must all be on {first.device}, got {a.device}")
    for i in lay.rows:
        if arrays[i].shape[0] != n:
            raise ValueError(f"row inputs must all have length {n}, got {arrays[i].shape[0]}")
    for i in lay.tables:
        if arrays[i].numel() != TABLE_WORDS:
            raise ValueError(f"translation tables are [8, 256], got {tuple(arrays[i].shape)}")
    return first.device, n


@functools.cache
def _fc_chain():
    return _build.bind("fused_chain", "fc_chain", 1, 2, 1)


def chain_launch(spec, arrays):
    """Run one fused stage-chain launch.

    ``arrays`` follow :func:`input_kinds`'s traversal as contiguous int32
    tensors on one device, every "row" array padded to a common
    power-of-two length >= 8 (dead padding rows carry zero ownership words
    and EMPTY keys, so they contribute to no output). Returns the flat
    int32 output buffer (:func:`split_outputs`). ``stats[s]`` is
    ``(alive_in, matched, matched_visible)`` for stage s. A spec whose
    argument block does not fit the kernel's parameter struct raises, on
    either device. On the card the call neither copies nor waits: the C
    entry zeroes the counters and launches on the current stream."""
    lay = _layout(spec)
    dev, n = _check_inputs(lay, arrays)
    if dev.type == "cpu":
        return chain_plain(spec, arrays)
    a, b = lay.out_words
    flat = torch.empty(a * n + b, dtype=torch.int32, device=dev)
    block = chain_args(spec, arrays, flat)
    err = _fc_chain()(block.ctypes.data, len(block), n, _build.stream_ptr(dev))
    _build.check(err, "fused_chain")
    _build.count_launch("fused_chain")
    return flat
