"""Bytes a call of B1-B4 needs, from the call's arguments alone.

The count does not depend on which implementation runs, or on the data:

* every row input (morsel-length arrays) is read once, and the output is
  written once;
* every probed key reads one home-slot word of its table, per stage;
* the small parameter arrays (grants, filters, lens and sink tables: any
  whole-array input of at most ``PARAM_BYTES``) are read whole; a larger
  whole-array input is a hash table or a mirror, of which a probe reads
  only what the keys reach, counted by the home-slot word.

Divided by the HBM bandwidth (``peaks.H100_HBM_BW``) this is the least
time the call could take on the card: its bound.
"""

from __future__ import annotations

from typing import List

PARAM_BYTES = 64 * 1024
WORD = 4  # every array the kernels take is int32


def chain_input_kinds(spec) -> List[str]:
    """``"row"`` / ``"full"`` for each array of a fused-chain call, in the
    order the call takes them: a copy of the chain's argument traversal
    (``repro_torch.kernels.fused_chain.input_kinds``)."""
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


def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def count(name: str, args, out) -> int:
    if name == "chain_launch":
        spec, arrays = args[0], args[1]
        kinds = chain_input_kinds(spec)
        if len(kinds) != len(arrays):
            raise ValueError(f"chain call with {len(arrays)} arrays, spec wants {len(kinds)}")
        n_rows = int(arrays[0].shape[0])
        total = _nbytes(out)
        for a, kind in zip(arrays, kinds):
            b = _nbytes(a)
            if kind == "row" or b <= PARAM_BYTES:
                total += b
        return total + len(spec[0]) * n_rows * WORD
    n = int(args[0].numel())
    out_words = 3 if name == "hash_probe_lens_multi64" else 1
    return (2 + out_words) * n * WORD  # keys, home slot, output
