"""Static program statistics: the reference's HLO text analyzer, and the
port's op counter for its own (eager torch) programs.

**(a) The HLO text analyzer**, a copy of the reference's
``launch/hlo_analysis.py`` (and of ``dryrun.py``'s ``parse_collectives``):
it reads post-optimization (SPMD-partitioned) HLO text, walks the call
graph (entry -> fusions/calls/while bodies), extracts static trip counts
from loop conditions, and accumulates per device:

* matmul FLOPs        — every ``dot`` op: 2 * prod(result) * prod(contracting)
* HBM byte traffic    — per top-level instruction: result + operand bytes
                        (fused elementwise subcomputations are free — they
                        never round-trip HBM)
* ICI collective traffic — per collective, ring-model bytes-on-link:
      all-reduce       2 (n-1)/n * result
      all-gather         (n-1)/n * result
      reduce-scatter     (n-1)   * result      (result is the scattered shard)
      all-to-all         (n-1)/n * result
      collective-permute           result

It gives the reference's result on the same text, so the port can read
the reference's HLO artifacts and records.

**(b) The op counter**, :class:`OpCounter`: the port has no compiler and
no HLO, so it counts the ops a program dispatches instead. A
``TorchDispatchMode`` fills the same :class:`Stats` fields (``flops``,
``mem_bytes``) from every aten op that runs under it, forward, backward
and rematerialized forward alike:

* FLOPs by ``torch.utils.flop_counter``'s per-op formulas (products,
  convolutions, attention); other ops count none, as the analyzer counts
  only ``dot``;
* HBM bytes as operand + result bytes of every op that is not a view.
  An op whose schema says every result aliases an input without writing
  it (a view: ``view``, ``transpose``, ``unbind``, ``detach``, ...) moves
  nothing, nor does ``_unsafe_view`` (a view its schema does not
  declare) or an allocation that writes nothing (``empty``); an
  in-place op reads its operands and writes its result (the tensor it
  updates). The model is unfused, which is true of eager torch and
  unlike the HLO model, where fused elementwise chains are free: the
  counter charges each op of such a chain its own reads and writes.

The counts are of the global (unsharded) program, since one card runs
the whole of it; ``launch/dryrun.py`` divides them over a mesh. On
``meta`` tensors the program runs without storage, so a step at any
size is counted without a device; the same program on a device must give
the same count, which ``chip_smoke.py`` checks on the card.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "token": 0,
    "s4": 1, "u4": 1,
}

_SHAPE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.*)$")
_COMP_HDR = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\((.*?)\)\s*->\s*(.+?)\s*\{")
_CALL_ATTR = re.compile(r"(?:calls|to_apply|body|condition)=%?([\w.\-]+)")
_OPERAND = re.compile(r"%([\w.\-]+)")
_GROUPS = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_CONTRACT = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")
_CONST = re.compile(r"s32\[\]\s+constant\((\d+)\)")

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

_OPCODE = re.compile(
    r"\b(dot|while|fusion|call|conditional|custom-call|"
    + "|".join(c for c in COLLECTIVES)
    + r"|convolution|get-tuple-element|parameter|constant|tuple)\b"
)

# parse_collectives' own patterns (the reference's dryrun.py)
COLLECTIVE_RE = re.compile(
    r"\b(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)\b"
)
SHAPE_RE = re.compile(r"\b(f32|bf16|f16|s32|u32|s64|u64|pred|s8|u8|f64)\[([0-9,]*)\]")


def shape_bytes(type_str: str) -> int:
    """Total bytes of a (possibly tuple) type string."""
    total = 0
    for m in _SHAPE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def shape_dims(type_str: str) -> Optional[Tuple[str, List[int]]]:
    m = _SHAPE.search(type_str)
    if not m:
        return None
    dims = [int(d) for d in m.group(2).split(",") if d]
    return m.group(1), dims


def parse_collectives(hlo_text: str):
    """Sum result-operand sizes of every collective op in optimized HLO:
    {kind: {"count": n, "bytes": b}}."""
    out = {}
    for line in hlo_text.splitlines():
        m = COLLECTIVE_RE.search(line)
        if not m or "=" not in line:
            continue
        kind = m.group(1)
        # result shape(s): first type annotation(s) on the lhs
        lhs = line.split("=", 1)[0] + "=" + line.split("=", 1)[1].split(m.group(1))[0]
        nbytes = 0
        for sm in SHAPE_RE.finditer(lhs):
            dt, dims = sm.group(1), sm.group(2)
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * DTYPE_BYTES[dt]
        ent = out.setdefault(kind, {"count": 0, "bytes": 0})
        ent["count"] += 1
        ent["bytes"] += nbytes
    return out


@dataclass
class Instr:
    name: str
    opcode: str
    rhs: str
    result_type: str


@dataclass
class Computation:
    name: str
    instrs: List[Instr] = field(default_factory=list)
    shapes: Dict[str, str] = field(default_factory=dict)  # value name -> type str


@dataclass
class Stats:
    flops: float = 0.0
    mem_bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    coll_count: Dict[str, int] = field(default_factory=dict)

    def add(self, other: "Stats", mult: float = 1.0):
        self.flops += other.flops * mult
        self.mem_bytes += other.mem_bytes * mult
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + v * mult
        for k, v in other.coll_count.items():
            self.coll_count[k] = self.coll_count.get(k, 0) + int(v * mult)


def parse_module(text: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    entry_name = None
    for raw in text.splitlines():
        line = raw.rstrip()
        hdr = _COMP_HDR.match(line)
        if hdr and ("{" in line) and ("=" not in line.split("(")[0]):
            cur = Computation(hdr.group(1))
            comps[cur.name] = cur
            if line.lstrip().startswith("ENTRY"):
                entry_name = cur.name
            # parameter shapes from the signature
            for pm in re.finditer(r"([\w.\-]+):\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?))", hdr.group(2)):
                cur.shapes[pm.group(1)] = pm.group(2)
            continue
        if cur is None:
            continue
        if line.strip() == "}":
            cur = None
            continue
        im = _INSTR.match(line)
        if im:
            name, rhs = im.group(1), im.group(2)
            opm = _OPCODE.search(rhs)
            opcode = opm.group(1) if opm else "other"
            # result type: prefix of rhs up to opcode
            rtype = rhs[: opm.start()] if opm else rhs
            cur.instrs.append(Instr(name, opcode, rhs, rtype))
            cur.shapes[name] = rtype
    if entry_name is None:
        raise ValueError("no ENTRY computation found")
    comps["__entry__"] = comps[entry_name]
    return comps


def trip_count(comps: Dict[str, Computation], cond_name: str) -> int:
    cond = comps.get(cond_name)
    if cond is None:
        return 1
    consts = []
    for i in cond.instrs:
        consts += [int(v) for v in _CONST.findall(i.rhs)]
        # constants may also live in fused sub-computations of the cond
        cm = _CALL_ATTR.search(i.rhs)
        if cm and cm.group(1) in comps:
            for j in comps[cm.group(1)].instrs:
                consts += [int(v) for v in _CONST.findall(j.rhs)]
    return max(consts) if consts else 1


def _dot_flops(comp: Computation, ins: Instr) -> float:
    res = shape_dims(ins.result_type)
    if res is None:
        return 0.0
    _, rdims = res
    ops = _OPERAND.findall(ins.rhs)
    lhs_type = comp.shapes.get(ops[0]) if ops else None
    cm = _CONTRACT.search(ins.rhs)
    contract = 1
    if lhs_type and cm:
        ls = shape_dims(lhs_type)
        if ls:
            for d in cm.group(1).split(","):
                if d:
                    idx = int(d)
                    if idx < len(ls[1]):
                        contract *= ls[1][idx]
    n = 1
    for d in rdims:
        n *= d
    return 2.0 * n * contract


def _coll_traffic(kind: str, result_bytes: float, group: int) -> float:
    n = max(group, 2)
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if kind == "all-gather":
        return (n - 1) / n * result_bytes
    if kind == "reduce-scatter":
        return (n - 1) * result_bytes
    if kind == "all-to-all":
        return (n - 1) / n * result_bytes
    return result_bytes  # collective-permute


def analyze(text: str) -> Stats:
    comps = parse_module(text)
    memo: Dict[str, Stats] = {}

    def comp_stats(name: str, stack=()) -> Stats:
        if name in memo:
            return memo[name]
        if name in stack or name not in comps:
            return Stats()
        comp = comps[name]
        st = Stats()
        for ins in comp.instrs:
            if ins.opcode == "dot":
                st.flops += _dot_flops(comp, ins)
            if ins.opcode in COLLECTIVES:
                rb = shape_bytes(ins.result_type)
                gm = _GROUPS.search(ins.rhs)
                group = int(gm.group(2)) if gm else 2
                st.coll_bytes[ins.opcode] = st.coll_bytes.get(ins.opcode, 0.0) + _coll_traffic(
                    ins.opcode, rb, group
                )
                st.coll_count[ins.opcode] = st.coll_count.get(ins.opcode, 0) + 1
            # HBM traffic model: top-level instruction results are written
            # once; operands read once — except slice-like ops, which touch
            # only the sliced/updated region, not the whole buffer.
            if ins.opcode not in ("parameter", "constant", "tuple", "get-tuple-element"):
                rb = shape_bytes(ins.result_type)
                slice_like = any(
                    kw in ins.rhs
                    for kw in (
                        " dynamic-slice(",
                        " dynamic-update-slice(",
                        " gather(",
                        " scatter(",
                        " slice(",
                    )
                )
                if slice_like:
                    sizes = [rb]
                    for op in _OPERAND.findall(ins.rhs):
                        t = comp.shapes.get(op)
                        if t:
                            b = shape_bytes(t)
                            if b > 0:
                                sizes.append(b)
                    st.mem_bytes += 2 * min(sizes)
                elif ins.opcode == "fusion":
                    # fusions absorb slices/broadcasts of big (often
                    # loop-carried) operands: cap each operand at the
                    # result size. Exact matmul traffic is counted at the
                    # dot ops; this keeps elementwise fusions ~2x result.
                    st.mem_bytes += rb
                    for op in _OPERAND.findall(ins.rhs):
                        t = comp.shapes.get(op)
                        if t:
                            st.mem_bytes += min(shape_bytes(t), rb)
                else:
                    st.mem_bytes += rb
                    for op in _OPERAND.findall(ins.rhs):
                        t = comp.shapes.get(op)
                        if t:
                            st.mem_bytes += shape_bytes(t)
            # recursion
            if ins.opcode == "while":
                bm = re.search(r"body=%?([\w.\-]+)", ins.rhs)
                cn = re.search(r"condition=%?([\w.\-]+)", ins.rhs)
                if bm:
                    trips = trip_count(comps, cn.group(1)) if cn else 1
                    st.add(comp_stats(bm.group(1), stack + (name,)), trips)
                    if cn:
                        st.add(comp_stats(cn.group(1), stack + (name,)), trips)
            elif ins.opcode in ("fusion", "call", "custom-call", "conditional"):
                for cm in _CALL_ATTR.finditer(ins.rhs):
                    sub = comp_stats(cm.group(1), stack + (name,))
                    # fused elementwise bodies don't touch HBM; only count
                    # their dots/collectives (rare but possible via calls)
                    st.flops += sub.flops
                    for k, v in sub.coll_bytes.items():
                        st.coll_bytes[k] = st.coll_bytes.get(k, 0.0) + v
                    for k, v in sub.coll_count.items():
                        st.coll_count[k] = st.coll_count.get(k, 0) + v
        memo[name] = st
        return st

    return comp_stats("__entry__")


# ---------------------------------------------------------------------------
# (b) The op counter
# ---------------------------------------------------------------------------


def _tensor_bytes(x) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


def _is_view(func) -> bool:
    """Every result of ``func`` aliases an input and none is written: a
    view, which moves no bytes."""
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in rets
    )


def _op_counter_mode():
    """The ``TorchDispatchMode`` class of :class:`OpCounter`, built on
    first use so that importing this module imports no torch."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    aten = torch.ops.aten
    # allocations that write nothing, and ``_unsafe_view``, a view whose
    # schema does not say so (it renames a fresh result, as of reshape's copy)
    no_bytes = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
                aten.new_empty.default, aten.new_empty_strided.default,
                aten._unsafe_view.default}

    class _Mode(TorchDispatchMode):
        def __init__(self, stats: Stats, ops: Optional[Dict[str, int]]):
            super().__init__()
            self.stats, self.ops = stats, ops

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.stats.flops += formula(*args, **kwargs, out_val=out)
            if not (func in no_bytes or _is_view(func)):
                self.stats.mem_bytes += (sum(_tensor_bytes(a) for a in args)
                                         + sum(_tensor_bytes(v) for v in kwargs.values())
                                         + _tensor_bytes(out))
            if self.ops is not None:
                name = str(func)
                self.ops[name] = self.ops.get(name, 0) + 1
            return out

    return _Mode


class OpCounter:
    """Counts the FLOPs and HBM bytes of the aten ops run inside it (see
    the module docstring for the model)::

        with OpCounter() as c:
            step(params, opt_state, batch)
        c.stats.flops, c.stats.mem_bytes

    ``record_ops=True`` also keeps the number of calls of each op
    (``ops``), for finding where two counts part."""

    def __init__(self, record_ops: bool = False):
        self.stats = Stats(0, 0)  # Python ints: exact at any size
        self.ops: Optional[Dict[str, int]] = {} if record_ops else None
        self._mode = None

    def __enter__(self) -> "OpCounter":
        self._mode = _op_counter_mode()(self.stats, self.ops)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        mode, self._mode = self._mode, None
        return mode.__exit__(*exc)
