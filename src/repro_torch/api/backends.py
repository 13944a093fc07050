"""ExecutionBackend: pluggable data-plane kernels behind one Session.

The engine's two hot vectorized operations — hash-probe against a shared
build state (§4.3) and segmented aggregation into shared accumulators
(§4.5) — are routed through a per-session backend:

* ``ReferenceBackend`` — the NumPy row engine (incremental hash/dup-run
  probe index in ``core.state``, ``np.bincount`` reductions). Always
  available; the correctness oracle path (``relational/refexec.py``
  semantics).
* ``TorchBackend`` — the hand-written CUDA kernels of ``kernels/
  hash_probe.py`` and ``kernels/fused_chain.py`` (and, opt-in, of
  ``kernels/seg_aggregate.py``) over device-resident
  state mirrors on a CUDA card, or the kernels' plain PyTorch versions
  with ``device="cpu"``. States that the kernels cannot serve
  (multi-match keys, out-of-range keycodes, over-long probe clusters)
  fall back to the reference path per call; per-reason fallback counters
  record why.

The torch backend keeps a device-resident mirror of every served state's
SoA (DESIGN.md §13): open-addressing keycode table, *entry-indexed* packed
visibility/provenance words as (lo, hi) 32-bit halves, and on demand
total-order-encoded retained columns and int32 key columns. Entry indexing
makes the mirrors rebuild-invariant — growing or rehashing the probe table
never touches them — and the state's mark log patches exactly the re-ORed
entries in place (``index_copy_``), so steady-state maintenance is
O(appended + marked), not O(entries). Every 32-bit word is held in an
int32 tensor with the same bits.

Under a program trace (``core/trace.py``) each of the five engine calls
is a ``backend.<call>`` span; inside them ``backend.table`` (key inserts
with the table's upload, mirror syncs), ``backend.fallback`` (a declined
probe served by the reference path) and ``backend.wait`` (the waits for
the card); and every host<->device copy counts its logical bytes.
"""

from __future__ import annotations

import math
import weakref
from typing import Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from ..core import trace as _trace
from ..core.state import SharedHashBuildState, _bincount_segment_sum
from ..core.visibility import join_words, split_words
from ..kernels.fused_chain import chain_launch, split_outputs, total_order_bound, total_order_u32
from ..kernels.hash_probe import (
    EMPTY,
    MAX_PROBE,
    MULT,
    hash_build_insert,
    hash_probe_lens,
    hash_probe_lens64,
    hash_probe_lens_multi64,
)
from ..kernels.seg_aggregate import seg_aggregate

#: chain-level / probe-level decline reasons (DESIGN.md §13). ``grants``,
#: ``predicate`` and ``slot_limit`` are chain-plan declines (the staged
#: kernels may still serve the probes); ``keyrange`` and ``capacity`` are
#: table-level declines that route the probe to the reference path.
FALLBACK_REASONS = ("grants", "slot_limit", "keyrange", "capacity", "predicate")


@runtime_checkable
class ExecutionBackend(Protocol):
    """Data-plane operations a Session's engine dispatches per morsel.

    Backends may additionally provide ``probe_visible(state, keycodes,
    qid)`` / ``probe_visible_multi(state, keycodes)`` /
    ``probe_chain(cplan, cols, bits, host_keys)`` returning
    visibility-resolved results (or None to decline); the runtime discovers
    them via getattr, so they are not part of the required protocol
    surface. A backend that sets ``probe_accepts_counters = True`` receives
    the engine's counter dict as a ``counters=`` kwarg on ``probe`` so
    per-reason fallback counters surface in ``QueryFuture.stats()``."""

    name: str

    def probe(
        self, state: SharedHashBuildState, keycodes: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """All (probe_row_idx, entry_idx) match pairs, pre-visibility."""
        ...

    def segment_sum(
        self, gids: np.ndarray, values: Optional[np.ndarray], n_groups: int
    ) -> np.ndarray:
        """Per-group sum of ``values`` (counts when values is None)."""
        ...


class ReferenceBackend:
    """NumPy data plane — delegates to the state's own incremental probe
    index (shard-routed under ``n_partitions > 1``, DESIGN.md §9) and the
    core bincount reduction (the same code that runs with no backend)."""

    name = "reference"
    probe_accepts_counters = True

    def probe(self, state, keycodes, counters=None):
        return state.probe(keycodes)

    def segment_sum(self, gids, values, n_groups):
        return _bincount_segment_sum(gids, values, n_groups)

    def stats(self) -> dict:
        return {}


def _i32(a: np.ndarray) -> np.ndarray:
    """uint32 words viewed as int32 (same bits); anything else as int32."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a.astype(np.int32, copy=False)


class _Staging:
    """The per-row inputs of one kernel call, staged through one host buffer
    into one device buffer, and the call's output brought back into a
    second host buffer (DESIGN.md §13). On the card both host buffers are
    pinned, so the upload and the fetch are ``non_blocking`` copies and the
    call waits once, in :meth:`fetch`; with ``device="cpu"`` the same code
    runs on ordinary tensors. The buffers grow to the largest call.

    A call runs ``begin(n_rows, npad)``, then ``row(values, fill)`` once
    per row input (each writes its values and padding into the host buffer
    in place, casting to int32 on the way, and returns that row's view of
    the device buffer), then ``upload()`` (one copy), the launch, and
    ``fetch(out)``. The host buffer may only be rewritten after that wait,
    which the next ``begin`` can rely on, since every call that uploads
    also fetches."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self.host = self.host_np = self.dev = self.out = None
        self.npad = self.used = 0

    def _grow(self, buf, words, on_device):
        if buf is not None and buf.numel() >= words:
            return buf
        size = max(words, 2 * buf.numel() if buf is not None else 0)
        if on_device:
            return torch.empty(size, dtype=torch.int32, device=self.device)
        return torch.empty(size, dtype=torch.int32, pin_memory=self.pinned)

    def begin(self, n_rows: int, npad: int) -> None:
        words = n_rows * npad
        host = self._grow(self.host, words, False)
        if host is not self.host:
            self.host, self.host_np = host, host.numpy()
        self.dev = self._grow(self.dev, words, True)
        self.npad, self.used = npad, 0

    def row(self, values: np.ndarray, fill: int = 0) -> torch.Tensor:
        off, n = self.used, len(values)
        self.used += self.npad
        np.copyto(self.host_np[off : off + n], values, casting="unsafe")
        self.host_np[off + n : self.used] = fill
        return self.dev[off : self.used]

    def upload(self) -> None:
        self.dev[: self.used].copy_(self.host[: self.used], non_blocking=True)
        tr = _trace.active
        if tr is not None:
            tr.h2d(4 * self.used)

    def fetch(self, out: torch.Tensor) -> np.ndarray:
        """``out`` (int32, contiguous) in host memory, in its shape, after
        the call's one wait; a view that the next fetch overwrites."""
        n = out.numel()
        self.out = self._grow(self.out, n, False)
        self.out[:n].copy_(out.view(-1), non_blocking=True)
        tr = _trace.active
        if tr is not None:
            tr.d2h(4 * n)
        self.wait()
        return self.out[:n].numpy().reshape(out.shape)

    def wait(self) -> None:
        tr = _trace.active
        if tr is not None:
            span = tr.open("backend.wait")
        if self.pinned:
            torch.cuda.synchronize(self.device)
        if tr is not None:
            tr.close(span)


class _ProbeTable:
    """Device-resident mirror of one state's SoA (DESIGN.md §13).

    The open-addressing keycode table is slot-indexed; everything else —
    visibility/provenance words, total-order column encodings, int32 key
    columns — is *entry-indexed* (padded to ``ecap``), so table rebuilds
    never invalidate it. Appends patch ``[rows:n]``; visibility marks patch
    the state's mark-log entries; a mark-log compaction or a ``detach``
    epoch bump forces one full regather."""

    __slots__ = (
        "n",
        "tkeys",
        "slot_entry",
        "jkeys",
        "jentry",
        "jones",
        "bad",
        "ecap",
        "jvlo",
        "jvhi",
        "jelo",
        "jehi",
        "vis_rows",
        "em_rows",
        "vis_stamp",
        "mark_sync",
        "ords",
        "keycols",
        "badkeys",
    )

    def __init__(self):
        self.n = 0  # state entries inserted so far
        self.tkeys: Optional[np.ndarray] = None  # int32 slots (EMPTY sentinel)
        self.slot_entry: Optional[np.ndarray] = None  # slot -> entry index
        self.jkeys = None  # device copy of tkeys, refreshed on growth
        self.jentry = None  # device int32 slot -> entry index
        self.jones = None  # constant all-visible lens words (pre-vis probes)
        self.bad = False  # sticky: kernel cannot serve this state's table
        # entry-indexed mirrors, padded to ecap (power of two)
        self.ecap = 0
        self.jvlo = None  # visibility word low halves, [ecap]
        self.jvhi = None
        self.jelo = None  # provenance (emask) halves, built on demand
        self.jehi = None
        self.vis_rows = 0  # entries the vis mirror reflects
        self.em_rows = 0
        self.vis_stamp = None  # (rows_inserted, rows_marked, vis_epoch)
        self.mark_sync = (0, 0)  # (mark_log_epoch, consumed log length)
        self.ords = {}  # attr -> [t_hi, t_lo, rows] total-order encodings
        self.keycols = {}  # attr -> [t_i32, rows] entry-origin key mirrors
        self.badkeys = set()  # attrs whose values left the int32 key range


class TorchBackend:
    """PyTorch/CUDA data plane.

    Unique-key states probe through the fused-lens kernels over
    entry-indexed device mirrors. Single-query probes route through
    ``probe_visible`` — the query's slot bit (any of the 64) becomes the
    kernel lens mask, so visibility resolves in-kernel and the runtime
    skips its NumPy ``visible_mask`` pass. Multi-member probes take
    ``probe_visible_multi``, which returns the matched entries' full packed
    64-bit words. ``probe_chain`` fuses a morsel's entire stage chain —
    probe → lens translation → compiled grant predicates → interval stage
    filters → sink word translation — into one launch
    (``kernels/fused_chain.py``). Everything the kernels cannot serve
    falls back to the reference probe, with the decline reason counted in
    ``fallback_reasons``.

    ``device="cuda"`` (the default) runs the CUDA kernels and raises when
    no card is visible; ``device="cpu"`` runs their plain PyTorch versions.
    Both give bit-identical results, counters and virtual clocks.

    Probe-table maintenance is batch-oriented: new keys insert via
    vectorized per-slot winner election (``_batch_insert``) on the host,
    and the whole table is uploaded again after each batch insert. With
    ``use_insert_kernel`` a full rebuild runs the batch-insert kernel
    (``hash_build_insert``) on the device instead, which places the keys
    in batch order, as the reference's kernel does; a table it flags
    (``ok == 0``) is marked bad and its state probes through the reference
    path. Incremental inserts keep the host winner election.

    Segmented sums stay in float64 on the host (``np.bincount``) by
    default, which preserves exact oracle parity. With ``use_agg_kernel``
    a sum over at most ``max_kernel_groups`` groups runs the segmented
    aggregate kernel instead; it adds in float64 but rounds each call's
    sums to float32, as the reference's kernel returns them, so results
    then match the oracle within float32 rounding only.
    """

    name = "torch"
    probe_accepts_counters = True

    # Keycodes must fit int32 and stay clear of the kernel's EMPTY sentinel.
    _KEY_LIMIT = 2**31 - 2

    def __init__(
        self,
        device: str = "cuda",
        max_kernel_groups: int = 4096,
        use_agg_kernel: bool = False,
        use_insert_kernel: bool = False,
    ):
        self.max_kernel_groups = max_kernel_groups
        self.use_agg_kernel = use_agg_kernel
        self.use_insert_kernel = use_insert_kernel
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBackend(device='cuda') needs a CUDA card and none is "
                "visible; pass device='cpu' for the kernels' plain versions"
            )
        self._ref = ReferenceBackend()
        # mesh execution (§14): when a Session pins a one-shard data mesh
        # here, the fused stage chain launches shard-locally on it
        # (None = plain single-device launches)
        self.mesh = None
        # Probe tables keyed weakly by the state OBJECT (state_ids are
        # engine-local, so an id key would collide when one backend instance
        # is reused across sessions); released states evict automatically.
        self._tables: "weakref.WeakKeyDictionary[SharedHashBuildState, _ProbeTable]" = (
            weakref.WeakKeyDictionary()
        )
        self._staging = _Staging(self.device)  # row inputs of the chain and the probes
        self.kernel_probes = 0
        self.kernel_lens_probes = 0
        self.kernel_multi_probes = 0
        self.fallback_probes = 0
        self.chain_launches = 0
        self.mirror_full_regathers = 0
        self.mirror_patched_rows = 0
        self.fallback_reasons = {r: 0 for r in FALLBACK_REASONS}

    def stats(self) -> dict:
        """Kernel-dispatch counters (surfaced via ``Session.stats``).

        Partitioned states (``n_partitions > 1``) need no special casing
        here: the probe-table mirror is built from the state's global
        keycode SoA, whose entry ids are partition-independent (§9) — each
        (fragment × partition) unit simply lands its own batched kernel
        call, which is the real per-partition work the pool models."""
        out = {
            "kernel_probes": self.kernel_probes,
            "kernel_lens_probes": self.kernel_lens_probes,
            "kernel_multi_probes": self.kernel_multi_probes,
            "fallback_probes": self.fallback_probes,
            "chain_launches": self.chain_launches,
            "mirror_full_regathers": self.mirror_full_regathers,
            "mirror_patched_rows": self.mirror_patched_rows,
        }
        for r in FALLBACK_REASONS:
            out[f"fallback_{r}"] = self.fallback_reasons[r]
        return out

    def note_fallback(self, reason: str, counters=None) -> None:
        """Record one kernel decline by reason, on the backend and (when
        the engine's counter dict is handed in) in the session counters."""
        self.fallback_reasons[reason] += 1
        if counters is not None:
            counters[f"fallback_probes_{reason}"] += 1

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """A fresh device copy of a host array, 32-bit words as int32."""
        a = _i32(a)
        tr = _trace.active
        if tr is not None:
            tr.h2d(a.nbytes)
        return torch.from_numpy(a).to(self.device, copy=True)

    def _staged_keys(self, keycodes: np.ndarray) -> torch.Tensor:
        """A probe's keys on the device, through the staging buffers (int32
        in the copy into the host buffer); the probe's ``fetch`` of its
        output is then the call's one wait."""
        stage = self._staging
        stage.begin(1, len(keycodes))
        keys = stage.row(keycodes)
        stage.upload()
        return keys

    # -- probe ---------------------------------------------------------------
    def probe(self, state, keycodes, counters=None):
        tr = _trace.active
        if tr is not None:
            span = tr.open("backend.probe", len(keycodes))
        try:
            if state.keycode.n == 0 or len(keycodes) == 0:
                return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
            table = self._table_for(state)
            if table is None:
                self.fallback_probes += 1
                self.note_fallback("capacity", counters)
                return self._fallback_probe(state, keycodes)
            if keycodes.min() < 0 or keycodes.max() > self._KEY_LIMIT:
                self.fallback_probes += 1
                self.note_fallback("keyrange", counters)
                return self._fallback_probe(state, keycodes)
            tkeys, tones, slot_entry = table
            keys = self._staged_keys(keycodes)
            # lens off: pure key match, an all-ones mask over all-ones words
            found_slots = self._staging.fetch(hash_probe_lens(keys, tkeys, tones, 0xFFFFFFFF))
            self.kernel_probes += 1
            probe_idx = np.flatnonzero(found_slots >= 0).astype(np.int64)
            entry_idx = slot_entry[found_slots[probe_idx]]
            return probe_idx, entry_idx
        finally:
            if tr is not None:
                tr.close(span)

    def _fallback_probe(self, state, keycodes):
        """A declined probe, served by the reference path on the host."""
        tr = _trace.active
        if tr is not None:
            span = tr.open("backend.fallback", len(keycodes))
        out = self._ref.probe(state, keycodes)
        if tr is not None:
            tr.close(span)
        return out

    def probe_visible(self, state, keycodes, qid):
        """Single-query probe with the state lens fused in-kernel.

        Returns visibility-filtered (probe_idx, entry_idx) pairs, or None
        when the kernel cannot take over the lens (extent-scoped grants
        need predicate evaluation — unless routed through ``probe_chain``'s
        compiled form; unservable tables fall back entirely). The lens
        words are entry-indexed 32-bit pairs, so any slot 0..63 serves."""
        tr = _trace.active
        if tr is not None:
            span = tr.open("backend.probe_visible", len(keycodes))
        try:
            if state.grants.get(qid):
                return None
            slot = state.slots.peek(qid)
            if slot is None:
                return None
            if state.keycode.n == 0 or len(keycodes) == 0:
                # decline instead of returning the empty pair: keeps the
                # kernel_lens_probes backend attr == engine counter invariant
                return None
            table = self._table_for(state)
            if table is None or keycodes.min() < 0 or keycodes.max() > self._KEY_LIMIT:
                return None
            ent = self._tables[state]
            self._sync_mirrors(ent, state)
            keys = self._staged_keys(keycodes)
            bit = 1 << slot  # the lens mask, by value
            found = self._staging.fetch(hash_probe_lens64(
                keys, ent.jkeys, ent.jentry, ent.jvlo, ent.jvhi, (bit & 0xFFFFFFFF, bit >> 32)
            ))
            self.kernel_probes += 1
            self.kernel_lens_probes += 1
            probe_idx = np.flatnonzero(found >= 0).astype(np.int64)
            entry_idx = ent.slot_entry[found[probe_idx]]
            return probe_idx, entry_idx
        finally:
            if tr is not None:
                tr.close(span)

    def probe_visible_multi(self, state, keycodes):
        """Multi-member probe with the packed lens words gathered in-kernel
        (§11): returns ``(probe_idx, entry_idx, vis_words)`` where
        ``vis_words[i]`` is the matched entry's full uint64 visibility
        word (rejoined from the kernel's 32-bit halves), or None when the
        kernel cannot serve the state. The pair stream is pre-visibility
        and identical to ``probe`` — ownership filtering happens in the
        runtime's packed translation — so results stay bit-identical to
        the reference path for every member count and any slot 0..63."""
        tr = _trace.active
        if tr is not None:
            span = tr.open("backend.probe_visible_multi", len(keycodes))
        try:
            if state.keycode.n == 0 or len(keycodes) == 0:
                return None
            table = self._table_for(state)
            if table is None or keycodes.min() < 0 or keycodes.max() > self._KEY_LIMIT:
                return None
            ent = self._tables[state]
            self._sync_mirrors(ent, state)
            keys = self._staged_keys(keycodes)
            rows = hash_probe_lens_multi64(keys, ent.jkeys, ent.jentry, ent.jvlo, ent.jvhi)
            found, wlo, whi = self._staging.fetch(rows[0]._base)  # the [3, N] buffer
            self.kernel_probes += 1
            self.kernel_multi_probes += 1
            probe_idx = np.flatnonzero(found >= 0).astype(np.int64)
            entry_idx = ent.slot_entry[found[probe_idx]]
            vis_words = join_words(wlo.view(np.uint32)[probe_idx], whi.view(np.uint32)[probe_idx])
            return probe_idx, entry_idx, vis_words
        finally:
            if tr is not None:
                tr.close(span)

    # -- fused stage chain (DESIGN.md §13) -----------------------------------
    def probe_chain(self, cplan, cols, bits, host_keys, counters=None):
        """One fused launch for a morsel's entire stage chain.

        ``cplan`` is the runtime's compiled chain plan (``Pipeline.
        _build_chain_plan``): per stage the target state, lens translation
        tables, key sourcing, compiled grants and interval filter matrices;
        plus the sink translation tables. ``cols`` are the morsel's
        source-compacted columns, ``bits`` the packed ownership words and
        ``host_keys`` the per-stage host-encoded keycodes for
        source-origin keys. Returns None on a dynamic decline (reason
        counted), else a dict with the final packed words, per-stage
        matched entry indices, per-stage (alive, matched,
        matched_visible) stats, per-slot survivor counts, and — for build
        chains — the sink visibility/provenance words. Device parameter
        uploads are cached on the plan (``cplan["_dev"]``), so steady-state
        morsels ship only the row-length arrays."""
        tr = _trace.active
        if tr is not None:
            span = tr.open("backend.probe_chain", len(bits))
        try:
            stages = cplan["stages"]
            n = len(bits)
            if n == 0:
                return None

            # collect per-state mirror needs across the chain
            needs: dict = {}

            def need(state):
                nd = needs.get(id(state))
                if nd is None:
                    nd = needs[id(state)] = {
                        "state": state,
                        "em": False,
                        "ords": set(),
                        "keys": set(),
                    }
                return nd

            for st in stages:
                state = st["state"]
                if state.keycode.n == 0:
                    return None  # no rows can survive; the staged path is as cheap
                need(state)
                key = st["key"]
                if key[0] == "entry":
                    need(stages[key[1]]["state"])["keys"].add(key[2])
                if st["grants"]:
                    nd = need(state)
                    nd["em"] = True
                    for _, _, bounds in st["grants"]:
                        for a, _, _ in bounds:
                            nd["ords"].add(a)
                f = st["filter"]
                if f is not None:
                    for ref in f["attrs"]:
                        if ref[0] == "entry":
                            need(stages[ref[1]]["state"])["ords"].add(ref[2])
            for st in stages:
                if self._table_for(st["state"]) is None:
                    self.note_fallback("capacity", counters)
                    return None
            for nd in needs.values():
                state = nd["state"]
                ent = self._tables[state]
                self._sync_mirrors(
                    ent,
                    state,
                    need_em=nd["em"],
                    ord_attrs=sorted(nd["ords"]),
                    key_attrs=sorted(nd["keys"]),
                )
                for a in nd["keys"]:
                    if a in ent.badkeys:
                        self.note_fallback("keyrange", counters)
                        return None

            npad = 8
            while npad < n:
                npad *= 2
            # every row input goes through the staging buffers, padded in place
            # (dead rows: zero words, EMPTY keys): the ownership halves, one key
            # array per host-key stage, two per host filter column
            n_rows = 2
            for st in stages:
                n_rows += st["key"][0] == "host"
                f = st["filter"]
                if f is not None:
                    n_rows += 2 * sum(ref[0] == "host" for ref in f["attrs"])
            stage = self._staging
            stage.begin(n_rows, npad)
            halves = np.ascontiguousarray(bits, dtype="<u8").view("<u4")
            arrays = [stage.row(halves[0::2]), stage.row(halves[1::2])]
            spec_stages = []
            dev = cplan["_dev"]
            for si, st in enumerate(stages):
                ent = self._tables[st["state"]]
                key = st["key"]
                if key[0] == "host":
                    kc = host_keys[si]
                    if len(kc) and (kc.min() < 0 or kc.max() > self._KEY_LIMIT):
                        self.note_fallback("keyrange", counters)
                        return None
                    key_mode = -1
                    arrays.append(stage.row(kc, EMPTY))
                else:
                    key_mode = key[1]
                    oent = self._tables[stages[key_mode]["state"]]
                    arrays.append(oent.keycols[key[2]][0])
                arrays += [ent.jkeys, ent.jentry, ent.jvlo, ent.jvhi]
                tt = dev.get(("tt", si))
                if tt is None:
                    tlo, thi = split_words(st["tables"].ravel())
                    tt = (self._to_dev(tlo.reshape(8, 256)), self._to_dev(thi.reshape(8, 256)))
                    dev[("tt", si)] = tt
                arrays += [tt[0], tt[1]]
                n_grants = len(st["grants"])
                g_attrs = 0
                if n_grants:
                    gp = dev.get(("g", si))
                    if gp is None:
                        gp = self._grant_params(st["grants"])
                        dev[("g", si)] = gp
                    gattr_names, gbit, gallow, gcon, glo, ghi = gp
                    g_attrs = len(gattr_names)
                    arrays += [ent.jelo, ent.jehi, gbit, gallow, gcon, glo, ghi]
                    for a in gattr_names:
                        rec = ent.ords[a]
                        arrays += [rec[0], rec[1]]
                f = st["filter"]
                fspec = None
                if f is not None and len(f["attrs"]):
                    srcs = []
                    for ref in f["attrs"]:
                        if ref[0] == "host":
                            vh, vl = total_order_u32(np.asarray(cols[ref[1]], dtype=np.float64))
                            arrays += [stage.row(vh), stage.row(vl)]
                            srcs.append(-1)
                        else:
                            rec = self._tables[stages[ref[1]]["state"]].ords[ref[2]]
                            arrays += [rec[0], rec[1]]
                            srcs.append(ref[1])
                    fp = dev.get(("f", si))
                    if fp is None:
                        fp = self._filter_params(f)
                        dev[("f", si)] = fp
                    arrays += list(fp)
                    fspec = (f["n_members"], tuple(srcs))
                spec_stages.append((key_mode, n_grants, g_attrs, fspec))
            sink = cplan["sink"]
            if sink is not None:
                sp = dev.get("sink")
                if sp is None:
                    vt, et = sink
                    vlo, vhi = split_words(vt.ravel())
                    elo, ehi = split_words(et.ravel())
                    sp = tuple(self._to_dev(x.reshape(8, 256)) for x in (vlo, vhi, elo, ehi))
                    dev["sink"] = sp
                arrays += list(sp)
            spec = (tuple(spec_stages), sink is not None)
            # one copy up, the launch, one copy down, one wait
            stage.upload()
            flat = stage.fetch(chain_launch(spec, arrays, mesh=self.mesh))
            out = split_outputs(spec, npad, flat)
            n_stages = len(stages)

            def words(lo, hi):
                return join_words(lo[:n].view(np.uint32), hi[:n].view(np.uint32))

            res = {
                "bits": words(out[0], out[1]),
                "entries": [out[2 + s][:n].astype(np.int64) for s in range(n_stages)],
                "stats": out[2 + n_stages].astype(np.int64),
                "slots": out[3 + n_stages].astype(np.int64),
            }
            if sink is not None:
                res["vismask"] = words(out[4 + n_stages], out[5 + n_stages])
                res["emask"] = words(out[6 + n_stages], out[7 + n_stages])
            self.kernel_probes += 1
            self.chain_launches += 1
            stats = res["stats"]
            for s, st in enumerate(stages):
                if stats[s, 0] == 0:
                    break
                if st["use_post"]:
                    self.kernel_lens_probes += 1
                else:
                    self.kernel_multi_probes += 1
            return res
        finally:
            if tr is not None:
                tr.close(span)

    def _grant_params(self, grants):
        """Device parameter matrices of one stage's compiled grants: the
        union attr list, per-grant split bit/allowed words, and the
        per-(grant, attr) constrained flags + total-order interval bounds
        (unconstrained cells carry flag 0 and the full [-inf, inf] band)."""
        attrs = []
        for _, _, bounds in grants:
            for a, _, _ in bounds:
                if a not in attrs:
                    attrs.append(a)
        n_g = len(grants)
        n_a = max(len(attrs), 1)
        gbit = np.zeros((n_g, 2), np.uint32)
        gallow = np.zeros((n_g, 2), np.uint32)
        gcon = np.zeros((n_g, n_a), np.int32)
        glo = np.zeros((n_g, n_a, 2), np.uint32)
        ghi = np.zeros((n_g, n_a, 2), np.uint32)
        glo[:, :, 0], glo[:, :, 1] = total_order_bound(-math.inf)
        ghi[:, :, 0], ghi[:, :, 1] = total_order_bound(math.inf)
        for g, (bitval, allowed, bounds) in enumerate(grants):
            lo, hi = split_words(np.array([bitval], dtype=np.uint64))
            gbit[g] = (lo[0], hi[0])
            lo, hi = split_words(np.array([allowed], dtype=np.uint64))
            gallow[g] = (lo[0], hi[0])
            for a, blo, bhi in bounds:
                j = attrs.index(a)
                gcon[g, j] = 1
                glo[g, j] = total_order_bound(blo)
                ghi[g, j] = total_order_bound(bhi)
        return (tuple(attrs),) + tuple(self._to_dev(x) for x in (gbit, gallow, gcon, glo, ghi))

    def _filter_params(self, f):
        """Device matrices of one stage's fused interval filter: bounds as
        total-order uint32 pairs, constrained flags, split member bits."""
        n_m = f["n_members"]
        n_a = len(f["attrs"])
        lh, ll = total_order_u32(np.asarray(f["lo"], np.float64).ravel())
        hh, hl = total_order_u32(np.asarray(f["hi"], np.float64).ravel())
        flo = np.stack([lh, ll], axis=-1).reshape(n_m, n_a, 2)
        fhi = np.stack([hh, hl], axis=-1).reshape(n_m, n_a, 2)
        fcon = np.asarray(f["con"], np.int32).reshape(n_m, n_a)
        blo, bhi = split_words(np.asarray(f["bitvals"], np.uint64))
        fbit = np.stack([blo, bhi], axis=-1)
        return tuple(self._to_dev(x) for x in (flo, fhi, fcon, fbit))

    # -- entry-indexed device mirrors ----------------------------------------
    def _upload(self, vals, cap):
        if len(vals) < cap:
            vals = np.pad(vals, (0, cap - len(vals)))
        return self._to_dev(vals)

    def _patch(self, buf, idx, vals):
        """Scatter ``vals`` into the device mirror at entry ids ``idx``, in
        place (``index_copy_``); the ids are unique."""
        idx = np.asarray(idx, dtype=np.int64)
        tr = _trace.active
        if tr is not None:
            tr.h2d(idx.nbytes)
        idx_t = torch.from_numpy(idx).to(self.device)
        buf.index_copy_(0, idx_t, self._to_dev(vals))
        return buf

    def _sync_mirrors(self, ent, state, need_em=False, ord_attrs=(), key_attrs=()):
        """Bring the entry-indexed device mirrors up to the state's SoA.

        Steady state is incremental: appended entries patch ``[rows:n]``,
        visibility/provenance marks patch exactly the state's mark-log
        entry ids. Only a mark-log compaction, a ``detach`` visibility
        epoch bump, or a capacity realloc trigger a full regather
        (``mirror_full_regathers`` counts them). Total-order column
        encodings and int32 key-column mirrors are append-only — retained
        column values never change after insert. Key columns whose values
        leave the int32 key range mark ``badkeys`` sticky. Traced as
        ``backend.table``, as is ``_insert_keys``."""
        tr = _trace.active
        if tr is not None:
            span = tr.open("backend.table", ent.n)
        n = ent.n
        if ent.jvlo is None or ent.ecap < n:
            cap = max(ent.ecap, 256)
            while cap < n:
                cap *= 2
            ent.ecap = cap
            ent.jvlo = ent.jvhi = ent.jelo = ent.jehi = None
            ent.vis_rows = ent.em_rows = 0
            ent.ords = {}
            ent.keycols = {}
        epoch = state.mark_log_epoch
        stamp = (state.rows_inserted, state.rows_marked, state.vis_epoch)
        if ent.jvlo is None:
            lo, hi = split_words(state.vis.data[:n])
            ent.jvlo = self._upload(lo, ent.ecap)
            ent.jvhi = self._upload(hi, ent.ecap)
            ent.vis_rows = n
            ent.mark_sync = (epoch, state.mark_log.n)
            ent.vis_stamp = stamp
        elif ent.vis_stamp != stamp:
            se, sp = ent.mark_sync
            if se != epoch or ent.vis_stamp[2] != stamp[2]:
                # mark-log compaction or a detach bit-clear: regather once
                lo, hi = split_words(state.vis.data[:n])
                ent.jvlo = self._upload(lo, ent.ecap)
                ent.jvhi = self._upload(hi, ent.ecap)
                ent.vis_rows = n
                if ent.jelo is not None:
                    lo, hi = split_words(state.emask.data[:n])
                    ent.jelo = self._upload(lo, ent.ecap)
                    ent.jehi = self._upload(hi, ent.ecap)
                    ent.em_rows = n
                self.mirror_full_regathers += 1
            else:
                ids = state.mark_log.data[sp:]
                if len(ids):
                    ids = np.unique(ids)
                    vm = ids[ids < ent.vis_rows]
                    if len(vm):
                        lo, hi = split_words(state.vis.data[vm])
                        self._patch(ent.jvlo, vm, lo)
                        self._patch(ent.jvhi, vm, hi)
                        self.mirror_patched_rows += len(vm)
                    if ent.jelo is not None:
                        em = ids[ids < ent.em_rows]
                        if len(em):
                            lo, hi = split_words(state.emask.data[em])
                            self._patch(ent.jelo, em, lo)
                            self._patch(ent.jehi, em, hi)
                if ent.vis_rows < n:
                    idx = np.arange(ent.vis_rows, n, dtype=np.int64)
                    lo, hi = split_words(state.vis.data[ent.vis_rows : n])
                    self._patch(ent.jvlo, idx, lo)
                    self._patch(ent.jvhi, idx, hi)
                    ent.vis_rows = n
                if ent.jelo is not None and ent.em_rows < n:
                    idx = np.arange(ent.em_rows, n, dtype=np.int64)
                    lo, hi = split_words(state.emask.data[ent.em_rows : n])
                    self._patch(ent.jelo, idx, lo)
                    self._patch(ent.jehi, idx, hi)
                    ent.em_rows = n
            ent.mark_sync = (epoch, state.mark_log.n)
            ent.vis_stamp = stamp
        if need_em and ent.jelo is None:
            lo, hi = split_words(state.emask.data[:n])
            ent.jelo = self._upload(lo, ent.ecap)
            ent.jehi = self._upload(hi, ent.ecap)
            ent.em_rows = n
        for a in ord_attrs:
            rec = ent.ords.get(a)
            if rec is None:
                h, lo = total_order_u32(state.cols[a].data[:n])
                ent.ords[a] = [self._upload(h, ent.ecap), self._upload(lo, ent.ecap), n]
            elif rec[2] < n:
                h, lo = total_order_u32(state.cols[a].data[rec[2] : n])
                idx = np.arange(rec[2], n, dtype=np.int64)
                self._patch(rec[0], idx, h)
                self._patch(rec[1], idx, lo)
                rec[2] = n
        for a in key_attrs:
            if a in ent.badkeys:
                continue
            rec = ent.keycols.get(a)
            start = rec[1] if rec is not None else 0
            if start >= n:
                continue
            vals = state.cols[a].data[start:n]
            with np.errstate(invalid="ignore"):
                # truncate exactly like encode_keys' int64 cast; NaN/inf
                # truncate to INT64_MIN, caught by the range check below
                iv = vals.astype(np.int64)
            if len(iv) and (iv.min() < 0 or iv.max() > self._KEY_LIMIT):
                ent.badkeys.add(a)
                ent.keycols.pop(a, None)
                continue
            i32 = iv.astype(np.int32)
            if rec is None:
                ent.keycols[a] = [self._upload(i32, ent.ecap), n]
            else:
                idx = np.arange(start, n, dtype=np.int64)
                self._patch(rec[0], idx, i32)
                rec[1] = n
        if tr is not None:
            tr.close(span)

    def _table_for(self, state) -> Optional[Tuple[object, object, np.ndarray]]:
        """Open-addressing probe table over the state's SoA keycodes, cached
        per state and grown incrementally: when the state gains entries,
        only the new keys are inserted (full rebuild only when the table
        must double), so aggregate build cost stays amortized O(n) instead
        of O(n^2/morsel). Unservable states (duplicate keys, out-of-range
        keycodes, over-long clusters) are marked bad once and fall back to
        the reference probe forever."""
        n = state.keycode.n
        ent = self._tables.get(state)
        if ent is None:
            self._forget_evicted()
            ent = _ProbeTable()
            self._tables[state] = ent
        if ent.bad:
            return None
        if ent.n < n:
            tr = _trace.active
            if tr is not None:
                span = tr.open("backend.table", n - ent.n)
            self._insert_keys(ent, state.keycode.data, n)
            if tr is not None:
                tr.close(span)
            if ent.bad:
                return None
        return ent.jkeys, ent.jones, ent.slot_entry

    def _forget_evicted(self) -> None:
        """Drop the tables of evicted states. No lens observes an evicted
        state again, but a completed query's handle keeps its attached
        states alive, and with them their tables on the card, until the
        session goes: under ``memory_budget=0`` every retirement evicts, so
        the tables would pile up query by query. Swept before each new
        table, so the tables on the card never outnumber the live states
        and those evicted since the last new table."""
        for state in [s for s in self._tables.keys() if s.evicted]:
            del self._tables[state]

    def _insert_keys(self, ent: "_ProbeTable", keys, n: int) -> None:
        """Insert keys[ent.n:n] into the table, rebuilding at a larger
        capacity when the 50% load factor would be exceeded. Insertion is
        one batched winner-election pass (or the batch-insert kernel on
        full rebuilds when ``use_insert_kernel`` is set) — never a per-key
        Python loop. Rebuilds reassign table slots but leave the
        entry-indexed mirrors untouched (they are keyed by entry id, not
        slot — the §13 incremental-maintenance invariant). After a host
        insert the whole table is uploaded again; a kernel rebuild leaves
        it on the device and copies it to the host."""
        new = keys[ent.n : n]
        if len(new) and (new.min() < 0 or new.max() > self._KEY_LIMIT):
            ent.bad = True
            return
        rebuild = ent.tkeys is None or 2 * n > len(ent.tkeys)
        on_device = rebuild and self.use_insert_kernel
        if rebuild:
            cap = 1
            while cap < 2 * n:
                cap *= 2
        if on_device:
            ok = self._kernel_rebuild(ent, keys[:n], cap)
        elif rebuild:
            ent.tkeys = np.full(cap, EMPTY, dtype=np.int32)
            ent.slot_entry = np.full(cap, -1, dtype=np.int64)
            ok = self._batch_insert(ent, keys[:n], 0)
        else:
            ok = self._batch_insert(ent, keys[ent.n : n], ent.n)
        if not ok:
            ent.bad = True
            return
        ent.n = n
        if not on_device:
            ent.jkeys = self._to_dev(ent.tkeys)
            ent.jentry = self._to_dev(ent.slot_entry.astype(np.int32))
        if ent.jones is None or ent.jones.shape[0] != len(ent.tkeys):
            ent.jones = torch.ones(len(ent.tkeys), dtype=torch.int32, device=self.device)

    @staticmethod
    def _batch_insert(ent: "_ProbeTable", seg, base: int) -> bool:
        """Vectorized linear-probe insertion of ``seg`` (entry indices
        ``base + i``): each round, every unplaced key inspects its current
        slot; per empty slot the lowest-ranked contender wins, everyone
        else advances. Returns False on duplicate keys (multi-match state)
        or a probe chain exceeding the kernel's bounded scan."""
        if len(seg) == 0:
            return True
        tkeys, slot_entry = ent.tkeys, ent.slot_entry
        mask = len(tkeys) - 1
        seg32 = np.asarray(seg, dtype=np.int32)
        pos = ((seg.astype(np.uint32) * np.uint32(MULT)).astype(np.int32)) & mask
        hops = np.zeros(len(seg), dtype=np.int64)
        pending = np.arange(len(seg), dtype=np.int64)
        while len(pending):
            p = pos[pending]
            cur = tkeys[p]
            if (cur == seg32[pending]).any():
                return False  # duplicate key: multi-match state
            free = cur == EMPTY
            won = np.zeros(len(pending), dtype=bool)
            if free.any():
                cand = np.flatnonzero(free)
                slots = p[cand]
                so = np.argsort(slots, kind="stable")
                firsts = np.ones(len(so), dtype=bool)
                firsts[1:] = slots[so][1:] != slots[so][:-1]
                winners = cand[so[firsts]]
                wp = p[winners]
                tkeys[wp] = seg32[pending[winners]]
                slot_entry[wp] = base + pending[winners]
                won[winners] = True
                # a same-batch duplicate that contended for the same slot
                # never revisits it — re-read after the winners' writes so
                # in-batch duplicate keys are caught, not silently placed
                lost = free & ~won
                if lost.any() and (tkeys[p[lost]] == seg32[pending[lost]]).any():
                    return False  # duplicate key within the batch
            rest = ~won
            if not rest.any():
                break
            pr = pending[rest]
            pos[pr] = (p[rest] + 1) & mask
            hops[pr] += 1
            if hops[pr].max() >= MAX_PROBE:
                return False  # cluster exceeds the kernel's bounded probe
            pending = pr
        return True

    def _kernel_rebuild(self, ent: "_ProbeTable", keys, cap: int) -> bool:
        """Full-table rebuild through the batch-insert kernel: the table
        stays on the device as the probe mirror, with a host copy for
        later incremental inserts and the slot -> entry map."""
        tkeys, tentry, ok = hash_build_insert(self._to_dev(keys), cap)
        tr = _trace.active
        if tr is not None:
            span = tr.open("backend.wait")
            tr.d2h(4)
        ok = int(ok[0]) != 0
        if ok:
            ent.jkeys, ent.jentry = tkeys, tentry
            ent.tkeys = tkeys.to("cpu", copy=True).numpy()
            ent.slot_entry = tentry.cpu().numpy().astype(np.int64)
            if tr is not None:
                tr.d2h(4 * (tkeys.numel() + tentry.numel()))
        if tr is not None:
            tr.close(span)
        return ok

    # -- segmented aggregation ------------------------------------------------
    def segment_sum(self, gids, values, n_groups):
        tr = _trace.active
        if tr is not None:
            span = tr.open("backend.segment_sum", len(gids))
        try:
            if n_groups == 0 or len(gids) == 0:
                return np.zeros(n_groups, dtype=np.float64)
            if not self.use_agg_kernel or n_groups > self.max_kernel_groups:
                return self._ref.segment_sum(gids, values, n_groups)
            vals = (
                np.ones((len(gids), 1), dtype=np.float32)
                if values is None
                else np.asarray(values, dtype=np.float64).astype(np.float32).reshape(-1, 1)
            )
            if tr is not None:
                tr.h2d(vals.nbytes)
            out = seg_aggregate(
                self._to_dev(gids), torch.from_numpy(vals).to(self.device), n_groups
            )
            if tr is not None:
                wait = tr.open("backend.wait")
                tr.d2h(4 * out.numel())
            out = out.cpu()
            if tr is not None:
                tr.close(wait)
            return out.numpy().astype(np.float64)[:, 0]
        finally:
            if tr is not None:
                tr.close(span)


def resolve_backend(spec, device: str = "cuda") -> ExecutionBackend:
    """Accept a backend name or instance (EngineConfig.backend); a named
    ``"torch"`` backend is built on ``device``."""
    if isinstance(spec, str):
        if spec == "reference":
            return ReferenceBackend()
        if spec == "torch":
            return TorchBackend(device=device)
        raise ValueError(f"unknown backend {spec!r}")
    if not isinstance(spec, ExecutionBackend):
        raise TypeError(f"backend must implement ExecutionBackend, got {spec!r}")
    return spec
