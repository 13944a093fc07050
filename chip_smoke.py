#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of GraftDB on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It imports nothing of JAX and nothing of
the reference package (``repro``/``graftdb``); it puts ``src`` on the path
itself and drives ``graftdb_torch``. Phases:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels at SF-1 shapes: each kernel against its plain PyTorch version
   on the card (N = 65,536 probe keys into the orders-state table:
   1.5 M entries, 2^22 slots); outputs are integers, so equality is exact;
4. main path: ``graftdb_torch.connect`` at TPC-H SF 1 with the default
   config (torch backend on the card, 65,536-row morsels), 12 sampled
   queries with staggered arrivals, in graft mode, isolated mode, and
   graft mode through the per-member loops; every result is checked
   against the port's reference executor, and every kernel must have
   launched. The largest launch of each kernel is recorded and replayed
   against its plain version, and timed;
5. twin: the same workload at SF 0.1 on the card and on the CPU (plain
   versions) must give identical results, counters and virtual clocks.

Any failure exits non-zero. The line before the last is a JSON object
with each kernel's launches, error, time, plain time and bound; the last
line is ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out"

#: the main path's TPC-H scale factor, the twin leg's, the number of
#: sampled queries and the seed of data and workload
SCALE = 1.0
TWIN_SCALE = 0.1
N_QUERIES = 12
SEED = 7

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bandwidth, and the
#: CUDA-core float32 rate, used as the ALU rate of 32-bit integer work
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

KERNELS = {
    "fused_chain": ("src/repro_torch/kernels/csrc/fused_chain.cu",
                    "src/repro/kernels/fused_chain.py:163"),
    "hash_probe_lens64": ("src/repro_torch/kernels/csrc/hash_probe.cu",
                          "src/repro/kernels/hash_probe.py:171"),
    "hash_probe_lens_multi64": ("src/repro_torch/kernels/csrc/hash_probe.cu",
                                "src/repro/kernels/hash_probe.py:242"),
    "hash_probe_lens": ("src/repro_torch/kernels/csrc/hash_probe.cu",
                        "src/repro/kernels/hash_probe.py:50"),
}


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, iters):
    """Mean milliseconds of ``fn`` over ``iters`` calls, CUDA events, after
    warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def probe_touch(keys, tkeys):
    """What a bounded linear probe of ``keys`` must read: the distinct
    table slots it visits, the found slot per key (-1 on a miss) and the
    number of probe steps taken."""
    import torch

    from repro_torch.kernels.hash_probe import EMPTY, MAX_PROBE, _hash

    cap = tkeys.shape[0]
    keys64 = keys.to(torch.int64)
    pos = _hash(keys, cap)
    done = keys64 == EMPTY
    found = torch.full_like(keys64, -1)
    seen, steps = [], 0
    for _ in range(MAX_PROBE):
        live = ~done
        seen.append(pos[live])
        steps += int(live.sum())
        sk = tkeys[pos]
        hit = (sk == keys64) & live
        found = torch.where(hit, pos, found)
        done = done | hit | ((sk == EMPTY) & live)
        pos = (pos + 1) & (cap - 1)
    return int(torch.unique(torch.cat(seen)).numel()), found, steps


def bound(nbytes, ops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ALU_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def probe_bound(name, args):
    """Bytes a probe needs on these inputs: each key read and each output
    written once, each visited slot's key once, and the slot->entry id and
    lens words of each distinct matched entry once."""
    import torch

    keys, tkeys = args[0], args[1]
    n = keys.shape[0]
    slots, found, steps = probe_touch(keys, tkeys)
    hit = found[found >= 0]
    n_hit = int(torch.unique(hit).numel())
    nbytes = 4 * n + 4 * slots
    if name == "hash_probe_lens":
        nbytes += 4 * n_hit + 4 + 4 * n  # slot vis words, mask, slots out
    else:
        entries = args[2][hit].to(torch.int64)
        n_ent = int(torch.unique(entries).numel())
        nbytes += 4 * n_hit + 8 * n_ent
        nbytes += 8 + 4 * n if name == "hash_probe_lens64" else 12 * n
    return bound(nbytes, 4 * steps + 4 * n)


def chain_bound(spec, arrays, flat):
    """Bytes one chain launch needs: every row-length input and every
    output once, small parameter arrays whole, and of each table and
    entry-indexed mirror only what this launch's rows reach — the slots
    its probes visit and the entries they match. Rows reaching stage s > 0
    are taken as those matched at stage s-1 (a superset of the rows still
    owned there)."""
    import torch

    from repro_torch.kernels import fused_chain as fc

    stages, sink = spec
    n = arrays[0].shape[0]
    out = fc.split_outputs(spec, n, flat)
    kinds = fc.input_kinds(spec)
    nbytes = sum(4 * a.numel() for a, k in zip(arrays, kinds) if k == "row")
    nbytes += 4 * flat.numel()
    bl, bh, per_stage, sink_tabs = fc._unpack(spec, arrays)
    alive = (bl | bh) != 0
    ops = 0
    for s, ((key_mode, n_grants, g_attrs, filt), d) in enumerate(zip(stages, per_stage)):
        if key_mode == -1:
            keys = torch.where(alive, d["key"], fc.EMPTY)
        else:
            e = out[2 + key_mode].to(torch.int64)
            keys = torch.where(alive & (e >= 0), d["key"][e.clamp(min=0)], fc.EMPTY)
            nbytes += 4 * int(torch.unique(e[e >= 0]).numel())
        slots, _, steps = probe_touch(keys.to(torch.int32), d["tkeys"])
        ent = out[2 + s].to(torch.int64)
        n_ent = int(torch.unique(ent[ent >= 0]).numel())
        entry_arrays = 3 + (2 + 2 * g_attrs if n_grants else 0)  # tentry, lens, grants
        nbytes += 4 * slots + 4 * n_ent * entry_arrays
        small = [d["ttlo"], d["tthi"]]
        if n_grants:
            small += [d[k] for k in ("gbit", "gallow", "gcon", "glo", "ghi")]
        if filt is not None:
            small += [d[k] for k in ("flo", "fhi", "fcon", "fbit")]
            nbytes += 8 * n_ent * sum(1 for src in filt[1] if src != -1)
        nbytes += sum(4 * a.numel() for a in small)
        ops += 4 * steps + n * (24 + 8 * n_grants * max(g_attrs, 1))
        alive = ent >= 0
    if sink:
        nbytes += sum(4 * a.numel() for a in sink_tabs)
    return bound(nbytes, ops)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def pow2_at_least(x, lo=1):
    c = lo
    while c < x:
        c *= 2
    return c


def orders_table(db):
    """The orders-state probe table as the torch backend lays it out: the
    SF's order keys placed by the backend's own winner election at <= 50%
    load, entry-indexed lens words padded to a power of two."""
    from repro_torch.api.backends import TorchBackend, _ProbeTable
    from repro_torch.kernels.hash_probe import EMPTY

    keys = db["orders"].columns["o_orderkey"].astype(np.int64)
    ent = _ProbeTable()
    cap = pow2_at_least(2 * len(keys))
    ent.tkeys = np.full(cap, EMPTY, dtype=np.int32)
    ent.slot_entry = np.full(cap, -1, dtype=np.int64)
    if not TorchBackend._batch_insert(ent, keys, 0):
        raise RuntimeError("orders keys do not fit the bounded probe table")
    return keys, ent.tkeys, ent.slot_entry.astype(np.int32), pow2_at_least(len(keys), 256)


def kernel_inputs(db, n_probe=65_536, seed=0):
    """SF-shaped inputs of every kernel: probe keys (half hits) against the
    orders table, entry-indexed lens words with a few live slots, and a
    two-stage chain with grants, filters and a build sink."""
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    keys, tkeys, tentry, ecap = orders_table(db)
    e = len(keys)
    slots = rng.integers(0, 64, (e, 3), dtype=np.uint64)
    words = np.zeros(ecap, np.uint64)
    words[:e] = np.bitwise_or.reduce(np.uint64(1) << slots, axis=1)
    evlo = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    evhi = (words >> np.uint64(32)).astype(np.uint32).view(np.int32)
    probe = np.where(
        rng.random(n_probe) < 0.5, keys[rng.integers(0, e, n_probe)],
        int(keys.max()) + 1 + rng.integers(0, 1 << 20, n_probe),
    ).astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    k, tk, te, lo, hi = t(probe), t(tkeys), t(tentry), t(evlo), t(evhi)
    ones = torch.ones_like(tk)
    all_mask = torch.full((1,), -1, dtype=torch.int32, device=dev)
    lens_mask = t(np.array([1 << 5, 1 << 7], np.uint32).view(np.int32))

    # chain: stage 0 probes host keys into the orders table; stage 1
    # gathers keys through stage 0's entries into a second table
    def w(*shape):
        return t(rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32))

    def enc(vals):
        from repro_torch.kernels.fused_chain import total_order_u32

        hi_, lo_ = total_order_u32(vals)
        return t(hi_.view(np.int32)), t(lo_.view(np.int32))

    def bounds(shape):
        from repro_torch.kernels.fused_chain import total_order_u32

        vals = np.sort(rng.normal(size=shape + (2,)), axis=-1)
        lh, ll = total_order_u32(vals[..., 0].ravel())
        hh, hl = total_order_u32(vals[..., 1].ravel())
        lo_ = np.stack([lh, ll], -1).reshape(*shape, 2)
        hi_ = np.stack([hh, hl], -1).reshape(*shape, 2)
        return t(lo_.view(np.int32)), t(hi_.view(np.int32))

    bits_lo, bits_hi = w(n_probe), w(n_probe)
    ck = torch.from_numpy(keys[rng.integers(0, e, ecap)].astype(np.int32)).to(dev)
    arrays = [bits_lo, bits_hi]
    stages = []
    for s in range(2):
        arrays += [k if s == 0 else ck, tk, te, lo, hi, w(8, 256), w(8, 256)]
        glo, ghi = bounds((2, 2))
        arrays += [lo, hi, w(2, 2), w(2, 2), t(rng.integers(0, 2, (2, 2)).astype(np.int32)), glo, ghi]
        arrays += list(enc(rng.normal(size=ecap))) * 2
        srcs = (-1, s)
        arrays += list(enc(rng.normal(size=n_probe))) + list(enc(rng.normal(size=ecap)))
        flo, fhi = bounds((4, 2))
        arrays += [flo, fhi, t(rng.integers(0, 2, (4, 2)).astype(np.int32)), w(4, 2)]
        stages.append((-1 if s == 0 else 0, 2, 2, (4, srcs)))
    arrays += [w(8, 256) for _ in range(4)]
    rich = ((tuple(stages), True), arrays)
    # the main pipeline's shape: one grant-free stage, no filter, no sink
    plain_spec = (((-1, 0, 0, None),), False)
    simple = (plain_spec, [bits_lo, bits_hi, k, tk, te, lo, hi, arrays[7], arrays[8]])
    return {
        "hash_probe_lens": (k, tk, ones, all_mask),
        "hash_probe_lens64": (k, tk, te, lo, hi, lens_mask),
        "hash_probe_lens_multi64": (k, tk, te, lo, hi),
        "fused_chain": simple,
        "fused_chain_rich": rich,
    }


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------


def kernel_pair(name):
    from repro_torch.kernels import fused_chain as fc
    from repro_torch.kernels import hash_probe as hp

    if name.startswith("fused_chain"):
        return (lambda spec, arrays: fc.chain_launch(spec, arrays),
                lambda spec, arrays: fc.chain_plain(spec, arrays))
    return getattr(hp, name), getattr(hp, name + "_plain")


def compare(name, args, timed=True, iters=20):
    """Run a kernel and its plain version on the same card inputs; require
    exact equality; return error, times and bound."""
    import torch

    kern, plain = kernel_pair(name)
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w_ in zip(got, want):
        if g.shape != w_.shape:
            raise AssertionError(f"{name}: shape {tuple(g.shape)} != plain {tuple(w_.shape)}")
        err = max(err, int((g.to(torch.int64) - w_.to(torch.int64)).abs().max()) if g.numel() else 0)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain version (max abs {err})")
    rec = {"max_abs_err": float(err)}
    if timed:
        rec["ms"] = time_ms(lambda: kern(*args), iters)
        rec["plain_ms"] = time_ms(lambda: plain(*args), max(2, iters // 4))
        if name.startswith("fused_chain"):
            rec["bound_ms"], rec["bound_by"] = chain_bound(args[0], args[1], got[0])
        else:
            rec["bound_ms"], rec["bound_by"] = probe_bound(name, args)
    return rec


class Recorder:
    """Keeps the largest call of each kernel wrapper that the backend
    makes, so the main path's own inputs can be replayed after the legs.
    The inputs are kept by reference, not copied, so the legs' wall times
    carry no recording cost: the replay sees that call's shapes and keys,
    and the mirrors as the backend left them (patched in place later)."""

    def __init__(self):
        import repro_torch.api.backends as backends

        self.mod = backends
        self.calls = {}
        self.saved = {}
        for fn_name, name in (("hash_probe_lens", "hash_probe_lens"),
                              ("hash_probe_lens64", "hash_probe_lens64"),
                              ("hash_probe_lens_multi64", "hash_probe_lens_multi64"),
                              ("chain_launch", "fused_chain")):
            orig = getattr(backends, fn_name)
            self.saved[fn_name] = orig
            setattr(backends, fn_name, self._wrap(orig, name))

    def _wrap(self, orig, name):
        def call(*args):
            n = args[1][0].shape[0] if name == "fused_chain" else args[0].shape[0]
            best = self.calls.get(name)
            if best is None or n > best[0]:
                self.calls[name] = (n, (args[0], list(args[1])) if name == "fused_chain" else args)
            return orig(*args)

        return call

    def restore(self):
        for fn_name, orig in self.saved.items():
            setattr(self.mod, fn_name, orig)


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------


def workload(db, n, seed):
    from repro_torch.relational import queries

    rng = np.random.default_rng(seed)
    qs, t = [], 0.0
    for _ in range(n):
        qs.append(queries.sample_query(db, rng, arrival=t))
        t += float(rng.choice([0.0, 0.001, 0.01]))
    return qs


def run_session(db, qs, **cfg):
    import graftdb_torch
    from repro_torch.relational import queries

    session = graftdb_torch.connect(db, graftdb_torch.EngineConfig(**cfg))
    futs = session.submit_all(
        [queries.make_query(db, q.template, q.params, arrival=q.arrival) for q in qs]
    )
    t0 = time.perf_counter()
    session.run()
    wall = time.perf_counter() - t0
    return session, [f.result() for f in futs], wall


def check_results(label, results, expected):
    """Sorted-column allclose (rtol 1e-9) against the reference executor:
    same columns, same row counts, equal values."""
    for i, (got, want) in enumerate(zip(results, expected)):
        if set(got) != set(want):
            raise AssertionError(f"{label}/q{i}: columns {sorted(got)} != {sorted(want)}")
        for k in want:
            a = np.sort(np.asarray(got[k], np.float64))
            b = np.sort(np.asarray(want[k], np.float64))
            if a.shape != b.shape:
                raise AssertionError(f"{label}/q{i}/{k}: shape {a.shape} vs {b.shape}")
            np.testing.assert_allclose(a, b, rtol=1e-9, err_msg=f"{label}/q{i}/{k}")


def leg_summary(session, wall):
    c = session.counters
    return {
        "wall_s": wall,
        "now_s": session.now,
        "chain_launches": int(c["kernel_chain_launches"]),
        "fallbacks": {k: int(v) for k, v in c.items() if k.startswith("fallback_probes_")},
        "backend": session.backend.stats(),
    }


def twin(db, qs, devices, **cfg):
    """The same workload on two devices must give identical runs."""
    s_gpu, r_gpu, _ = run_session(db, qs, device=devices[0], **cfg)
    s_cpu, r_cpu, _ = run_session(db, qs, device=devices[1], **cfg)
    for i, (a, b) in enumerate(zip(r_gpu, r_cpu)):
        if set(a) != set(b):
            raise AssertionError(f"twin/q{i}: columns differ")
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"twin/q{i}/{k}")
    if dict(s_gpu.counters) != dict(s_cpu.counters):
        diff = {k: (s_gpu.counters[k], s_cpu.counters.get(k)) for k in s_gpu.counters
                if s_gpu.counters[k] != s_cpu.counters.get(k)}
        raise AssertionError(f"twin: counters differ: {diff}")
    if s_gpu.backend.stats() != s_cpu.backend.stats():
        raise AssertionError("twin: backend counters differ")
    if s_gpu.now != s_cpu.now:
        raise AssertionError(f"twin: clocks differ: {s_gpu.now!r} != {s_cpu.now!r}")
    return {"now_s": s_gpu.now, "chain_launches": int(s_gpu.counters["kernel_chain_launches"])}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def q5_pair(db):
    """Two concurrent q5 queries folded in graft mode: q5's column-equality
    post-filter declines the fused chain, so their shared pipeline takes
    the staged loop, whose multi-member probes run
    ``hash_probe_lens_multi64``."""
    from repro_torch.relational import queries

    return [
        queries.make_query(db, "q5", {"region": 1.0, "date": d}, arrival=0.0)
        for d in (730.0, 800.0)
    ]


def smoke(report):
    """Phases 2-5; returns the kernels' JSON rows. Sessions of the main
    path use the default config, which is on the card."""
    from repro_torch.kernels import _build
    from repro_torch.relational import refexec, tpch

    # 2. build
    secs = _build.build()
    log(f"build: {secs:.1f} s")
    for stem, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {stem}: {line.strip()}")
    report["build"] = {"seconds": secs, "log": _build.BUILD_LOG}

    # 3. kernels at the SF's shapes, before the main path
    t0 = time.perf_counter()
    db = tpch.get_database(SCALE, seed=SEED)
    log(f"data: TPC-H SF {SCALE} in {time.perf_counter() - t0:.1f} s "
        f"({db.nbytes() / 1e6:.0f} MB, lineitem {db['lineitem'].nrows} rows)")
    inputs = kernel_inputs(db)
    synth = {}
    for kname, kin in inputs.items():
        rec = compare(kname.replace("_rich", ""), kin)
        synth[kname] = rec
        log(f"kernel {kname}: equal to plain; {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']})")
    report["kernels_sf_shapes"] = synth
    del inputs

    # 4. the main path at the full scale
    qs = workload(db, N_QUERIES, SEED)
    pair = q5_pair(db)
    log(f"workload: {[q.template for q in qs]}")
    t0 = time.perf_counter()
    expected = [refexec.execute(db, q.plan) for q in qs]
    expected_pair = [refexec.execute(db, q.plan) for q in pair]
    report["reference_executor_s"] = time.perf_counter() - t0
    log(f"reference executor: {report['reference_executor_s']:.1f} s")
    legs = (
        ("graft", dict(mode="graft"), qs, expected),
        ("isolated", dict(mode="isolated"), qs, expected),
        ("graft_per_member", dict(mode="graft", member_major=False), qs, expected),
        ("graft_q5_pair", dict(mode="graft"), pair, expected_pair),
    )
    recorder = Recorder()
    _build.reset_launch_counts()
    report["legs"] = {}
    try:
        for label, cfg, lqs, want in legs:
            session, results, wall = run_session(db, lqs, **cfg)
            check_results(label, results, want)
            summ = leg_summary(session, wall)
            report["legs"][label] = summ
            log(f"leg {label}: results == refexec; wall {wall:.2f} s, clock {session.now!r} s, "
                f"chain launches {summ['chain_launches']}, fallbacks {summ['fallbacks']}")
    finally:
        recorder.restore()
    launches = _build.launch_counts()
    log(f"launches on the main path: {launches}")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    rows = []
    for kname, (src, replaces) in KERNELS.items():
        n, kin = recorder.calls[kname]
        rec = compare(kname, kin)
        log(f"main-path replay {kname} (N={n}): equal to plain; {rec['ms']:.4f} ms "
            f"(plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']})")
        rows.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": int(launches[kname]), "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None, "n_rows": n,
        })
    report["kernels"] = rows
    del recorder, db

    # 5. twin: card and CPU give identical runs
    t0 = time.perf_counter()
    tdb = tpch.get_database(TWIN_SCALE, seed=SEED)
    tqs = workload(tdb, N_QUERIES, SEED)
    report["twin"] = {
        "graft": twin(tdb, tqs, ("cuda", "cpu"), mode="graft"),
        "graft_per_member": twin(tdb, tqs, ("cuda", "cpu"), mode="graft", member_major=False),
    }
    log(f"twin SF {TWIN_SCALE}: cuda == cpu (results, counters, clock) "
        f"in {time.perf_counter() - t0:.1f} s")
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible; this smoke run needs one", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC} does not hold the port; run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import graftdb_torch  # noqa: F401  (the facade must import)

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    report = {"device": {"name": name, "nvidia_smi": smi}}

    rows = smoke(report)

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
