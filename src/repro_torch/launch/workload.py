"""Closed-loop concurrent workload (paper §6.3) on the port.

The port's own copy of the helpers that the reference's
``benchmarks/common.py`` gives its closed-loop example: the instance
(``get_db``), the one place a run opens its engine (``open_session``),
identical per-client query sequences (``client_sequences``) and the
closed loop itself (``run_closed_loop``). Each system runs on identical
per-client ``(template, params)`` sequences; the loop keeps one query
outstanding per client and submits the client's next one at each
completion.

Two keywords reach ``EngineConfig`` beside the reference's: ``device``
(default ``"cuda"``, as at every entry point of the port) and
``backend`` (default ``"torch"``). ``backend="reference"`` runs the
NumPy engine, which gives the reference helpers' numbers bit for bit;
the default runs the kernel path, whose virtual clock equals the
reference's with ``backend="pallas"``. The two clocks differ in graft
mode. A kernel backend probes a stage that serves one member without
grants through the visibility-fused lens (``probe_visible``, or inside
the fused chain), so the modeled match cost counts only the visible
matches; the NumPy engine has no such probe, so it counts every key
match and charges the visibility translation (``fused_vis_rows``)
instead. The kernel path also counts the chain's declines by reason
(``fallback_probes_*``). A closed loop submits each next query at
``session.now``, so a different clock changes the interleaving, and
every counter after it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..api import EngineConfig, Session, connect
from ..relational import queries, tpch

DEFAULT_SF = 0.05
MORSEL = 16384


def get_db(sf: float = DEFAULT_SF):
    return tpch.get_database(sf)


def open_session(
    db, mode: str, wall: bool = False, workers: int = 1, partitions: int = 1,
    device: str = "cuda", backend: str = "torch", **extra,
) -> Session:
    """The engine of one run: ``MORSEL``-row morsels, the work clock (or
    the wall clock with ``wall``), ``workers`` x ``partitions``, on
    ``device`` with ``backend``; ``extra`` passes further ``EngineConfig``
    fields through. ``device="cuda"`` without a card raises, whatever the
    backend: no run falls back to the CPU unasked."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the closed loop on device='cuda' needs a CUDA card and none is "
            "visible; pass device='cpu'"
        )
    return connect(
        db,
        EngineConfig(
            mode=mode,
            morsel_size=MORSEL,
            clock="wall" if wall else "work",
            workers=workers,
            partitions=partitions,
            device=device,
            backend=backend,
            **extra,
        ),
    )


def client_sequences(db, n_clients: int, n_per: int, seed: int, zipf_alpha: float = 1.0):
    """Identical per-client query-instance sequences across systems: a list
    of (template, params) per client (plans are rebuilt per run so query ids
    stay unique)."""
    seqs = []
    for c in range(n_clients):
        rng = np.random.default_rng(seed * 10_000 + c)
        seq = []
        for _ in range(n_per):
            q = queries.sample_query(db, rng, zipf_alpha=zipf_alpha)
            seq.append((q.template, q.params))
        seqs.append(seq)
    return seqs


def run_closed_loop(
    db, mode: str, seqs, wall: bool = False, workers: int = 1, partitions: int = 1,
    device: str = "cuda", backend: str = "torch", keep_results: bool = False,
) -> Dict:
    """Closed loop: each client has one outstanding query; submits the next
    on completion (paper §6.3). Returns throughput/latency/counters, and
    with ``keep_results`` also ``results``: ``(template, params, result)``
    of each completed query under its ``(client, position)`` (query ids
    come from a per-process counter, so runs compare by position)."""
    session = open_session(db, mode, wall=wall, workers=workers, partitions=partitions,
                           device=device, backend=backend)
    idx = {c: 0 for c in range(len(seqs))}
    owner: Dict[int, int] = {}
    slot: Dict[int, Tuple[int, int]] = {}
    for c, seq in enumerate(seqs):
        t, p = seq[0]
        q = queries.make_query(db, t, p, arrival=0.0)
        idx[c] = 1
        owner[q.qid] = c
        slot[q.qid] = (c, 0)
        session.submit(q)

    def on_complete(fut):
        c = owner.pop(fut.qid, None)
        if c is None or idx[c] >= len(seqs[c]):
            return None
        t, p = seqs[c][idx[c]]
        q = queries.make_query(db, t, p, arrival=session.now)
        owner[q.qid] = c
        slot[q.qid] = (c, idx[c])
        idx[c] += 1
        return q

    done = session.run(on_complete=on_complete)
    elapsed = session.now
    lats = np.array([f.latency() for f in done])
    out = {
        "mode": mode,
        "completed": len(done),
        "elapsed_s": elapsed,
        "throughput_qph": len(done) / elapsed * 3600 if elapsed > 0 else 0.0,
        "median_latency_s": float(np.median(lats)),
        "p95_latency_s": float(np.percentile(lats, 95)),
        "latencies": lats.tolist(),
        "counters": {k: float(v) for k, v in session.counters.items()},
    }
    if keep_results:
        results: Dict[Tuple[int, int], Tuple[str, Dict, Dict]] = {}
        for f in done:
            results[slot[f.qid]] = (f.query.template, f.query.params, f.result())
        out["results"] = results
    session.close()  # release retained state before the next sweep point
    return out
