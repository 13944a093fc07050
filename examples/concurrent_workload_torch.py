"""Concurrent analytical workload on the PyTorch/CUDA port: 16 closed-loop
clients over the default Zipf template mix, comparing Isolated /
QPipe-OSP / GraftDB on identical per-client sequences (paper §6.3 shape).

  PYTHONPATH=src python examples/concurrent_workload_torch.py [--device cpu] [--backend reference]

The twin of ``examples/concurrent_workload.py``: the same instance (TPC-H
SF 0.05), the same ``client_sequences(db, 16, 10, seed=3)``, the same grid
(isolated, qpipe_osp, graft, graft on 4 workers x 8 partitions) and the
same printed lines, through ``repro_torch.launch.workload`` on
``graftdb_torch``, on the CUDA card unless ``--device cpu``.

Which numbers it prints depends on ``--backend``. The reference example
runs the reference's default backend, its NumPy engine, and so does this
twin with ``--backend reference``: then it prints the reference example's
lines exactly. The default, ``--backend torch``, runs the kernel path
(the fused stage chain, B1, and the probes B2-B4), whose virtual clock
equals the reference's own kernel path (``backend="pallas"``), not its
NumPy engine's. The isolated and QPipe-OSP lines are the same on both;
the graft lines differ a little (0.22% of the clock at this size), since
a kernel backend probes a one-member stage through the visibility-fused
lens, which charges only the visible matches, and a closed loop's next
arrivals follow the clock.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.workload import client_sequences, get_db, run_closed_loop  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="torch", choices=("torch", "reference"))
    args = ap.parse_args(argv)

    db = get_db(0.05)
    seqs = client_sequences(db, n_clients=16, n_per=10, seed=3)
    base = None
    grid = [("isolated", 1, 1), ("qpipe_osp", 1, 1), ("graft", 1, 1), ("graft", 4, 8)]
    for mode, workers, partitions in grid:
        r = run_closed_loop(db, mode, seqs, workers=workers, partitions=partitions,
                            device=args.device, backend=args.backend)
        if base is None:
            base = r["throughput_qph"]
        label = mode if workers == 1 else f"{mode} {workers}w×{partitions}p"
        print(
            f"{label:16s} throughput {r['throughput_qph']:9.0f} q/h "
            f"({r['throughput_qph']/base:4.2f}x) median latency {r['median_latency_s']:6.3f}s "
            f"p95 {r['p95_latency_s']:6.3f}s"
        )


if __name__ == "__main__":
    main()
