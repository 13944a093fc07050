"""Serving with dynamic folding over shared KV-prefix state on the
PyTorch/CUDA port — the paper's mechanism (represented / residual /
unattached extents, per-request lenses, retention) transferred to LM
serving (DESIGN.md §6).

Workload: 32 requests sharing one of 4 system prompts (1024 tokens) with
unique 64-token user suffixes, Poisson-ish arrivals.

  PYTHONPATH=src python examples/serve_folding_torch.py [--device cpu]

The twin of ``examples/serve_folding.py``: the same workload and printed
lines, on ``graftdb_torch.connect_serving``. The serving plane is a host
simulator in both packages (virtual time, no model), so it launches no
kernel; ``--device`` names the device the port's entry points take
(the CUDA card unless ``--device cpu``) and is checked, so that the
command fails where it would fail beside the quickstart twin.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import graftdb_torch  # noqa: E402
from repro_torch.models.model import resolve_device  # noqa: E402
from repro_torch.serve.folding import Request  # noqa: E402


def workload(n=32, n_prompts=4, prefix=1024, suffix=64, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [tuple(rng.integers(0, 32000, prefix).tolist()) for _ in range(n_prompts)]
    reqs = []
    t = 0.0
    for i in range(n):
        t += float(rng.exponential(0.05))
        p = prompts[int(rng.integers(0, n_prompts))]
        reqs.append(Request(i, p + tuple(rng.integers(0, 32000, suffix).tolist()), 32, arrival=t))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    for fold in (False, True):
        session = graftdb_torch.connect_serving(fold=fold)
        futures = session.submit_all(workload())
        res = session.run()
        mode = "folding " if fold else "isolated"
        tok = res["prefill_tokens"]
        print(
            f"{mode}: elapsed {res['elapsed']:6.2f}s mean latency {res['mean_latency']:5.2f}s "
            f"p95 {res['p95_latency']:5.2f}s | prefill tokens computed {tok.get('computed', 0):,}"
            + (
                f" (represented {tok['represented']:,}, residual {tok['residual']:,},"
                f" ordinary {tok['ordinary']:,})"
                if fold
                else ""
            )
        )
        if fold:
            r = futures[-1].result()
            print(
                f"  last request extents: represented {r['represented_tokens']}, "
                f"residual {r['residual_tokens']}, ordinary {r['ordinary_tokens']}"
            )


if __name__ == "__main__":
    main()
