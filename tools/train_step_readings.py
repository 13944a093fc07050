#!/usr/bin/env python3
"""Every measure of ``tests/test_torch_cuda.py::test_cuda_train_step_matches_cpu``
beside its limit, for each of the test's cases: one train step of each
architecture's reduced config on the card against the CPU.

    python3 tools/train_step_readings.py

The test asserts and shows its measures only when one exceeds its limit;
this prints them all, one JSON line per case, and writes them to
``chiprun_out/train_step_readings.json``. Needs a CUDA card.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import torch  # noqa: E402

import test_torch_cuda as TC  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("train_step_readings: no CUDA card is visible", file=sys.stderr)
        return 2
    rows = {}
    for arch, n_microbatches in TC.TRAIN_STEP_CASES:
        measured, limits = TC.train_step_card_vs_cpu(torch.device("cuda"), arch, n_microbatches)
        rows[f"{arch} x{n_microbatches}"] = row = {
            "measured": measured, "limits": limits,
            "within": all(measured[k] <= limits[k] for k in limits)}
        print(json.dumps({"case": f"{arch} x{n_microbatches}", **row}), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_step_readings.json").write_text(json.dumps(rows, indent=1))
    return 0 if all(r["within"] for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
