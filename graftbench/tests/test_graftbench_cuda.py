"""On the card: one short run of a cell through the command itself."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_short_run_on_the_card_is_correct():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "-m", "graftbench.run", "--workload", "sf1-closed1", "--seed", "5",
         "--seconds", "5", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=600, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
