"""``examples/concurrent_workload_torch.py`` against
``examples/concurrent_workload.py``: each run in a fresh process (query
ids come from a per-process counter), the twin with ``--device cpu
--backend reference``, the NumPy engine that the reference example runs
by default. Their four lines are equal, exactly: the numbers printed are
the virtual clock's, equal in both packages on that engine. (With its
default backend the twin prints the reference's kernel-path numbers,
which ``tests/test_torch_closed_loop.py`` holds.)"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, *args], env=env, capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def test_concurrent_workload_twin_prints_the_reference_lines():
    want = _run("examples/concurrent_workload.py")
    got = _run("examples/concurrent_workload_torch.py", "--device", "cpu", "--backend", "reference")
    assert got == want
    assert [line.split(" throughput")[0].strip() for line in got] == [
        "isolated", "qpipe_osp", "graft", "graft 4w×8p"]
