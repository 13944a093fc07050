"""``examples/quickstart_torch.py`` against ``examples/quickstart.py``:
each run in a fresh process (query ids come from a per-process counter),
the twin with ``--device cpu``; their outputs equal line for line (the
times printed are the virtual clock's, equal in both packages), and the
twin's result matches the reference executor."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, *args], env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def test_quickstart_twin_prints_the_reference_lines():
    want = _run("examples/quickstart.py")
    got = _run("examples/quickstart_torch.py", "--device", "cpu")
    assert got == want
    assert "Q_B result matches reference executor: True" in got
    assert any(line.startswith("EXPLAIN GRAFT") for line in got)
