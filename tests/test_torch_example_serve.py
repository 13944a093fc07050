"""``examples/serve_folding_torch.py`` against ``examples/serve_folding.py``:
each run in a fresh process, the twin with ``--device cpu``; their
outputs equal line for line (the serving plane's times are virtual,
equal in both packages). The serving plane is a host simulator, so the
twin launches no kernel."""

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


def test_serve_folding_twin_prints_the_reference_lines():
    want = _run("examples/serve_folding.py")
    got = _run("examples/serve_folding_torch.py", "--device", "cpu")
    assert got == want
    assert got[0].startswith("isolated:") and got[1].startswith("folding :")
    assert "represented 1024" in got[2]


def test_serve_folding_twin_launches_no_kernel(capsys):
    import importlib.util

    import torch

    from repro_torch.kernels import _build

    spec = importlib.util.spec_from_file_location(
        "serve_folding_torch", ROOT / "examples" / "serve_folding_torch.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    _build.reset_launch_counts()
    twin.main(["--device", "cpu"])
    assert not any(_build.launch_counts().values())
    assert "folding :" in capsys.readouterr().out
    if not torch.cuda.is_available():
        try:
            twin.main([])
        except RuntimeError as e:
            assert "CUDA card" in str(e)
        else:
            raise AssertionError("the twin ran without a card under its default device")
