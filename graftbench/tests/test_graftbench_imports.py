"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program; top-level names compared whole
(the port's name begins with the JAX package's)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in (ROOT / "graftbench").rglob("*.py")
    if "tests" not in p.parts and "." not in p.stem
)
PROBE = """
import importlib, json, sys
sys.path[:0] = [{root!r}, {src!r}]
for m in {mods!r}:
    importlib.import_module(m)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_after_import(mods):
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), mods=mods)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=300)
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_module_is_listed():
    assert "graftbench.harness" in MODULES and "graftbench.reference.tpch_queries" in MODULES


def test_benchmark_loads_no_jax_nor_the_jax_package():
    loaded = top_level_after_import(MODULES)
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "graftdb", "benchmarks"}, loaded


def test_harness_run_loads_no_jax_nor_the_jax_package():
    code = (
        "import sys, time; sys.path[:0] = [{root!r}, {src!r}]\n"
        "from graftbench import harness, run\n"
        "harness.run_cell('sf1-closed1', 3, 1.0, True, time.perf_counter(), device='cpu',"
        " scale_factor=0.01)\n"
        "print(run.forbidden_modules())\n"
    ).format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_loads_nothing_of_the_program():
    loaded = top_level_after_import(["graftbench.reference.tpch_queries", "graftbench.compare",
                                     "graftbench.control", "graftbench.datagen"])
    assert not loaded & {"repro_torch", "graftdb_torch", "torch", "jax", "repro", "graftdb"}, loaded
