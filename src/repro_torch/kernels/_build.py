"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library
with a plain C interface, loaded with ``ctypes``. Libraries are keyed on a
hash of their source (and the flags), so a fresh checkout builds them at
first use and an unchanged source is never rebuilt. The build directory is
``build/repro_torch/`` at the repository root.

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` or a card, where only the kernels' plain PyTorch versions
run.

``LAUNCHES`` counts kernel launches by name. A wrapper adds one exactly
where it launches its CUDA kernel — never on the plain path — so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("hash_probe", "fused_chain", "seg_aggregate", "flash_attention", "linrec")

LAUNCHES: Dict[str, int] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
#: ptxas register / shared-memory report of each source's last build (kept
#: beside its library, so a process that finds the library built reads it)
BUILD_LOG: Dict[str, str] = {}


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def _lib_path(stem: str) -> Path:
    src = (CSRC / f"{stem}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{stem}_{digest}.so"


def build(stems: Iterable[str] = SOURCES) -> float:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns the wall seconds spent; raises on any failure."""
    t0 = time.perf_counter()
    todo = []
    for stem in stems:
        lib = _lib_path(stem)
        if lib.exists():
            log = lib.with_suffix(".log")
            BUILD_LOG.setdefault(stem, log.read_text() if log.exists() else "")
        else:
            todo.append((stem, lib))
    if not todo:
        return 0.0
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for stem, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs.append(
            (stem, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        )
    failed = []
    for stem, out, tmp, p in procs:
        log, _ = p.communicate()
        BUILD_LOG[stem] = log
        if p.returncode != 0:
            failed.append(f"{stem}.cu (nvcc exit {p.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of one source, building it first if needed."""
    lib = _LIBS.get(stem)
    if lib is None:
        build((stem,))
        lib = ctypes.CDLL(str(_lib_path(stem)))
        _LIBS[stem] = lib
    return lib


@functools.lru_cache(maxsize=None)
def bind(stem: str, fn: str, n_ptr: int, n_int: int, trailing_ptr: int = 0,
         restype: str = "int"):
    """A C entry point with ``n_ptr`` pointer arguments, then ``n_int``
    int arguments, then ``trailing_ptr`` pointers (the stream last),
    returning an ``int`` (a CUDA error code) or a ``longlong``.
    Pointers must be declared ``c_void_p``: ctypes would otherwise pass
    each as a 32-bit int and cut it."""
    f = getattr(load(stem), fn)
    f.argtypes = (
        [ctypes.c_void_p] * n_ptr
        + [ctypes.c_longlong] * n_int
        + [ctypes.c_void_p] * trailing_ptr
    )
    f.restype = {"int": ctypes.c_int, "longlong": ctypes.c_longlong}[restype]
    return f


def check(err: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error (its
    ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {err})")


def stream_ptr(device) -> int:
    """The handle of PyTorch's current stream on ``device``, read without
    building a ``torch.cuda.Stream`` object: that object costs microseconds
    of host time on every kernel call, as much as a small kernel runs."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
