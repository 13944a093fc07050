#!/usr/bin/env python3
"""Variants of two CUDA kernels of the port, timed side by side on one card.

    python3 tools/kernel_variants.py

Run from the root of a checkout, on a machine with an NVIDIA card and
``nvcc``. It imports nothing of JAX or of the reference package.

* The linear recurrence (B8, ``csrc/linrec.cu``) at recurrentgemma-9b's
  RG-LRU width ``[2, 4096, 4096]`` float32, built from its source with
  other numbers of warps (chunks) a block (``LR_WARPS``); each variant's
  output must equal ``linrec_plain`` bit for bit. Beside them, as the
  ceiling of the layout, a kernel that streams the same bytes in the same
  layout and registers without the recurrence (``h = a + b``, one warp's
  64 rows of 32 channels), and ``torch.add`` on the same tensors.
* The 32-bit multi-member probe (B5, ``hp_probe_multi``) on
  ``chip_smoke.py``'s phase-3 inputs (65,536 keys, half of them hits, into
  the TPC-H SF-1 orders table, and one key): as before its redesign (the
  word loaded after the compare, plain loads, no launch bounds), as built
  (launch bounds and read-only loads), and with the home slot's word
  loaded beside its key and picked by a select, as B4 and B3 do. Each
  variant's rows must equal the plain version's.

Each variant is timed by CUDA events (the mean of many calls; all variants
first, before any trace) and then by device time per call from a
``torch.profiler`` trace, in the order listed and again in reverse, so
that a drift of the card shows. Details go to
``chiprun_out/kernel_variants.json``; the card's name and power limit are
printed first.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (timing helpers and phase-3 inputs)

#: label: LR_WARPS; the first is the kernel as built
LINREC_VARIANTS = {"warps4": 4, "warps8": 8, "warps2": 2}

#: the recurrence's layout streamed without the recurrence: per warp 64 rows
#: of 32 channels of a and b loaded into registers, then h = a + b stored
STREAM_SOURCE = r"""
#include <cuda_runtime.h>
#define ROWS 64
#define WARPS 4
__global__ void __launch_bounds__(WARPS * 32, 1)
stream_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ h,
              long long s_len, long long d) {
    const long long chunks = s_len / ROWS, strips = d / 32;
    const long long t = blockIdx.x;  // (chunk group, strip), strips fastest
    const long long c = (t / strips) * WARPS + (threadIdx.x >> 5);
    if (c >= chunks) return;
    const long long base = ((long long)blockIdx.y * s_len + c * ROWS) * d + (t % strips) * 32
                           + (threadIdx.x & 31);
    float ra[ROWS], rb[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        ra[k] = __ldcs(a + base + k * d);
        rb[k] = __ldcs(b + base + k * d);
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) __stcs(h + base + k * d, __fadd_rn(ra[k], rb[k]));
}

extern "C" int stream_ab(const void* a, const void* b, void* h, long long nb, long long s_len,
                         long long d, void* stream) {
    const long long per_row = (s_len / ROWS + WARPS - 1) / WARPS * (d / 32);
    stream_kernel<<<dim3((unsigned)per_row, (unsigned)nb), WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (float*)h, s_len, d);
    return (int)cudaGetLastError();
}
"""

#: label: macros of ``B5_SOURCE``
B5_VARIANTS = {
    "after_compare": (),  # the kernel before its redesign
    "after_compare_bounds_ldg": ("BOUNDS", "LDG"),  # the kernel as built
    "select_bounds": ("SELECT", "BOUNDS"),
    "select_bounds_ldg": ("SELECT", "BOUNDS", "LDG"),  # as B4 and B3 load
}

B5_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#define EMPTY_KEY (-0x7FFFFFFF)
#define MAX_PROBE 16
#define MULT 2654435761u
#define BLOCK 256
#ifdef BOUNDS
#define BOUND __launch_bounds__(BLOCK)
#else
#define BOUND
#endif
#ifdef LDG
#define LD(p) __ldg(p)
#else
#define LD(p) (*(p))
#endif

__global__ void BOUND probe_multi_variant(const int* __restrict__ keys, long long n,
                                          const int* __restrict__ tkeys,
                                          const uint32_t* __restrict__ tvis, long long cap,
                                          int* __restrict__ out) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int key = LD(keys + i);
    const uint32_t mask = (uint32_t)(cap - 1);
    uint32_t pos = ((uint32_t)key * MULT) & mask;
    int found = -1;
    uint32_t vis = 0;
#ifdef SELECT
    const int sk0 = LD(tkeys + pos);
    const uint32_t w0 = LD(tvis + pos);
    found = sk0 == key ? (int)pos : -1;
    vis = sk0 == key ? w0 : 0u;
    if (sk0 != key && sk0 != EMPTY_KEY) {
        for (int h = 1; h < MAX_PROBE; ++h) {
            pos = (pos + 1) & mask;
            const int sk = LD(tkeys + pos);
            if (sk == key) {
                found = (int)pos;
                vis = LD(tvis + pos);
                break;
            }
            if (sk == EMPTY_KEY) break;
        }
    }
#else
    for (int h = 0; h < MAX_PROBE; ++h) {
        const int sk = LD(tkeys + pos);
        if (sk == key) {
            found = (int)pos;
            vis = LD(tvis + pos);
            break;
        }
        if (sk == EMPTY_KEY) break;
        pos = (pos + 1) & mask;
    }
#endif
    out[i] = found;
    out[n + i] = (int)vis;
}

extern "C" int hp_probe_multi(const void* keys, const void* tkeys, const void* tvis, void* out,
                              long long n, long long cap, void* stream) {
    if (n > 0)
        probe_multi_variant<<<(unsigned)((n + BLOCK - 1) / BLOCK), BLOCK, 0,
                              (cudaStream_t)stream>>>(
            (const int*)keys, n, (const int*)tkeys, (const uint32_t*)tvis, cap, (int*)out);
    return (int)cudaGetLastError();
}
"""

OUT = ROOT / "chiprun_out" / "kernel_variants.json"
BUILD = ROOT / "build" / "variants"


def linrec_source(warps):
    src = (ROOT / "src/repro_torch/kernels/csrc/linrec.cu").read_text()
    lines = [ln for ln in src.splitlines() if ln.startswith("#define LR_WARPS ")]
    if len(lines) != 1:
        raise RuntimeError("linrec.cu: no single #define LR_WARPS")
    return src.replace(lines[0], f"#define LR_WARPS {warps}")


def build_all(sources):
    """{label: source} -> {label: (library path, ptxas lines)}, one nvcc
    each, all started together."""
    from repro_torch.kernels import _build

    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, (src, defines) in sources.items():
        cu = BUILD / f"{label}.cu"
        cu.write_text(src)
        lib = BUILD / f"lib{label}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(lib),
               str(cu)]
        procs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    out = {}
    for label, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{label}: nvcc exit {p.returncode}\n{log}")
        out[label] = (lib, [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln])
    return out


def fn(lib, name, n_ptr, n_int, trailing_ptr=0):
    f = getattr(lib, name)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong] * n_int
                  + [ctypes.c_void_p] * trailing_ptr)
    f.restype = ctypes.c_int
    return f


def time_both(calls):
    """Event means of every call first, then device ms per call from a
    trace, in the order given and again in reverse."""
    rec = {label: {"ms": [], "device_ms": []} for label in calls}
    order = list(calls) + list(reversed(calls))
    for label in order:
        rec[label]["ms"].append(cs.time_ms(calls[label], cs.SEG_ITERS))
    for label in order:
        rec[label]["device_ms"].append(sum(cs.kernel_device_ms(calls[label], 50).values()))
    return rec


def main():
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA card is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.kernels import linrec as lr
    from repro_torch.relational import tpch

    smi = cs.card_smi()
    print(smi, flush=True)
    report = {"device": {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi}}
    t0 = time.perf_counter()
    sources = {f"linrec_{k}": (linrec_source(v), ()) for k, v in LINREC_VARIANTS.items()}
    sources["stream"] = (STREAM_SOURCE, ())
    sources.update({f"b5_{k}": (B5_SOURCE, v) for k, v in B5_VARIANTS.items()})
    libs = build_all(sources)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    stream = _build.stream_ptr(dev)

    # B8
    a, b = cs.recurrence_inputs(np.random.default_rng(cs.SEED), cs.LINREC_SHAPE)
    want = lr.linrec_plain(a, b)
    nb, s, d = cs.LINREC_SHAPE
    calls, info = {}, {}
    for label in LINREC_VARIANTS:
        lib = ctypes.CDLL(str(libs[f"linrec_{label}"][0]))
        words = fn(lib, "lr_scratch_words", 0, 3)
        words.restype = ctypes.c_longlong
        run, read = fn(lib, "lr_linrec", 4, 3, 1), fn(lib, "lr_launch_info", 1, 3)
        h = torch.empty_like(a)
        scratch = torch.empty(words(nb, s, d), dtype=torch.int32, device=dev)

        def call(run=run, h=h, scratch=scratch):
            _build.check(run(a.data_ptr(), b.data_ptr(), h.data_ptr(), scratch.data_ptr(),
                             nb, s, d, stream), "variant")
            return h

        call()
        torch.cuda.synchronize()
        if not torch.equal(h.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"linrec {label}: differs from linrec_plain")
        launch = torch.zeros(3, dtype=torch.int64)
        _build.check(read(launch.data_ptr(), nb, s, d), "launch_info")
        info[label] = {"launch": dict(zip(("blocks", "threads", "blocks_per_sm"),
                                          launch.tolist())),
                       "ptxas": libs[f"linrec_{label}"][1]}
        calls[label] = call
    streamed = torch.empty_like(a)
    run = fn(ctypes.CDLL(str(libs["stream"][0])), "stream_ab", 3, 3, 1)
    calls["stream"] = lambda: _build.check(
        run(a.data_ptr(), b.data_ptr(), streamed.data_ptr(), nb, s, d, stream), "stream")
    calls["stream"]()
    torch.cuda.synchronize()
    if not torch.equal(streamed, a + b):
        raise AssertionError("stream: h != a + b")
    info["stream"] = {"ptxas": libs["stream"][1]}
    calls["torch_add"] = lambda: torch.add(a, b)
    info["torch_add"] = {}
    rec = time_both(calls)
    for label in calls:
        rec[label].update(info[label])
        print(f"linrec {label}: event ms {rec[label]['ms']}, device ms "
              f"{rec[label]['device_ms']}; {info[label]}", flush=True)
    report["linrec"] = {"shape": list(cs.LINREC_SHAPE), "variants": rec,
                        "bound_ms": cs.linrec_bound(a)[0]}
    del a, b, want, calls, streamed

    # B5
    db = tpch.get_database(cs.SCALE, seed=cs.SEED)
    inputs = cs.kernel_inputs(db)
    report["b5"] = {}
    for key in ("hash_probe_lens_multi", "hash_probe_lens_multi" + cs.FLOOR):
        k, tk, tv = inputs[key][1]
        want = torch.stack(hp.hash_probe_lens_multi_plain(k, tk, tv))
        calls = {}
        for label in B5_VARIANTS:
            run = fn(ctypes.CDLL(str(libs[f"b5_{label}"][0])), "hp_probe_multi", 4, 2, 1)
            out = torch.empty((2, k.shape[0]), dtype=torch.int32, device=dev)

            def call(run=run, out=out, k=k, tk=tk, tv=tv):
                _build.check(run(k.data_ptr(), tk.data_ptr(), tv.data_ptr(), out.data_ptr(),
                                 k.shape[0], tk.shape[0], stream), "variant")
                return out

            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"b5 {label}: differs from the plain version")
            calls[label] = call
        rec = time_both(calls)
        for label in B5_VARIANTS:
            rec[label]["ptxas"] = libs[f"b5_{label}"][1]
            print(f"b5 {key} {label}: equal to plain; event ms {rec[label]['ms']}, device ms "
                  f"{rec[label]['device_ms']}", flush=True)
        report["b5"][key] = rec

    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))
    print(json.dumps({"ok": True, "device": report["device"]["name"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
