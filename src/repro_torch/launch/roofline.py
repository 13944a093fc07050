"""Roofline analysis from the dry-run's compiled artifacts (§Roofline).

A port of the reference's ``launch/roofline.py``: the same functions on
the port's configs, so that a reference record gives the reference's
dict, with the TPU v5e constants it is computed against. Beside them
stand the H100's, which set a step on the card against its peak.

Reads benchmarks/results/dryrun_torch.json, written by the port's
``launch/dryrun.py`` (an op count on ``meta`` tensors, per device by
division, collectives modelled from the sharding specs; the file is
absent until a dry run writes it, and ``main`` then raises
FileNotFoundError, as the reference's does), or with ``--results`` the
reference's benchmarks/results/dryrun.json (its compiled HLO's
trip-count-aware analysis), and derives, per (arch x shape x mesh):

  compute term    = HLO_FLOPs_per_device / peak_FLOP/s
  memory term     = HLO_bytes_per_device / HBM_bw
  collective term = ICI_bytes_per_device / link_bw

TPU v5e constants: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI.
MODEL_FLOPS = 6*N*D (train; N_active for MoE) or 2*N_active*tokens
(prefill/decode) — the MODEL/HLO ratio exposes remat, padding, and
dispatch waste.

  PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh 16x16] [--md out.md]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..configs import ARCHS, SHAPES

PEAK_FLOPS = 197e12  # bf16 / chip
HBM_BW = 819e9  # bytes/s
LINK_BW = 50e9  # bytes/s/link

# NVIDIA H100 SXM5, one card (NVIDIA H100 Tensor Core GPU datasheet: dense
# rates, without sparsity, at the 700 W power limit)
H100_BF16_FLOPS = 989.4e12  # tensor cores, bf16 in, fp32 accumulate
H100_TF32_FLOPS = 494.7e12  # tensor cores, TF32
H100_FP32_FLOPS = 66.9e12  # CUDA cores, float32 FMA
H100_HBM_BW = 3.35e12  # HBM3 bytes/s
# float32 products at float32's accuracy on the tensor cores: each as three
# TF32 products (hi*hi + hi*lo + lo*hi), a third of the TF32 rate
H100_FP32X3_FLOPS = H100_TF32_FLOPS / 3

RESULTS = Path(__file__).resolve().parents[3] / "benchmarks" / "results" / "dryrun_torch.json"


def model_flops_per_device(arch: str, shape_name: str, n_chips: int) -> float:
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    counts = cfg.param_counts()
    n_active = counts["active"]
    if shape["kind"] == "train":
        tokens = shape["global_batch"] * shape["seq_len"]
        return 6.0 * n_active * tokens / n_chips
    if shape["kind"] == "prefill":
        tokens = shape["global_batch"] * shape["seq_len"]
        return 2.0 * n_active * tokens / n_chips
    tokens = shape["global_batch"]  # decode: one new token per sequence
    return 2.0 * n_active * tokens / n_chips


def analyze_record(rec: dict) -> dict:
    n_chips = 512 if rec["mesh"] == "2x16x16" else 256
    hs = rec.get("hlo_stats") or {}
    flops = hs.get("flops_per_device", 0.0)
    mem = hs.get("mem_bytes_per_device", 0.0)
    coll = sum((hs.get("coll_bytes_per_device") or {}).values())
    t_c = flops / PEAK_FLOPS
    t_m = mem / HBM_BW
    t_i = coll / LINK_BW
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_i)), key=lambda kv: kv[1])[0]
    mf = model_flops_per_device(rec["arch"], rec["shape"], n_chips)
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_i,
        "dominant": dom,
        "model_flops": mf,
        "hlo_flops": flops,
        "useful_ratio": mf / flops if flops else 0.0,
        "roofline_frac": (
            max(t_c, 1e-30) / max(t_c, t_m, t_i, 1e-30)
        ),  # compute term share of the binding term
    }


def render_markdown(rows) -> str:
    hdr = (
        "| arch | shape | mesh | compute s | memory s | collective s | dominant | "
        "MODEL/HLO flops | roofline frac |\n|---|---|---|---|---|---|---|---|---|\n"
    )
    out = [hdr]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.4f} | {r['dominant']} | "
            f"{r['useful_ratio']:.2f} | {r['roofline_frac']:.2f} |\n"
        )
    return "".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16", help="16x16 | 2x16x16 | all")
    ap.add_argument("--md", default=None)
    ap.add_argument("--results", default=str(RESULTS))
    args = ap.parse_args(argv)
    recs = json.loads(Path(args.results).read_text())
    rows = []
    for rec in recs:
        if rec["status"] != "ok" or not isinstance(rec.get("hlo_stats"), dict):
            continue
        if rec["arch"] not in ARCHS:
            continue  # auxiliary cells (graftdb-dataplane) have no 6ND model
        if args.mesh != "all" and rec["mesh"] != args.mesh:
            continue
        rows.append(analyze_record(rec))
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    md = render_markdown(rows)
    print(md)
    if args.md:
        Path(args.md).write_text(md)
    # summary: most interesting cells for the perf loop
    worst = sorted(rows, key=lambda r: r["roofline_frac"])[:5]
    print("\nworst roofline fraction (hillclimb candidates):")
    for r in worst:
        print(
            f"  {r['arch']}/{r['shape']}: dominant={r['dominant']} "
            f"frac={r['roofline_frac']:.2f} useful={r['useful_ratio']:.2f}"
        )
    coll_bound = sorted(rows, key=lambda r: -r["collective_s"])[:5]
    print("most collective-bound:")
    for r in coll_bound:
        print(f"  {r['arch']}/{r['shape']}: collective={r['collective_s']:.4f}s")


if __name__ == "__main__":
    main()
