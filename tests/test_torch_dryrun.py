"""The port's dry-run tooling (``repro_torch.launch.{hlo_analysis,
dryrun}``) on the CPU, on its own and against the reference's.

* The HLO text analyzer copied into the port gives the reference's
  result, field for field, on HLO text that JAX compiles here: a scan of
  7 products in this process, and three programs with every collective
  kind and the reference's smoke steps, compiled by ``_xla_programs.py``
  in a subprocess at 4 forced host devices (JAX pins the device count at
  its first init). ``parse_collectives`` lives in the
  reference's ``launch/dryrun.py``, which sets ``XLA_FLAGS`` for 512 host
  devices when imported, so the test never imports it: it executes only
  that function's definitions, read from the file (``_ref_parse_collectives``).
* The op counter: the reference's loop-trip test as a Python loop; the
  smoke train step's FLOPs within 1% of the reference's ``analyze`` of
  its compiled HLO (measured 0.99969, 0.99968 and 0.99878); the depth
  extrapolation equal to the full count; the collective model against
  hand-computed values, and against XLA's program of the reference's
  smoke steps on a 2 x 2 mesh, read by the reference's analyzer once
  the values named after a collective are renamed (``renamed``).
* ``run_cell`` and ``main`` on a full-size cell, the roofline over their
  file, the db-plane record, and the production mesh refused by a
  session.
"""

import ast
import contextlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from _xla_programs import check_model, model_traffic, renamed

from repro.configs import smoke_config as ref_smoke_config
from repro.launch import hlo_analysis as RH
from repro.models import model as RM
from repro.train.optim import abstract_opt_state as ref_abstract_opt_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import roofline
from repro_torch.launch import sharding as SH
from repro_torch.launch.db_plane import validate_db_plane_record
from repro_torch.launch.mesh import ProductionMesh, make_production_mesh, resolve_mesh
from repro_torch.models import model as M
from repro_torch.train.optim import abstract_opt_state, init_opt_state
from repro_torch.train.train_step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
SMOKE_TRAIN = {"kind": "train", "seq_len": 256, "global_batch": 2}


def _ref_parse_collectives():
    """The reference's ``dryrun.parse_collectives`` with the constants it
    reads, executed from its source alone."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.Assign) and {t.id for t in n.targets if isinstance(t, ast.Name)}
                & {"COLLECTIVE_RE", "SHAPE_RE", "DTYPE_BYTES"})
            or (isinstance(n, ast.FunctionDef) and n.name == "parse_collectives")]
    assert len(keep) == 4
    ns = {"re": re}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "dryrun.py", "exec"), ns)
    return ns["parse_collectives"]


#: (arch, kind, seq_len, global_batch) of the reference's smoke steps
#: compiled on a 2 x 2 mesh: sequences at and past ``QCHUNK_THRESHOLD``,
#: dense and MoE
XLA_STEPS = [(arch, kind, seq, batch) for arch in ("stablelm-3b", "dbrx-132b")
             for kind, seq, batch in (("train", 256, 8), ("train", 4096, 16),
                                      ("prefill", 4096, 16), ("decode", 256, 8))]


@pytest.fixture(scope="module")
def hlo_texts(tmp_path_factory):
    """{name: compiled HLO text}: the 7-product scan in this process, and
    the collective programs and the reference's steps (``XLA_STEPS``) at 4
    forced host devices in a subprocess."""
    path = tmp_path_factory.mktemp("hlo") / "hlo.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, str(ROOT / "tests" / "_xla_programs.py"), str(path),
                          json.dumps(XLA_STEPS)], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    texts = json.loads(path.read_text())

    def f(w, x):
        def body(c, _):
            return jnp.tanh(c @ w), None

        y, _ = jax.lax.scan(body, x, None, length=7)
        return y.sum()

    texts["loop7"] = jax.jit(f).lower(jnp.zeros((64, 64)), jnp.zeros((8, 64))).compile().as_text()
    return texts


def test_hlo_analyzer_matches_reference(hlo_texts):
    kinds = set()
    for name, text in hlo_texts.items():
        got, want = H.analyze(text), RH.analyze(text)
        assert (got.flops, got.mem_bytes, got.coll_bytes, got.coll_count) == (
            want.flops, want.mem_bytes, want.coll_bytes, want.coll_count), name
        kinds |= set(want.coll_count)
        gc, wc = H.parse_module(text), RH.parse_module(text)
        assert list(gc) == list(wc)
        for cname, comp in wc.items():
            assert [vars(i) for i in gc[cname].instrs] == [vars(i) for i in comp.instrs]
            assert gc[cname].shapes == comp.shapes
            for t in comp.shapes.values():
                assert H.shape_bytes(t) == RH.shape_bytes(t)
                assert H.shape_dims(t) == RH.shape_dims(t)
            for ins in comp.instrs:
                cond = re.search(r"condition=%?([\w.\-]+)", ins.rhs)
                if cond:
                    assert H.trip_count(gc, cond.group(1)) == RH.trip_count(wc, cond.group(1))
    assert RH.trip_count(RH.parse_module(hlo_texts["loop7"]),
                         re.search(r"condition=%?([\w.\-]+)", hlo_texts["loop7"]).group(1)) == 7
    assert kinds >= {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                     "collective-permute"}, kinds


def test_parse_collectives_matches_reference(hlo_texts):
    ref_parse = _ref_parse_collectives()
    seen = set()
    for text in hlo_texts.values():
        got = H.parse_collectives(text)
        assert got == ref_parse(text)
        seen |= set(got)
    assert len(seen) == 5


def test_shape_bytes_cases():
    """The reference's ``test_hlo_analyzer_shape_bytes``."""
    assert H.shape_bytes("bf16[4,8]") == 64
    assert H.shape_bytes("f32[2,2] , s32[3]") == 28
    assert H.shape_bytes("(f32[2], pred[8])") == 16


def test_op_counter_counts_loop_trips():
    """The twin of the reference's ``test_hlo_analyzer_counts_loop_trips``:
    a Python loop of 7 products counts 7x one product's FLOPs."""
    w = torch.zeros(64, 64)
    c = torch.zeros(8, 64)
    with H.OpCounter() as counter:
        for _ in range(7):
            c = torch.tanh(c @ w)
        c.sum()
    expected = 7 * 2 * 8 * 64 * 64
    assert 0.9 * expected <= counter.stats.flops <= 1.3 * expected
    assert counter.stats.flops == expected
    # mm: two operands and a result; tanh: one of each; sum: 8 x 64 floats + a scalar
    assert counter.stats.mem_bytes == 7 * 4 * (8 * 64 + 64 * 64 + 8 * 64 + 2 * 8 * 64) + 4 * 8 * 64 + 4


def test_op_counter_bytes_model():
    """Views move nothing, an in-place op reads its operands and writes its
    result, an allocation that writes nothing moves nothing."""
    a = torch.zeros(4, 8)
    with H.OpCounter(record_ops=True) as counter:
        a.t().unbind(0)
        a.reshape(32)[:16].detach()
        torch.empty(100)
    assert counter.stats.mem_bytes == 0 and counter.ops
    with H.OpCounter() as counter:
        a.t().reshape(32)  # a copy: read once, written once
    assert counter.stats.mem_bytes == 2 * 4 * 32
    with H.OpCounter() as counter:
        a.add_(1.0)
    assert counter.stats.mem_bytes == 2 * 4 * 32


@pytest.mark.parametrize("arch", ["stablelm-3b", "dbrx-132b", "rwkv6-7b"])
def test_op_counter_flops_match_reference_hlo(arch):
    """The smoke train step (2 x 256 tokens, float32) on ``meta``: its
    FLOPs within 1% of the reference's analysis of the compiled step, and
    equal on the CPU's real tensors."""
    rcfg = ref_smoke_config(arch)
    ap = RM.abstract_params(rcfg, jnp.float32)
    ab = RM.input_specs(rcfg, SMOKE_TRAIN, jnp.float32)
    text = jax.jit(ref_make_train_step(rcfg)).lower(
        ap, ref_abstract_opt_state(ap, rcfg.optimizer), ab).compile().as_text()
    want = RH.analyze(text).flops
    cfg = smoke_config(arch)
    params = M.abstract_params(cfg, torch.float32)
    opt = abstract_opt_state(params, cfg.optimizer)
    batch = M.input_specs(cfg, SMOKE_TRAIN, torch.float32)
    with H.OpCounter() as meta:
        make_train_step(cfg, device="meta")(params, opt, batch)
    assert abs(meta.stats.flops / want - 1) < 0.01, (meta.stats.flops, want)
    real = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    real_opt = init_opt_state(real, cfg.optimizer)
    real_batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in batch.items()}
    with H.OpCounter() as cpu:
        make_train_step(cfg, device="cpu")(real, real_opt, real_batch)
    assert (cpu.stats.flops, cpu.stats.mem_bytes) == (meta.stats.flops, meta.stats.mem_bytes)


@pytest.mark.parametrize("arch", ["stablelm-3b", "dbrx-132b", "recurrentgemma-9b", "rwkv6-7b",
                                  "pixtral-12b", "seamless-m4t-large-v2",
                                  "llama4-maverick-400b-a17b"])
def test_depth_extrapolation_equals_full_count(arch):
    """Each family's smoke config deepened to 4 repetitions of its pattern
    (plus a remainder group where the pattern has more than one block, and
    3 encoder layers): the count from 1 and 2 repetitions equals the full
    one, FLOPs and bytes, for train, prefill and decode."""
    import dataclasses

    cfg = smoke_config(arch)
    period = len(cfg.block_pattern or ("attn",))
    cfg = dataclasses.replace(cfg, n_layers=4 * period + (1 if period > 1 else 0),
                              n_encoder_layers=3 if cfg.n_encoder_layers else 0)
    assert D._depth_knobs(cfg)
    for kind in ("train", "prefill", "decode"):
        shape = {"kind": kind, "seq_len": 32, "global_batch": 2}
        full = D.count_step(cfg, shape).stats
        assert D.count_cell(cfg, shape) == {"flops": full.flops, "bytes": full.mem_bytes,
                                            "depth_extrapolated": True}, kind
        assert full.flops > 0 and full.mem_bytes > 0


def test_collective_model_by_hand():
    """A hand-made tree on a 2 x 2 descriptor mesh, dbrx-132b's smoke
    config (E = 4 experts, top 2, D = 64), bf16, 2 rows a device."""
    cfg = smoke_config("dbrx-132b")
    mesh = ProductionMesh((2, 2), ("data", "model"))

    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    params = {"embed": meta(512, 64), "final_norm": meta(64),
              "groups": [{"attn0": {"wo": meta(3, 4, 16, 64), "router": meta(3, 64, 4),
                                    "w_gate": meta(3, 4, 64, 128)}}]}
    specs = SH.param_specs(cfg, mesh, params)
    assert dict(M.tree_leaves_with_path(specs)) == {
        "embed": ("model", "data"), "final_norm": (),
        "groups/0/attn0/wo": (None, "model", None, "data"),
        "groups/0/attn0/router": (None, "data", None),
        "groups/0/attn0/w_gate": (None, "model", "data", None)}
    # leaf bytes: embed 65,536, final_norm 128, wo 24,576, router 1,536,
    # w_gate 196,608 (experts on 'model': 98,304 a shard)

    def model(seq, kind):
        return D.collective_model(cfg, {"kind": kind, "seq_len": seq, "global_batch": 4},
                                  mesh, params, specs)

    # train, 8 tokens: the sequence splits over 'model'. Each dense leaf
    # gathered whole twice: over 'model' (result L / 2) then over 'data'
    # (result L), half of each result moved; its gradient all-reduced
    # (traffic = L) over each axis. Experts over 'data' only. The MoE
    # (tokens [2, 8, 64] = 2,048 bytes): 9 dispatch gathers, 6 combines
    # of the top-2 outputs (4,096), 3 all-reduces of the dispatch's
    # gradient; the top-k's f32 logits [2, 8, 4] (256) over 'model', the
    # batch's [4, 8, 4] (512) over 'data', the weights [2, 8, 2] (128)
    # over 'model', 6 times each. The table's 512 rows outnumber the 16
    # tokens a data shard looks up, so the lookups move, not the table:
    # the int32 tokens [4, 4] (64) over 'data' and [4, 8] (128) over
    # 'model', the rows found [4, 8, 32] (2,048) all-reduced over 'model',
    # a device's rows [2, 4, 64] (1,024) to the activations' split by an
    # all-to-all and a permute; the gradient's rows [2, 8, 64] (2,048)
    # gathered over 'data', moved by an all-to-all and a permute
    traffic, count, result = model(8, "train")
    assert traffic == {
        "all-gather": 2 * (6144 + 12288) + 2 * 768 + 9 * 1024 + 2 * 49152
        + 6 * (128 + 256 + 64) + 32 + 64 + 1024,
        "all-reduce": 2 * 128 + 2 * 24576 + 2 * 1536 + 6 * 4096 + 3 * 2048 + 98304 + 2048,
        "all-to-all": 512 + 1024,
        "collective-permute": 1024 + 2048}
    assert count == {"all-gather": 4 + 2 + 9 + 2 + 18 + 3, "all-reduce": 2 + 2 + 2 + 9 + 1 + 1,
                     "all-to-all": 2, "collective-permute": 2}
    assert result["all-gather"]["bytes"] == (
        2 * (12288 + 24576) + 2 * 1536 + 9 * 2048 + 2 * 98304 + 6 * (256 + 512 + 128)
        + 64 + 128 + 2048)
    # train, 7 tokens: the sequence stays whole on 'model'. Each leaf the
    # data axis splits gathered over it twice (L / its 'model' shards),
    # its gradient all-reduced over it; wo's all-reduce of [2, 7, 64]
    # (1,792 bytes) after each of its 3 products, twice; the combines
    traffic, count, _ = model(7, "train")
    assert traffic == {
        "all-gather": 2 * 16384 + 2 * 6144 + 2 * 768 + 2 * 49152,
        "all-reduce": 32768 + 128 + 12288 + 1536 + 98304 + 6 * 1792 + 6 * 3584}
    assert count == {"all-gather": 8, "all-reduce": 5 + 6 + 6}
    # decode: one token; the embedding (its data-split dim is the output)
    # is not gathered, its rows [2, 64] (256 bytes) go to the batch's split
    # by an all-to-all; an MoE architecture gathers wo's 'model' shard
    # (12,288) over 'data'; wo's 3 all-reduces of [2, 1, 64], the 3
    # combines of [2, 2, 64]; the router moved onto 'model' by one permute
    # of its 'model' shard (768) and its logits [2, 4] (16) all-reduced
    traffic, count, _ = model(8, "decode")
    assert traffic == {"all-gather": 6144 + 49152, "all-reduce": 3 * 256 + 3 * 512 + 3 * 16,
                       "all-to-all": 128, "collective-permute": 768}
    assert count == {"all-gather": 2, "all-reduce": 9, "all-to-all": 1, "collective-permute": 1}
    one = ProductionMesh((1, 1), ("data", "model"))
    assert D.collective_model(cfg, {"kind": "train", "seq_len": 8, "global_batch": 4}, one,
                              params, SH.param_specs(cfg, one, params)) == ({}, {}, {})


@pytest.mark.parametrize("arch,kind,seq,batch", XLA_STEPS)
def test_collective_model_against_xla(hlo_texts, arch, kind, seq, batch):
    """The collective model against XLA's program of the reference's step
    on a 2 x 2 mesh, read by the reference's analyzer: the per-device
    bytes within 10%, and each kind the model has within 10% (decode's
    all-reduces, a few KB of row outputs and combines, within 25%). The
    kinds it lacks (an all-to-all or a permute of a few rows) stay under
    3% of XLA's bytes."""
    text = hlo_texts[f"step:{arch}:{kind}:{seq}x{batch}"]
    xla = RH.analyze(renamed(text)).coll_bytes
    assert sum(RH.analyze(text).coll_bytes.values()) >= sum(xla.values())
    check_model(kind, model_traffic(arch, kind, seq, batch), xla)


def test_run_cell_and_main_on_a_full_size_cell(tmp_path, monkeypatch):
    """stablelm-3b's decode_32k on both production meshes through the CLI:
    two ok records from one count, every ``hlo_stats`` field, the
    roofline over the file."""
    monkeypatch.setattr(D, "RESULTS", tmp_path / "dryrun_torch.json")
    counted = []
    real = D.count_cell
    monkeypatch.setattr(D, "count_cell", lambda *a, **k: counted.append(a) or real(*a, **k))
    with contextlib.redirect_stdout(io.StringIO()):
        D.main(["--arch", "stablelm-3b", "--shape", "decode_32k", "--multi-pod", "both"])
    recs = json.loads(D.RESULTS.read_text())
    assert len(counted) == 1
    assert [(r["mesh"], r["status"]) for r in recs] == [("16x16", "ok"), ("2x16x16", "ok")]
    cfg = get_config("stablelm-3b")
    for rec in recs:
        mesh = make_production_mesh(multi_pod=rec["mesh"] == "2x16x16")
        hs = rec["hlo_stats"]
        assert set(hs) == {"flops_per_device", "mem_bytes_per_device", "coll_bytes_per_device",
                           "coll_count"}
        assert hs["flops_per_device"] == rec["cost_analysis"]["flops"] / mesh.size > 0
        assert hs["mem_bytes_per_device"] == rec["cost_analysis"]["bytes accessed"] / mesh.size
        assert set(hs["coll_bytes_per_device"]) == {"all-gather", "all-reduce", "all-to-all"}
        assert hs["coll_count"]["all-reduce"] == 2 * cfg.n_layers
        assert hs["coll_count"]["all-to-all"] == 2 * cfg.n_layers + 1
        p = M.abstract_params(cfg)
        c = M.abstract_cache(cfg, 128, 32768)
        assert rec["analytic_bytes_per_device"] == int(
            D.tree_bytes_per_device(p, SH.param_specs(cfg, mesh, p), mesh)
            + D.tree_bytes_per_device(c, SH.cache_specs(cfg, mesh, c), mesh))
        assert rec["memory_analysis"].startswith("unavailable")
        assert rec["depth_extrapolated"] is True
    # the roofline reads the port's file
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        roofline.main(["--mesh", "all", "--results", str(D.RESULTS)])
    assert "| stablelm-3b | decode_32k | 2x16x16 |" in out.getvalue()
    assert roofline.RESULTS.name == "dryrun_torch.json"
    # a second run finds both cached
    with contextlib.redirect_stdout(io.StringIO()) as again:
        D.main(["--arch", "stablelm-3b", "--shape", "decode_32k", "--multi-pod", "both"])
    assert again.getvalue().count("(cached)") == 2 and len(counted) == 1


def test_run_cell_records_a_failure(monkeypatch):
    def boom(cfg, shape):
        raise RuntimeError("cannot read a value on meta")

    monkeypatch.setattr(D, "count_cell", boom)
    rec = D.run_cell("stablelm-3b", "decode_32k", False)
    assert rec["status"] == "fail" and "cannot read a value" in rec["error"]
    assert "traceback" in rec and "hlo_stats" not in rec


def test_db_plane_on_the_production_data_axis():
    rec = D.run_db_plane(False, device="cpu", rows=1 << 12)
    validate_db_plane_record(rec)
    assert (rec["mesh"], rec["data_shards"]) == ("16x16", 16)


def test_production_mesh_is_refused_by_a_session():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).axis_names == ("pod", "data", "model")
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"{n} devices"):
            resolve_mesh(make_production_mesh(multi_pod=multi), "cpu")
    import graftdb_torch
    from repro_torch.relational import tpch

    db = tpch.get_database(0.002)
    with pytest.raises(ValueError, match="256 devices"):
        graftdb_torch.connect(db, graftdb_torch.EngineConfig(mesh=make_production_mesh(),
                                                             device="cpu"))
