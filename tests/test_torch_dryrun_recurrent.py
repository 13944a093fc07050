"""The dry run's collective model (``repro_torch.launch.dryrun.
collective_model``) for the two recurrent architectures, rwkv6-7b (the
RWKV6 time mix) and recurrentgemma-9b (the Griffin recurrent block beside
local attention), on the CPU:

* against XLA's program of the reference's smoke steps (train, prefill and
  decode; sequences of 256 and 4,096) on a 2 x 2 ('data', 'model') mesh,
  and of train and prefill steps at widths that tell the blocks' tensors
  apart (the smoke config has D = K = R = 64 and T = dh = 16), compiled
  by ``_xla_programs.py`` in a subprocess at 4 forced host devices and
  read by the reference's analyzer, by the rule of
  ``test_collective_model_against_xla`` (``_xla_programs.check_model``);
* against values computed by hand on hand-made trees and on the term
  functions: each term's bytes and count, and how the split-KV decode,
  the halo of the token shift and the RG-LRU's gathers vary with the mesh.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from _xla_programs import STEPS, check_model, model_traffic, renamed, step_key

from repro.launch import hlo_analysis as RH
from repro_torch.configs import smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import ProductionMesh

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("rwkv6-7b", "recurrentgemma-9b")
#: widths at which D, K = H dh, R, T, dh and the decay LoRA's rank (64)
#: all differ
WIDTHS = {"rwkv6-7b": {"d_model": 96, "rwkv_head_dim": 12, "rwkv_chunk": 32},
          "recurrentgemma-9b": {"d_model": 96, "lru_dim": 160}}
RECURRENT_STEPS = ([(arch, *step, None) for arch in ARCHS for step in STEPS]
                   + [(arch, kind, S, B, WIDTHS[arch]) for arch in ARCHS
                      for kind, S, B in (("train", 256, 8), ("train", 4096, 16),
                                         ("prefill", 256, 8))])
MESH = ProductionMesh((2, 2), ("data", "model"))


@pytest.fixture(scope="module")
def hlo_texts(tmp_path_factory):
    """{name: compiled HLO text} of ``RECURRENT_STEPS``, at 4 forced host
    devices in a subprocess."""
    path = tmp_path_factory.mktemp("hlo") / "hlo.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    steps = [[arch, kind, S, B, [2, 2], widths] for arch, kind, S, B, widths in RECURRENT_STEPS]
    out = subprocess.run([sys.executable, str(ROOT / "tests" / "_xla_programs.py"), str(path),
                          json.dumps(steps)], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("arch,kind,seq,batch,widths", RECURRENT_STEPS,
                         ids=[step_key(*step[:4], widths=step[4]) for step in RECURRENT_STEPS])
def test_recurrent_collective_model_against_xla(hlo_texts, arch, kind, seq, batch, widths):
    """The per-device bytes within 10% of XLA's, each kind the model has
    within 10% (decode's all-reduces within 25%), the kinds it lacks under
    3%; the sequence-split steps' all-to-alls (the chunk scans') within 1%."""
    text = hlo_texts[step_key(arch, kind, seq, batch, widths=widths)]
    xla = RH.analyze(renamed(text)).coll_bytes
    traffic = model_traffic(arch, kind, seq, batch, widths=widths)
    check_model(kind, traffic, xla)
    if kind != "decode":
        assert abs(traffic["all-to-all"] / xla["all-to-all"] - 1) < 0.01, (traffic, xla)


def _meta(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def _model(cfg, params, kind, seq, mesh=MESH):
    return D.collective_model(cfg, {"kind": kind, "seq_len": seq, "global_batch": 4}, mesh,
                              params, SH.param_specs(cfg, mesh, params))


def test_rwkv_collective_model_by_hand():
    """rwkv6-7b's smoke config (D = K = 64, 4 heads of 16, chunks of
    T = 16, the decay LoRA's rank 64), two stacked layers of w_r and
    w_dec1, bf16, 2 rows a device on a 2 x 2 mesh."""
    cfg = smoke_config("rwkv6-7b")
    params = {"embed": _meta(512, 64),
              "groups": [{"rwkv0": {"w_r": _meta(2, 64, 64), "w_dec1": _meta(2, 64, 64)}}]}
    # leaf bytes: embed 65,536, w_r 16,384, w_dec1 16,384
    assert SH.param_specs(cfg, MESH, params)["groups"][0]["rwkv0"] == {
        "w_r": (None, "data", "model"), "w_dec1": (None, "data", None)}
    traffic, count, result = _model(cfg, params, "train", 64)
    # train, 64 tokens (n = 4 chunks), the sequence split over 'model'.
    # Weights: w_r gathered whole twice, over 'model' then 'data';
    # w_dec1 over 'data' only; w_r's 'model' shard (8,192) gathered once
    # more and its gradient reduced over 'data' alone; w_dec1's gradient
    # over 'data' whole and over 'model' a data shard. Per layer: the token
    # shift's row [2, 64] (256) permuted 3 times; r, k, v and w
    # [2, 32, 64] f32 (16,384) moved 15 times; the 4 chunk outputs
    # [2, 16, 64] f32 (8,192) gathered twice; the mixes [2, 64, 64]
    # (16,384) gathered and all-reduced, 3 of D and 1 of the LoRA's; u's
    # gradient [32] f32 (128) reduced over 'data' each chunk. The table's
    # 512 rows outnumber a data shard's 128 tokens, so the lookups move:
    # the int32 tokens [4, 32] (512) over 'data' and [4, 64] (1,024) over
    # 'model', the rows found [4, 64, 32] (16,384) all-reduced over
    # 'model', a device's rows [2, 32, 64] (8,192) moved by an all-to-all
    # and a permute; the gradient's rows [2, 64, 64] (16,384) gathered
    # over 'data', moved by an all-to-all and a permute
    traffic, count, result = _model(cfg, params, "train", 64)
    assert traffic == {
        "all-gather": 2 * 4096 + 2 * 8192 + 4096 + 2 * 8192 + 16 * 4096 + 8 * 8192
        + 256 + 512 + 8192,
        "all-reduce": 8192 + 16384 + 8192 + 8 * 16384 + 8 * 128 + 16384,
        "all-to-all": 30 * 8192 + 4096 + 8192,
        "collective-permute": 6 * 256 + 8192 + 16384}
    assert count == {"all-gather": 2 + 5 + 16 + 8 + 3, "all-reduce": 1 + 2 + 8 + 8 + 1,
                     "all-to-all": 32, "collective-permute": 8}
    assert result["all-to-all"] == {"count": 32, "bytes": 30 * 16384 + 8192 + 16384}
    assert result["collective-permute"] == {"count": 8, "bytes": 6 * 256 + 8192 + 16384}
    # prefill: each leaf gathered once; the token shift's row once a layer
    # and the last position's row once; r, k, v and w moved 4 times a
    # layer; the chunk outputs gathered once; the lookups as in train
    traffic, count, _ = _model(cfg, params, "prefill", 64)
    assert traffic == {"all-gather": 256 + 512 + 4096 + 8192 + 8192 + 8 * 4096,
                       "all-reduce": 16384, "all-to-all": 8 * 8192 + 4096,
                       "collective-permute": 3 * 256 + 8192}
    assert count == {"all-gather": 2 + 2 + 1 + 8, "all-reduce": 1, "all-to-all": 9,
                     "collective-permute": 4}
    # decode: w_r gathered over 'data' (its 'model' shard, 8,192); w_dec1
    # moved onto 'model' by one permute of 8,192 and the LoRA's partial
    # sums [2, 64] (256) all-reduced; r, k, v and g [2, 64] (256) and the
    # receptance [2, 64] gathered over 'model', each layer
    traffic, count, result = _model(cfg, params, "decode", 64)
    assert traffic == {"all-gather": 4096 + 8 * 128 + 2 * 128, "all-reduce": 2 * 256,
                       "collective-permute": 8192}
    assert count == {"all-gather": 11, "all-reduce": 2, "collective-permute": 1}
    assert result["collective-permute"] == {"count": 1, "bytes": 8192}
    # on 4 x 2 the data axis outnumbers 'model': w_dec1 is gathered over
    # 'data' (3/4 of it moved), nothing permuted, no partial sums
    wide = ProductionMesh((4, 2), ("data", "model"))
    traffic, _, _ = _model(cfg, params, "decode", 64, wide)
    assert traffic == {"all-gather": 0.75 * 8192 + 0.75 * 16384 + 10 * 64}


def test_rg_lru_collective_model_by_hand():
    """recurrentgemma-9b's smoke config (D = R = 64, 16 query heads of 16
    after padding, one KV head, a tied embedding), one period of a
    recurrent block (w_rec_in, w_a) and an attention layer (wq, wk), bf16,
    2 rows a device on a 2 x 2 mesh."""
    cfg = smoke_config("recurrentgemma-9b")
    params = {"embed": _meta(512, 64),
              "groups": [{"rec0": {"w_rec_in": _meta(1, 64, 64), "w_a": _meta(1, 64, 64)},
                          "attn2": {"wq": _meta(1, 64, 16, 16), "wk": _meta(1, 64, 1, 16)}}]}
    # leaf bytes: embed 65,536, w_rec_in 8,192, w_a 8,192, wq 32,768,
    # wk 2,048
    traffic, count, _ = _model(cfg, params, "train", 64)
    # train, 64 tokens, the sequence split. The tied embedding: its 512
    # rows outnumber both the loss chunk's 256 tokens, so the head splits
    # the logits by the vocabulary (its 'model' shard, 32,768, gathered
    # over 'data' twice and its gradient reduced over 'data'; the softmax's
    # max and sum [2, 64] f32 (512) and the final hidden states' gradient
    # [2, 64, 64] (16,384) all-reduced over 'model', the states gathered
    # twice), and a data shard's 128 tokens, so the lookups move (as for
    # rwkv6-7b above). w_rec_in as w_r above; w_a: its
    # 'model' shard (4,096) gathered over 'data' twice, its gradient over
    # 'data'; wq gathered whole twice, its gradient over both axes; wk
    # over 'data' only, and K and V [2, 64, 1, 16] (4,096) gathered 4
    # times and reduced twice. The block: the conv's and gates' inputs
    # [2, 32, 64] (8,192) moved 5 times; the recurrence's input
    # [2, 64, 64] (16,384) gathered twice, the block's input once; their
    # gradients all-reduced, two of R and one of D
    traffic, count, _ = _model(cfg, params, "train", 64)
    assert traffic == {
        "all-gather": 2 * 16384 + 2 * 8192 + 256 + 512 + 8192
        + 2 * 2048 + 2 * 4096 + 2048 + 2 * 2048 + 2 * 8192 + 2 * 16384 + 2 * 1024 + 4 * 2048
        + 3 * 8192,
        "all-reduce": 32768 + 2 * 512 + 16384 + 16384 + 4096 + 4096 + 2 * 32768 + 2 * 2048
        + 2 * 4096 + 3 * 16384,
        "all-to-all": 5 * 4096 + 4096 + 8192,
        "collective-permute": 8192 + 16384}
    assert count == {"all-gather": 7 + 5 + 2 + 4 + 2 + 4 + 3,
                     "all-reduce": 5 + 1 + 1 + 2 + 2 + 2 + 3, "all-to-all": 7,
                     "collective-permute": 2}
    # decode: the tied embedding gathered over 'data' as the head (its
    # 'model' shard, 32,768); w_rec_in, w_a and wq likewise; the attention
    # layer's cache split on its sequence (one KV head): wk moved onto
    # 'model' by one permute (1,024), the query [2, 16, 16] (1,024)
    # gathered over 'model', the new K and V [2, 1, 16] (2 x 64)
    # all-reduced, the f32 partial outputs [2, 16, 16] (2,048) and the two
    # statistics [2, 16] (128 each); the recurrence's input [2, 64] (256)
    # gathered over 'model'; the embedding's rows [2, 64] (256) moved to
    # the batch's split by an all-to-all
    traffic, count, _ = _model(cfg, params, "decode", 64)
    assert traffic == {"all-gather": 16384 + 2048 + 2048 + 8192 + 512 + 128,
                       "all-reduce": 128 + 2048 + 2 * 128, "collective-permute": 1024,
                       "all-to-all": 128}
    assert count == {"all-gather": 6, "all-reduce": 4, "collective-permute": 1, "all-to-all": 1}


def _calls(fn, *args):
    """The (kind, count, result bytes, group) that ``fn`` adds."""
    out = []
    fn(lambda *call: out.append(call), *args)
    return out


def test_recurrent_terms_with_the_mesh():
    """The terms that vary with the mesh beyond 2 x 2, by hand: 2 layers,
    B_d = 2, D = 64, bf16, 256 tokens."""
    cfg = smoke_config("rwkv6-7b")
    flat = {"g/w_r": _meta(2, 64, 64), "g/w_dec1": _meta(2, 64, 64)}
    row = 2 * 64 * 2
    for n_m in (2, 4, 16):
        calls = _calls(D._rwkv_terms, cfg, "train", True, True, flat, "g/", 2, 2, 256, 2, n_m, 2)
        # the token shift's row a forward pass, n_m - 1 rows back and
        # n_m - 2 forward in the backward
        permutes = [c for c in calls if c[0] == "collective-permute"]
        assert permutes == [("collective-permute", 4, row, n_m),
                            ("collective-permute", 2, (n_m - 1) * row, n_m)] + (
            [("collective-permute", 2, (n_m - 2) * row, n_m)] if n_m > 2 else [])
        # prefill: one row a layer
        calls = _calls(D._rwkv_terms, cfg, "prefill", True, True, flat, "g/", 2, 2, 256, 2, n_m, 2)
        assert [c for c in calls if c[0] == "collective-permute"] == [
            ("collective-permute", 2, row, n_m)]
    # the RG-LRU's input [2, 256, 64] gathered for the gates: a forward
    # pass each, the backward too where 1 < n_d < n_m
    x = 2 * 256 * 64 * 2
    for (n_d, n_m), gathers in {(2, 2): 2, (2, 4): 3, (2, 8): 3, (4, 4): 2, (8, 4): 2,
                                (1, 8): 2}.items():
        calls = _calls(D._rg_lru_terms, "train", True, 2, 2, 256, 64, 64, n_d, n_m, 2)
        assert calls[1] == ("all-gather", gathers * 2, x, n_m), (n_d, n_m)


def test_split_kv_terms_by_hand():
    """Split-KV decode, 2 layers, B_d = 4, 16 query heads of 16 and two KV
    heads, bf16: on 'model' of 4 the two KV heads each span g = 2 devices,
    so the query [4, 16, 16] (2,048) and the float32 partial outputs
    (4,096) go in two steps, over n_m / g = 2 (a half each) and over g = 2;
    the statistics [4, 16] f32 (256) over 'model'; the new K and V
    [4, 2, 16] (2 x 256) where wk and wv re-split."""
    wq, wk = _meta(2, 64, 16, 16), _meta(2, 64, 2, 16)
    assert _calls(D._split_kv_terms, wq, wk, 2, 4, 4, 2, True) == [
        ("all-gather", 2, 1024, 2), ("all-gather", 2, 2048, 2), ("all-reduce", 2, 512, 4),
        ("all-reduce", 2, 4096, 2), ("all-reduce", 2, 4096, 2), ("all-reduce", 4, 256, 4)]
    # one KV head: a single step over 'model' (the steps over g = 1 add
    # nothing), and no re-split on 8 x 4
    calls = _calls(D._split_kv_terms, wq, _meta(2, 64, 1, 16), 2, 4, 4, 2, False)
    assert [c for c in calls if c[3] > 1] == [
        ("all-gather", 2, 2048, 4), ("all-reduce", 2, 4096, 4), ("all-reduce", 4, 256, 4)]


def test_replicated_batch_decode_by_hand():
    """Decode of one row on 4 x 4 (the batch does not split over 'data'):
    stablelm-3b's smoke config (16 query heads of 16 after padding, 4 KV
    heads, D = 64), bf16. No weight moves; each product's output row,
    its output dims over their shards, is all-reduced over the devices
    that split its contracted dims."""
    cfg = smoke_config("stablelm-3b")
    mesh = ProductionMesh((4, 4), ("data", "model"))
    params = {"embed": _meta(512, 64), "lm_head": _meta(64, 512),
              "groups": [{"attn0": {"wq": _meta(2, 64, 16, 16), "wk": _meta(2, 64, 4, 16),
                                    "wo": _meta(2, 16, 16, 64)}}]}
    specs = SH.param_specs(cfg, mesh, params)
    assert dict(D.M.tree_leaves_with_path(specs)) == {
        "embed": ("model", "data"), "lm_head": ("data", "model"),
        "groups/0/attn0/wq": (None, "data", "model", None),
        "groups/0/attn0/wk": (None, "data", None, None),
        "groups/0/attn0/wo": (None, "model", None, "data")}
    traffic, count, result = D.collective_model(
        cfg, {"kind": "decode", "seq_len": 256, "global_batch": 1}, mesh, params, specs)
    # the lookup's row [16] over 'model' (32 bytes); the logits [128] over
    # 'data' (256); wq's [4, 16] over 'data' (128), wk's new K, split by
    # heads as the cache is, [1, 16] (32); wo's [16] over 'model' (32); a
    # layer each but the lookup and the head; the ring factor 1.5 on 4
    assert result == {"all-reduce": {"count": 8,
                                     "bytes": 32 + 256 + 2 * 128 + 2 * 32 + 2 * 32}}
    assert traffic == {"all-reduce": 1.5 * (32 + 256 + 2 * 128 + 2 * 32 + 2 * 32)}
    assert count == {"all-reduce": 8}
