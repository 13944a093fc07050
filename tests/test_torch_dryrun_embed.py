"""The dry run's collective model (``repro_torch.launch.dryrun.
collective_model``) where XLA moves the embedding's lookups, or the
logits, instead of the table, and where a one-row decode's batch is not
split, on the CPU:

* against XLA's program of the reference's smoke steps: the 256-token
  train and prefill steps on 8 x 4, where a device looks up 64 tokens of a
  512-row table (five architectures: untied, tied, MoE, a vision stub's
  prefix, an encoder-decoder); a vocabulary sweep on 4 x 4 and 8 x 4 on
  both sides of each boundary (the lookups at about B_d S rows, the
  lookups' gradient at 2 B_d S n_m / (n_m + 1), the head's logits at the
  B c tokens of a loss chunk; untied, tied and the RWKV6 model); one-row
  decode (long_500k's batch) of the recurrent, split-KV and MoE
  architectures on 4 x 4 and 8 x 4; dbrx-132b's 4,096-token prefill on
  8 x 4 (the router's top-k gathers) and pixtral-12b's 256-token train
  step on 2 x 2 (the prefix's shift). All are compiled by
  ``_xla_programs.py`` in one subprocess at 32 forced host devices and
  read by the reference's analyzer, by the rule of
  ``_xla_programs.check_model``;
* against values computed by hand on the term functions: the lookups'
  boundary on each side, the embedding's and the head's terms in each
  regime, and one-row split-KV decode.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from _xla_programs import check_model, model_traffic, renamed, step_key

from repro.launch import hlo_analysis as RH
from repro_torch.configs import smoke_config
from repro_torch.launch import dryrun as D

ROOT = Path(__file__).resolve().parents[1]
EIGHT_BY_FOUR = [(arch, kind, 256, 8, (8, 4), None)
                 for arch in ("stablelm-3b", "recurrentgemma-9b", "dbrx-132b", "pixtral-12b",
                              "seamless-m4t-large-v2")
                 for kind in ("train", "prefill")]
#: vocabularies on each side of the boundaries at 256 x 8 tokens: on 4 x 4
#: the lookups move past 544 rows, their gradient past 819 and the logits
#: split past 2,048; on 8 x 4 the lookups move past 254 rows
SWEEP = ([("stablelm-3b", kind, 256, 8, (4, 4), {"vocab": v})
          for kind in ("train", "prefill") for v in (448, 1024)]
         + [("stablelm-3b", "train", 256, 8, (4, 4), {"vocab": 8192}),
            ("stablelm-3b", "train", 256, 8, (8, 4), {"vocab": 128}),
            ("recurrentgemma-9b", "train", 256, 8, (4, 4), {"vocab": 1024}),
            ("recurrentgemma-9b", "train", 256, 8, (4, 4), {"vocab": 8192}),
            ("rwkv6-7b", "train", 4096, 16, (4, 4), {"vocab": 8192})])
ONE_ROW = [(arch, "decode", 256, 1, dims, None)
           for arch in ("rwkv6-7b", "recurrentgemma-9b", "chatglm3-6b", "dbrx-132b",
                        "llama4-maverick-400b-a17b")
           for dims in ((4, 4), (8, 4))]
STEPS = (EIGHT_BY_FOUR + SWEEP + ONE_ROW
         + [("dbrx-132b", "prefill", 4096, 16, (8, 4), None),
            ("pixtral-12b", "train", 256, 8, (2, 2), None)])


@pytest.fixture(scope="module")
def hlo_texts(tmp_path_factory):
    """{name: compiled HLO text} of ``STEPS``, at 32 forced host devices
    in a subprocess."""
    path = tmp_path_factory.mktemp("hlo") / "hlo.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=32")
    steps = [[arch, kind, S, B, list(dims), widths] for arch, kind, S, B, dims, widths in STEPS]
    out = subprocess.run([sys.executable, str(ROOT / "tests" / "_xla_programs.py"), str(path),
                          json.dumps(steps)], env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("arch,kind,seq,batch,dims,widths", STEPS,
                         ids=[step_key(*step[:5], widths=step[5]) for step in STEPS])
def test_embedding_and_one_row_model_against_xla(hlo_texts, arch, kind, seq, batch, dims,
                                                 widths):
    """The per-device bytes within 10% of XLA's, each kind the model has
    within 10% (decode's all-reduces within 25%), the kinds it lacks under
    3%."""
    xla = RH.analyze(renamed(hlo_texts[step_key(arch, kind, seq, batch, dims, widths)])
                     ).coll_bytes
    check_model(kind, model_traffic(arch, kind, seq, batch, dims, widths), xla)


def _calls(fn, *args):
    """The (kind, count, result bytes, group) that ``fn`` adds."""
    out = []
    fn(lambda *call: out.append(call), *args)
    return out


def test_lookup_boundary_by_hand():
    """The lookups move where the table's share outweighs the rows and
    tokens they would move, the smaller of two boundaries: on 4 x 4 at
    8 x 256 tokens and 64 float32 columns, V D 4 (3/4 + 1/4) against
    B_d S D 4 + 4 B S, 544 rows; on 8 x 4, V D 4 (7/8) against
    B S D 4 (3/32) + 4 B S (31/32), 254.86 rows (the other, 256)."""
    assert not D.moves_lookups(544, 64, 4, 8, 256, 4, 4)
    assert D.moves_lookups(548, 64, 4, 8, 256, 4, 4)
    assert not D.moves_lookups(254, 64, 4, 8, 256, 8, 4)
    assert D.moves_lookups(256, 64, 4, 8, 256, 8, 4)
    # rwkv6-7b's train_4k on 16 x 16: 65,536 bf16 rows of 4,096 against
    # (16 x 4,096 x 8,192 + 4 x 256 x 4,096) / 8,192 = 66,048: the table
    # is gathered; dbrx-132b's 100,352 rows move the lookups
    assert not D.moves_lookups(65536, 4096, 2, 256, 4096, 16, 16)
    assert D.moves_lookups(100352, 6144, 2, 256, 4096, 16, 16)


def test_table_terms_by_hand():
    """The embedding's and the head's terms of stablelm-3b's smoke config
    (D = 64, float32) at 8 x 256 tokens on 4 x 4 (B_d = 2), on each side
    of the boundaries."""
    cfg = smoke_config("stablelm-3b")
    # 448 rows (114,688 bytes): the table gathered once, over 'data' (its
    # 'model' shard) then 'model'; its gradient reduced over both
    L = 448 * 64 * 4
    assert _calls(D._table_terms, cfg, "train", "embed", L, 4, 4, 8, 256, 4, 4, 4) == [
        ("all-gather", 1, L / 4, 4), ("all-gather", 1, L, 4),
        ("all-reduce", 1, L, 4), ("all-reduce", 1, L, 4)]
    # 1,024 rows: the int32 tokens [8, 64] (2,048) over 'data' and [8, 256]
    # (8,192) over 'model'; the rows found [8, 256, 16] (131,072)
    # all-reduced over 'model'; a device's rows [2, 64, 64] (32,768) moved
    # by an all-to-all and a permute (n_d = n_m). 1,280 > 2 B_d S = 1,024:
    # the gradient's rows [2, 256, 64] (131,072) gathered, moved by an
    # all-to-all and a permute, and, as V <= B S = 2,048, the table's
    # gradient [1,024, 16] (65,536) all-reduced over 'model'
    L = 1024 * 64 * 4
    assert _calls(D._table_terms, cfg, "train", "embed", L, 4, 4, 8, 256, 4, 4, 4) == [
        ("all-gather", 1, 2048, 4), ("all-gather", 1, 8192, 4), ("all-reduce", 1, 131072, 4),
        ("all-to-all", 1, 32768, 4), ("collective-permute", 1, 32768, 4),
        ("all-gather", 1, 131072, 4), ("all-to-all", 1, 131072, 4),
        ("collective-permute", 1, 131072, 4), ("all-reduce", 1, 65536, 4)]
    # prefill moves the same lookups, and no gradient
    assert _calls(D._table_terms, cfg, "prefill", "embed", L, 4, 4, 8, 256, 4, 4, 4) == [
        ("all-gather", 1, 2048, 4), ("all-gather", 1, 8192, 4), ("all-reduce", 1, 131072, 4),
        ("all-to-all", 1, 32768, 4), ("collective-permute", 1, 32768, 4)]
    # the head [64, 1,024] while V <= B c = 2,048: gathered whole, over
    # 'model' then 'data', twice; its gradient reduced over both
    assert _calls(D._table_terms, cfg, "train", "lm_head", L, 4, 4, 8, 256, 4, 4, 4) == [
        ("all-gather", 2, L / 4, 4), ("all-gather", 2, L, 4),
        ("all-reduce", 1, L, 4), ("all-reduce", 1, L, 4)]
    # [64, 8,192]: the logits split by the vocabulary; the weight's 'model'
    # shard (524,288) gathered over 'data' twice, its gradient reduced
    # over 'data'; the softmax's max and sum [2, 256] f32 (2,048) and the
    # final hidden states [2, 256, 64] (131,072) over 'model'
    L = 8192 * 64 * 4
    assert _calls(D._table_terms, cfg, "train", "lm_head", L, 4, 4, 8, 256, 4, 4, 4) == [
        ("all-gather", 2, L / 4, 4), ("all-reduce", 1, L / 4, 4), ("all-reduce", 2, 2048, 4),
        ("all-gather", 2, 131072, 4), ("all-reduce", 1, 131072, 4)]
    # prefill's head: the weight's 'model' shard over 'data'
    assert _calls(D._table_terms, cfg, "prefill", "lm_head", L, 4, 4, 8, 256, 4, 4, 4) == [
        ("all-gather", 1, L / 4, 4)]
    # 8 x 4 (n_d = 8, B_d = 1), 512 rows: the lookups' rows [1, 64, 64]
    # (16,384) go by two all-to-alls, over 'data' and over 'model'
    L = 512 * 64 * 4
    calls = _calls(D._table_terms, cfg, "prefill", "embed", L, 8, 4, 8, 256, 8, 4, 4)
    assert calls[-2:] == [("all-to-all", 1, 16384, 8), ("all-to-all", 1, 16384, 4)]


def test_one_row_split_kv_by_hand():
    """Split-KV decode of one row (B = 1), 2 layers, 16 query heads of 16,
    bf16: the query [16, 16] (512 bytes) gathered in two steps where two
    KV heads span g = 2 devices of 'model' of 4, else from a device list
    read as a pair; a shard of it (by 'model' for g > 1, else by the data
    axes) and a 'model' shard of the float32 output (256) permuted, the
    output's shard all-reduced, and the two statistics [16] f32 (64)."""
    wq = torch.empty(2, 64, 16, 16, dtype=torch.bfloat16, device="meta")
    wk = torch.empty(2, 64, 2, 16, dtype=torch.bfloat16, device="meta")
    assert _calls(D._one_row_split_kv_terms, wq, wk, 2, 1, 4, 4, 2) == [
        ("all-gather", 2, 256, 2), ("all-gather", 2, 512, 2),
        ("collective-permute", 2, 128, 4), ("collective-permute", 2, 256, 4),
        ("all-reduce", 2, 256, 4), ("all-reduce", 4, 64, 4)]
    wk = torch.empty(2, 64, 1, 16, dtype=torch.bfloat16, device="meta")
    assert _calls(D._one_row_split_kv_terms, wq, wk, 2, 1, 8, 4, 2) == [
        ("all-gather", 2, 512, 2), ("collective-permute", 2, 64, 4),
        ("collective-permute", 2, 256, 4), ("all-reduce", 2, 256, 4),
        ("all-reduce", 4, 64, 4)]
