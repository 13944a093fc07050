"""The dry run's collective model (``repro_torch.launch.dryrun.
collective_model``) at the production meshes' 'model' size, 16, on the
CPU: XLA's program of the reference's smoke steps on a ('data', 'model')
= (2, 16) mesh, compiled by ``_xla_programs.py`` in one subprocess at 32
forced host devices and read by the reference's analyzer, by the rule of
``_xla_programs.check_model``.

The smoke configs are widened so that 'model' splits what it splits in
production: 16 query heads, KV heads that 16 divides (16, so the cache
splits its heads) and that it does not (4: split-KV decode), and an MoE's
16 experts. Their train and decode steps of 256 x 8 tokens for five
architectures (dense, MoE, RWKV6, Griffin, two-KV-head attention), and the
4,096-token train steps whose 4 query chunks are fewer than the 16 'model'
devices, as production's train_4k's are (multi-head, grouped with at most
4 query heads a KV head, with more, and cross attention); and the terms
of those chunks by hand.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from _xla_programs import check_model, model_traffic, renamed, step_key

from repro.launch import hlo_analysis as RH
from repro_torch.launch import dryrun as D

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 16)
HEADS = ({"n_heads": 16, "n_kv_heads": 16, "n_experts": 16},
         {"n_heads": 16, "n_kv_heads": 4, "n_experts": 16})
STEPS = ([(arch, kind, 256, 8, widths)
          for arch in ("stablelm-3b", "dbrx-132b", "rwkv6-7b", "recurrentgemma-9b",
                       "chatglm3-6b")
          for kind in ("train", "decode") for widths in HEADS]
         + [("stablelm-3b", "train", 4096, 16, widths) for widths in HEADS]
         + [("chatglm3-6b", "train", 4096, 16, {"n_heads": 16, "n_kv_heads": 2}),
            ("seamless-m4t-large-v2", "train", 4096, 16, {"n_heads": 16, "n_kv_heads": 16})])


@pytest.fixture(scope="module")
def hlo_texts(tmp_path_factory):
    """{name: compiled HLO text} of ``STEPS`` on (2, 16), at 32 forced
    host devices in a subprocess."""
    path = tmp_path_factory.mktemp("hlo") / "hlo.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=32")
    steps = [[arch, kind, S, B, list(MESH), widths] for arch, kind, S, B, widths in STEPS]
    out = subprocess.run([sys.executable, str(ROOT / "tests" / "_xla_programs.py"), str(path),
                          json.dumps(steps)], env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("arch,kind,seq,batch,widths", STEPS,
                         ids=[step_key(*step[:4], MESH, step[4]) for step in STEPS])
def test_collective_model_against_xla_at_sixteen_model_devices(hlo_texts, arch, kind, seq,
                                                               batch, widths):
    """The per-device bytes within 10% of XLA's, each kind the model has
    within 10% (decode's all-reduces within 25%), the kinds it lacks under
    3%."""
    xla = RH.analyze(renamed(hlo_texts[step_key(arch, kind, seq, batch, MESH, widths)])
                     ).coll_bytes
    check_model(kind, model_traffic(arch, kind, seq, batch, MESH, widths), xla)


def _calls(fn, *args):
    """The (kind, count, result bytes, group) that ``fn`` adds."""
    out = []
    fn(lambda *call: out.append(call), *args)
    return out


def test_chunk_split_terms_by_hand():
    """Train of 2 layers of 4,096 tokens in k = 4 query chunks of c = 1,024
    on 'model' of 16 (p = 4 devices a chunk), B_d = 16, bf16, 32 query
    heads: Q [16, 4,096, 32, 80] (q = 335,544,320 bytes) and the
    statistics [16, 32, 4,096] f32 (st = 8,388,608). A device list is read
    as a pair (group 2)."""
    q, st = 335544320, 8388608
    mha = [("all-gather", 8, q / 4, 4), ("all-gather", 16, q / 4, 4),
           ("all-reduce", 24, q / 4, 2), ("all-reduce", 24, q / 16, 2),
           ("all-reduce", 40, st / 4, 16), ("all-gather", 16, q / 4, 2)]
    assert _calls(D._chunk_split_terms, True, 2, 16, 4096, 4096, 32, 32, 80, 16, 2) == mha
    # 8 KV heads of 80 (4 query heads each, at most k): the chunks'
    # statistics gathered over their 4 devices, a chunk of K
    # [16, 1,024, 8, 80] over a list, and the f32 scores of a chunk's
    # queries [16, 32, 256, 1,024] moved twice
    kv = 16 * 4096 * 8 * 80 * 2
    assert _calls(D._chunk_split_terms, True, 2, 16, 4096, 4096, 32, 8, 80, 16, 2) == mha + [
        ("all-gather", 8, st / 4, 4), ("all-gather", 2, kv / 4, 2),
        ("all-to-all", 16, 16 * 32 * 256 * 1024 * 4, 4)]
    # 2 KV heads (16 query heads each, more than k): K's chunks over lists
    # and its p devices, dK and dV reduced over them, the outputs' and
    # statistics' p-th parts over the k chunks' devices, the outputs' once
    # more over a list
    kv = 16 * 4096 * 2 * 80 * 2
    assert _calls(D._chunk_split_terms, True, 2, 16, 4096, 4096, 32, 2, 80, 16, 2) == [
        ("all-gather", 8, q / 4, 4), ("all-gather", 10, kv / 4, 2),
        ("all-reduce", 16, q / 16, 4), ("all-reduce", 40, st / 16, 4),
        ("all-gather", 2, kv / 4, 4), ("all-reduce", 8, 2 * kv / 4, 4),
        ("all-reduce", 8, q / 16, 2)]
    # prefill, multi-head: Q's quarter once, each chunk's queries once,
    # the outputs once, the statistics twice
    assert _calls(D._chunk_split_terms, False, 2, 16, 4096, 4096, 32, 32, 80, 16, 2) == [
        ("all-gather", 2, q / 4, 4), ("all-gather", 8, q / 4, 4), ("all-reduce", 8, q / 4, 2),
        ("all-reduce", 8, q / 16, 2), ("all-reduce", 16, st / 4, 16)]
