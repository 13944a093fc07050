"""The dry run's collective model (``repro_torch.launch.dryrun.
collective_model``) against XLA's program of the reference's smoke steps
on meshes past 2 x 2, on the CPU. The production meshes are 16 x 16
(n_d = n_m) and 2 x 16 x 16 (n_d = 2 n_m); 4 x 4 and 8 x 4 hold their
ratios at smoke size, and 2 x 4 a 'model' axis of more than two devices
that the data axes do not match:

* rwkv6-7b's and recurrentgemma-9b's five steps on 4 x 4, their
  4,096-token steps and decode on 8 x 4 and their 256-token train step on
  2 x 4 (where the token shift's halo grows and the RG-LRU's input is
  gathered once more);
* split-KV decode of an attention architecture (chatglm3-6b: two KV heads
  over 'model' of 4) with wk and wv re-split (2 x 4, 4 x 4) and gathered
  (8 x 4);
* decode of a dense (stablelm-3b) and an MoE (dbrx-132b) architecture on
  4 x 4 and 8 x 4: wk's and wv's shard of the cache's heads, the
  row-parallel products' input rows or, for the MoE, weights;
* decode of one row, which the data axes do not split (long_500k's
  batch), for two attention architectures on 4 x 4.

All are compiled by ``_xla_programs.py`` in one subprocess at 32 forced
host devices and read by the reference's analyzer, by the rule of
``test_collective_model_against_xla`` (``_xla_programs.check_model``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from _xla_programs import STEPS, check_model, model_traffic, renamed, step_key

from repro.launch import hlo_analysis as RH

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("rwkv6-7b", "recurrentgemma-9b")
LONG = (("train", 4096, 16), ("prefill", 4096, 16), ("decode", 256, 8))
MESH_STEPS = ([(arch, *step, (4, 4)) for arch in ARCHS for step in STEPS]
              + [(arch, *step, (8, 4)) for arch in ARCHS for step in LONG]
              + [(arch, "train", 256, 8, (2, 4)) for arch in ARCHS]
              + [("chatglm3-6b", "decode", 256, 8, dims) for dims in ((2, 4), (4, 4), (8, 4))]
              + [(arch, "decode", 256, 8, dims) for arch in ("stablelm-3b", "dbrx-132b")
                 for dims in ((4, 4), (8, 4))]
              + [(arch, "decode", 256, 1, (4, 4)) for arch in ("stablelm-3b", "h2o-danube-3-4b")])


@pytest.fixture(scope="module")
def hlo_texts(tmp_path_factory):
    """{name: compiled HLO text} of ``MESH_STEPS``, at 32 forced host
    devices in a subprocess."""
    path = tmp_path_factory.mktemp("hlo") / "hlo.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=32")
    steps = [[arch, kind, S, B, list(dims)] for arch, kind, S, B, dims in MESH_STEPS]
    out = subprocess.run([sys.executable, str(ROOT / "tests" / "_xla_programs.py"), str(path),
                          json.dumps(steps)], env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("arch,kind,seq,batch,dims", MESH_STEPS,
                         ids=[step_key(*step) for step in MESH_STEPS])
def test_collective_model_against_xla_on_wider_meshes(hlo_texts, arch, kind, seq, batch, dims):
    """The per-device bytes within 10% of XLA's, each kind the model has
    within 10% (decode's all-reduces within 25%), the kinds it lacks under
    3%."""
    xla = RH.analyze(renamed(hlo_texts[step_key(arch, kind, seq, batch, dims)])).coll_bytes
    check_model(kind, model_traffic(arch, kind, seq, batch, dims), xla)
