"""The port's real-model serve driver (``repro_torch.launch.serve``) against
the reference's (``repro.launch.serve``), on the CPU at reduced configs.

``main`` must fold exactly (isolated and folded outputs identical) and
count the prefill tokens the reference's driver counts on the same
arguments; ``RealExecutor.prefill_cache`` must give the reference's
logits within 1e-4 of their largest |value| with the reference's
parameters carried across; ``fork`` must copy, since the port's decode
writes its cache in place; and the entry points must refuse the card
where there is none.
"""

import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.launch import serve as ref_serve
from repro.models import model as RM
from repro_torch.configs import smoke_config
from repro_torch.launch import serve
from repro_torch.models import model as M

torch.set_num_threads(2)

ARGS = ["--requests", "3", "--prefix-len", "24", "--suffix-len", "4", "--decode", "3"]


def _prefill_counts(out):
    return [int(n) for n in re.findall(r"(\d+) prefill tokens", out)]


def test_serve_driver_folding_exactness(capsys):
    serve.main(["--device", "cpu"] + ARGS)
    out = capsys.readouterr().out
    assert "outputs identical: True" in out
    assert _prefill_counts(out) == [3 * 28, 24 + 3 * 4]


def test_prefill_token_counts_match_reference_driver(capsys):
    ref_serve.main(ARGS)
    want = _prefill_counts(capsys.readouterr().out)
    serve.main(["--device", "cpu"] + ARGS)
    got = _prefill_counts(capsys.readouterr().out)
    assert got == want and len(got) == 2


@pytest.mark.parametrize("arch", ["stablelm-3b", "recurrentgemma-9b"])
def test_prefill_cache_matches_reference(arch):
    rcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    params = M.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, 20)
    _, want = ref_serve.RealExecutor(rcfg, rp).prefill_cache(tokens)
    ex = serve.RealExecutor(cfg, params, device="cpu")
    _, got = ex.prefill_cache(tokens)
    want = np.asarray(want)
    assert got.shape == want.shape and ex.prefill_tokens_computed == 20
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-4


def test_fork_does_not_alias_the_prefix_cache():
    cfg = smoke_config("recurrentgemma-9b")  # ring KV and recurrent state
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ex = serve.RealExecutor(cfg, params, device="cpu")
    prefix, logits = ex.prefill_cache(np.arange(12))
    leaves = lambda c: [t for g in c for ent in g.values() for t in ent.values()]  # noqa: E731
    before = [t.clone() for t in leaves(prefix)]
    forked = serve.fork(prefix)
    ex.decode(forked, logits, 12, 4)
    assert all(torch.equal(a, b) for a, b in zip(leaves(prefix), before))
    assert not all(torch.equal(a, b) for a, b in zip(leaves(forked), before))


def test_decode_step_writes_the_cache_in_place():
    """What makes ``fork`` necessary: without it, a decode moves the
    prefix cache's bits."""
    cfg = smoke_config("stablelm-3b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = M.init_cache(cfg, 1, 8, dtype=torch.float32, device="cpu")
    k = cache[0]["attn0"]["k"]
    _, out = M.decode_step(cfg, params, cache, torch.tensor([[3]]), 0)
    assert out is cache and out[0]["attn0"]["k"] is k
    assert k[:, :, 0].abs().sum() > 0 and int(cache[0]["attn0"]["pos"][0, 0]) == 0


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the entry points run on it")
    cfg = smoke_config("stablelm-3b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        serve.RealExecutor(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA card"):
        serve.serve_fold(cfg, params, np.arange(4), [np.arange(6)], 1)
    with pytest.raises(RuntimeError, match="CUDA card"):
        M.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA card"):
        M.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA card"):
        serve.main(ARGS)
