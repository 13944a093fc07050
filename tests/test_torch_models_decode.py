"""The port's ``decode_step`` against the reference's, on the CPU, at each
architecture's reduced config (``smoke_config``).

The reference's ``init_params(cfg, PRNGKey(0))``, its constant leaves
drawn at random (``_torch_lm.spread_params``), is carried across
(``params_from_numpy``); both packages start from an empty float32 cache
(seamless-m4t-large-v2's cross-attention K/V filled from each package's
own encoder over the same ``src_embeds``) and decode the same 16 tokens
of two rows, the reference through a jitted step as its serve driver
runs it. Each step's logits, and the cache after the last step, must lie
within 2e-5 of the largest |reference| value (``test_torch_models.py``
says why; the largest difference is 4.4e-6, recurrentgemma-9b). This
file is apart from that one so that the test workers spread the
reference's compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import spread_params
from repro.configs import smoke_config as ref_smoke_config
from repro.models import model as RM
from repro.models.layers import rms_norm as ref_rms_norm
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.models import model as M

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
TOL = 2e-5
B, STEPS = 2, 16


def _close(got, want, label):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / (scale if scale else 1.0)
    assert err < TOL, f"{label}: {err:.3g} of max |ref|"


def _ref_cache(rcfg, rp, src):
    cache = RM.init_cache(rcfg, B, STEPS, dtype=jnp.float32)
    if src is None:
        return cache
    m = RM._run_groups(rcfg, rp["enc_groups"], [(("attn",), rcfg.n_encoder_layers)], src,
                       causal=False, memory=None, act_spec=None, remat=False)
    memory = ref_rms_norm(rp["enc_final_norm"], m)
    out = []
    for gp, gc in zip(rp["groups"], cache):
        gc = dict(gc)
        ent = dict(gc["attn0"])
        ent["ck"] = jnp.einsum("bsd,ndgk->nbsgk", memory, gp["attn0"]["cwk"])
        ent["cv"] = jnp.einsum("bsd,ndgk->nbsgk", memory, gp["attn0"]["cwv"])
        gc["attn0"] = ent
        out.append(gc)
    return out


def _port_cache(cfg, params, src):
    cache = M.init_cache(cfg, B, STEPS, dtype=torch.float32, device="cpu")
    if src is not None:
        memory = M.encode(cfg, params, src)
        for gp, gc in zip(params["groups"], cache):
            gc["attn0"]["ck"].copy_(torch.einsum("bsd,ndgk->nbsgk", memory, gp["attn0"]["cwk"]))
            gc["attn0"]["cv"].copy_(torch.einsum("bsd,ndgk->nbsgk", memory, gp["attn0"]["cwv"]))
    return cache


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_steps_match_reference(arch):
    rcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    spread = spread_params(jax.tree.map(np.asarray, RM.init_params(rcfg, KEY)))
    rp = jax.tree.map(jnp.asarray, spread)
    params = M.params_from_numpy(spread, "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (B, STEPS)).astype(np.int32)
    src = None
    if cfg.n_encoder_layers:
        src = (rng.normal(size=(B, 4, cfg.d_model)) * 0.1).astype(np.float32)

    step = jax.jit(lambda p, c, tok, pos: RM.decode_step(rcfg, p, c, tok, pos))
    rcache = _ref_cache(rcfg, rp, None if src is None else jnp.asarray(src))
    cache = _port_cache(cfg, params, None if src is None else torch.from_numpy(src))
    for t in range(STEPS):
        want, rcache = step(rp, rcache, jnp.asarray(tokens[:, t : t + 1]), jnp.int32(t))
        got, cache = M.decode_step(cfg, params, cache, torch.from_numpy(tokens[:, t : t + 1]), t)
        assert got.dtype == torch.float32
        _close(got, want, f"{arch} step {t} logits")
    for gi, (gc, wc) in enumerate(zip(cache, rcache)):
        for name, ent in gc.items():
            for leaf, val in ent.items():
                label = f"{arch} group {gi} {name} {leaf}"
                if leaf == "pos":
                    np.testing.assert_array_equal(val.numpy(), np.asarray(wc[name][leaf]), label)
                else:
                    _close(val, wc[name][leaf], label)
