"""The port's model zoo (``repro_torch.configs``, ``repro_torch.models``)
against the reference's, on the CPU, at each architecture's reduced
config (``smoke_config``).

The reference's ``init_params(cfg, PRNGKey(0))`` is carried across as
numpy arrays (``params_from_numpy``) after its constant leaves (norms,
the RWKV decay base and mixes, the conv bias) are drawn at random
(``_torch_lm.spread_params``): at their initial values the RWKV head
norm's zero weight zeroes the whole time-mix, so no comparison could see
it. Both packages get the same inputs: the reference test's ``_batch``
(``tests/test_models.py``), with ``prefix_embeds`` and ``src_embeds`` where
the config has them. The final hidden states, the loss, and ``prefill``'s
logits and K/V must lie within ``TOL`` = 2e-5 of the largest |reference|
value of each output; MoE routing must choose the same experts.

Why 2e-5: on the CPU the port differs from the reference by at most
7.0e-6 (recurrentgemma-9b's hidden states) where both sum the same
float32 products in other orders, and in a mutation check an erf GELU in
place of the tanh form moved starcoder2-7b's hidden states by only
3.6e-5 (seamless-m4t-large-v2 1.2e-4, recurrentgemma-9b 4.2e-3), which
1e-4 would let pass. rwkv6-7b's hidden states are held to ``RWKV_TOL`` =
2e-3: its chunked time-mix rounds its products' inputs to bf16 as the
reference does, and inputs that differ in their last float32 bit round
apart (the port differs from the reference by 4.6e-4 over the model; the
reference's one time-mix layer, jitted against eager, by 3.6e-5); in the
mutation check a biased variance moved them by 6.0e-2, leaving out the
rounding by 1.5e-2.
``test_torch_models_decode.py`` holds the decode steps. The rest are the
reference's own model tests, run on the port alone.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import spread_params
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models import model as RM
from repro.models.layers import attention as ref_attention
from repro.models.layers import rms_norm as ref_rms_norm
from repro_torch.configs import ARCH_IDS, cells, get_config, smoke_config
from repro_torch.models import layers, moe
from repro_torch.models import model as M

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
#: of the largest |reference| value of each output (the docstring says why)
TOL = 2e-5
RWKV_TOL = 2e-3
MOE_ARCHS = [a for a in ARCH_IDS if get_config(a).moe is not None]


def _batch(cfg, B=2, S=32):
    """The reference test's inputs, as numpy arrays."""
    specs = RM.input_specs(cfg, {"kind": "train", "seq_len": S, "global_batch": B},
                           dtype=jnp.float32)
    batch = {}
    for k, v in specs.items():
        if v.dtype == jnp.int32:
            batch[k] = jax.random.randint(KEY, v.shape, 0, cfg.vocab)
        else:
            batch[k] = jax.random.normal(KEY, v.shape, v.dtype) * 0.1
    return {k: np.asarray(v) for k, v in batch.items()}


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(reference params as numpy, inputs, reference outputs) of ``arch``."""
    rcfg = ref_smoke_config(arch)
    rp = jax.tree.map(jnp.asarray, spread_params(_to_np(RM.init_params(rcfg, KEY))))
    batch = _batch(rcfg)
    pre = {k: v for k, v in batch.items() if k != "targets"}

    @jax.jit
    def run(params, batch, pre):
        return (RM.forward_train(rcfg, params, batch), RM.loss_fn(rcfg, params, batch),
                RM.prefill(rcfg, params, pre))

    hidden, loss, (logits, caches) = _to_np(run(rp, batch, pre))
    return _to_np(rp), batch, {"hidden": hidden, "loss": loss, "logits": logits,
                               "caches": caches}


def _port(arch):
    params, batch, want = _reference(arch)
    return smoke_config(arch), M.params_from_numpy(params, "cpu"), _torch(batch), want


def _close(got, want, label="", tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < tol, f"{label}: {err:.3g} of max |ref|"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch):
    cfg, params, batch, want = _port(arch)
    tol = RWKV_TOL if arch == "rwkv6-7b" else TOL
    _close(M.forward_train(cfg, params, batch), want["hidden"], arch, tol)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_matches_reference(arch):
    cfg, params, batch, want = _port(arch)
    got = M.loss_fn(cfg, params, batch)
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want["loss"], arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_matches_reference(arch):
    cfg, params, batch, want = _port(arch)
    logits, caches = M.prefill(cfg, params, {k: v for k, v in batch.items() if k != "targets"})
    _close(logits, want["logits"], arch)
    assert len(caches) == len(want["caches"])
    for gi, (gc, wc) in enumerate(zip(caches, want["caches"])):
        assert sorted(gc) == sorted(wc)
        for name in gc:
            for kv in ("k", "v"):
                _close(gc[name][kv], wc[name][kv], f"{arch} group {gi} {name} {kv}")


def _ref_routes(rcfg, rp, x):
    """The experts the reference's router picks at each MoE layer, walking
    its blocks one repetition at a time."""
    out = []
    for (pattern, n_rep), gp in zip(RM.layer_groups(rcfg), rp["groups"]):
        for r in range(n_rep):
            for i, kind in enumerate(pattern):
                p = jax.tree.map(lambda a: a[r], gp[f"{kind}{i}"])
                if "router" in p:
                    h = x + ref_attention(p, ref_rms_norm(p["ln1"], x), rcfg,
                                          window=rcfg.attn_window)
                    h = ref_rms_norm(p["ln2"], h)
                    gates = jax.nn.softmax(jnp.einsum("bsd,de->bse", h, p["router"]), axis=-1)
                    out.append(jax.lax.top_k(gates, rcfg.moe.top_k)[1])
                x = RM._block_apply(rcfg, kind, p, x)
    return out


def _port_routes(cfg, params, x):
    out = []
    for (pattern, n_rep), gp in zip(M.layer_groups(cfg), params["groups"]):
        for r in range(n_rep):
            for i, kind in enumerate(pattern):
                p = M._rep(gp, r)[f"{kind}{i}"]
                if "router" in p:
                    h = x + layers.attention(p, layers.rms_norm(p["ln1"], x), cfg,
                                             window=cfg.attn_window)
                    out.append(moe.route(p, layers.rms_norm(p["ln2"], h), cfg)[1].numpy())
                x = M._block_apply(cfg, kind, p, x)
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layers_choose_the_reference_experts(arch):
    cfg, params, batch, _ = _port(arch)
    rcfg = ref_smoke_config(arch)
    rp = jax.tree.map(jnp.asarray, _reference(arch)[0])
    tokens = batch["tokens"]
    routes = jax.jit(lambda rp, x: _ref_routes(rcfg, rp, x))
    want = _to_np(routes(rp, rp["embed"][jnp.asarray(tokens.numpy())]))
    got = _port_routes(cfg, params, params["embed"][tokens])
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_reference_with_drops(arch):
    """At the config's capacity factor some assignments are dropped; the
    scatter into E*C + 1 slots must drop the same ones."""
    from repro.models.moe import moe_ffn as ref_moe_ffn

    cfg, params, _, _ = _port(arch)
    rcfg = ref_smoke_config(arch)
    rp = _reference(arch)[0]
    name = next(n for n, p in rp["groups"][0].items() if "router" in p)
    p_np = {k: v[0] for k, v in rp["groups"][0][name].items()}
    rng = np.random.default_rng(0)
    # tokens near one direction favour the same experts, which overflow
    x = (rng.normal(size=cfg.d_model) + 0.3 * rng.normal(size=(2, 32, cfg.d_model)))
    x = x.astype(np.float32)
    want = np.asarray(ref_moe_ffn(jax.tree.map(jnp.asarray, p_np), jnp.asarray(x), rcfg))
    got = moe.moe_ffn(M.params_from_numpy(p_np, "cpu"), torch.from_numpy(x), cfg)
    _close(got, want, arch)
    _, topi = moe.route(M.params_from_numpy(p_np, "cpu"), torch.from_numpy(x), cfg)
    C = int(np.ceil(32 * cfg.moe.top_k / cfg.moe.n_experts * cfg.moe.capacity_factor))
    most = max(np.bincount(row.ravel(), minlength=cfg.moe.n_experts).max()
               for row in topi.numpy())
    assert most > C, "no expert of a row overflows: the drop path is not exercised"


def test_params_round_trip_and_init_rules():
    cfg = smoke_config("rwkv6-7b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    back = M.params_from_numpy(M.params_to_numpy(params), "cpu")
    flat = jax.tree.leaves(M.params_to_numpy(back))
    assert len(flat) == len(jax.tree.leaves(M.params_to_numpy(params)))
    defs = M.param_defs(cfg)
    assert jax.tree.map(lambda t: tuple(t.shape), M.params_to_numpy(params)) == defs
    blk = params["groups"][0]["rwkv0"]
    assert torch.all(blk["ln1"] == 0) and torch.all(blk["w_dec0"] == 0)
    assert torch.all(blk["mu_r"] == 0.5)
    rec = M.init_params(smoke_config("recurrentgemma-9b"), torch.Generator().manual_seed(1),
                        device="cpu")["groups"][0]["rec0"]["lam"]
    assert -4.0 <= float(rec.min()) and float(rec.max()) <= -2.0
    embed = params["embed"]
    assert abs(float(embed.std()) - 0.02) < 0.002
    assert M.abstract_params(cfg)["embed"].device.type == "meta"
    assert M.abstract_cache(cfg, 2, 16)[0]["rwkv0"]["S"].shape == (2, 2, 4, 16, 16)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_and_cache_match_reference(kind):
    """The stand-ins for a workload's inputs and the decode cache have the
    reference's shapes and dtypes, as storage-less ``meta`` tensors."""
    shape = {"kind": kind, "seq_len": 2048, "global_batch": 4}
    for arch in ("pixtral-12b", "seamless-m4t-large-v2", "recurrentgemma-9b", "rwkv6-7b"):
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        got = M.input_specs(cfg, shape)
        want = RM.input_specs(rcfg, shape)
        assert sorted(got) == sorted(want), arch
        for k, t in got.items():
            assert t.device.type == "meta" and tuple(t.shape) == want[k].shape, (arch, k)
            assert str(t.dtype).split(".")[1] == str(want[k].dtype), (arch, k)
        got_c = M.abstract_cache(cfg, 2, 4096)
        want_c = RM.abstract_cache(rcfg, 2, 4096)
        for g, w in zip(got_c, want_c):
            for name in w:
                for leaf, sd in w[name].items():
                    t = g[name][leaf]
                    assert tuple(t.shape) == sd.shape, (arch, name, leaf)
                    assert str(t.dtype).split(".")[1] == str(sd.dtype), (arch, name, leaf)


def test_rwkv_time_mix_dead_at_init_and_rounded_when_live():
    """Why the parity tests draw the constant leaves: at the reference's
    init the RWKV head norm's weight is zero, so the time-mix outputs
    zeros in both packages; drawn, it is live, and decode (float32) parts
    from the chunked forward (bf16-rounded products) by the same gap in
    both."""
    from repro.models import recurrent as ref_recurrent
    from repro_torch.models import recurrent

    cfg, rcfg = smoke_config("rwkv6-7b"), ref_smoke_config("rwkv6-7b")
    init = _to_np(RM.init_params(rcfg, KEY))
    x = np.random.default_rng(0).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16))
    gaps = []
    for tree in (init, spread_params(init)):
        p = {k: v[0] for k, v in tree["groups"][0]["rwkv0"].items()}
        want = np.asarray(ref_recurrent.rwkv_time_mix(jax.tree.map(jnp.asarray, p),
                                                      jnp.asarray(x), rcfg))
        got = recurrent.rwkv_time_mix(M.params_from_numpy(p, "cpu"), torch.from_numpy(x), cfg)
        gaps.append([_ref_decode_gap(rcfg, jax.tree.map(jnp.asarray, tree), tokens),
                     _decode_gap(cfg, M.params_from_numpy(tree, "cpu"),
                                 torch.from_numpy(tokens))])
        if tree is init:
            assert not want.any() and not got.any()
    (ref_init, port_init), (ref_live, port_live) = gaps
    assert ref_init < 1e-5 and port_init < 1e-5
    assert ref_live > 1e-3 and abs(port_live - ref_live) < 0.2 * ref_live, gaps


@functools.lru_cache(maxsize=None)
def _ref_jitted(arch):
    cfg = ref_smoke_config(arch)
    forward = jax.jit(lambda p, tok: jnp.einsum(
        "bsd,dv->bsv", RM.forward_train(cfg, p, {"tokens": tok}), RM.lm_head_weight(cfg, p)))
    step = jax.jit(lambda p, c, tok, pos: RM.decode_step(cfg, p, c, tok, pos))
    return forward, step


def _ref_decode_gap(cfg, params, tokens):
    """max |decode - forward| over max |forward|, of the reference's logits."""
    forward, step = _ref_jitted(cfg.name)
    want = np.asarray(forward(params, tokens))
    cache = RM.init_cache(cfg, tokens.shape[0], tokens.shape[1], dtype=jnp.float32)
    outs = []
    for t in range(tokens.shape[1]):
        lg, cache = step(params, cache, tokens[:, t : t + 1], jnp.int32(t))
        outs.append(np.asarray(lg[:, 0]))
    return float(np.abs(np.stack(outs, axis=1) - want).max() / np.abs(want).max())


def _decode_gap(cfg, params, tokens):
    """The same of the port's."""
    fwd = torch.einsum("bsd,dv->bsv", M.forward_train(cfg, params, {"tokens": tokens}),
                       M.lm_head_weight(cfg, params))
    cache = M.init_cache(cfg, tokens.shape[0], tokens.shape[1], dtype=torch.float32, device="cpu")
    dec = _decode_all(cfg, params, cache, tokens)
    return float((dec - fwd).abs().max() / fwd.abs().max())


# ---------------------------------------------------------------------------
# The reference's model tests, on the port alone
# ---------------------------------------------------------------------------


def _port_params(cfg, seed=0):
    return M.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")


def _decode_all(cfg, params, cache, tokens):
    outs = []
    for t in range(tokens.shape[1]):
        lg, cache = M.decode_step(cfg, params, cache, tokens[:, t : t + 1], t)
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1)


def _fill_cross(cfg, params, cache, memory):
    """Cross-attention K/V of the encoder memory in every decoder layer."""
    for gp, gc in zip(params["groups"], cache):
        p, c = gp["attn0"], gc["attn0"]
        c["ck"].copy_(torch.einsum("bsd,ndgk->nbsgk", memory, p["cwk"]))
        c["cv"].copy_(torch.einsum("bsd,ndgk->nbsgk", memory, p["cwv"]))


@pytest.mark.parametrize(
    "arch",
    ["h2o-danube-3-4b", "rwkv6-7b", "recurrentgemma-9b", "chatglm3-6b", "stablelm-3b",
     "seamless-m4t-large-v2"],
)
def test_decode_matches_forward(arch):
    cfg = smoke_config(arch)
    params = _port_params(cfg)
    B, S = 2, 16
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    batch = {"tokens": tokens}
    if cfg.n_encoder_layers:
        batch["src_embeds"] = torch.from_numpy(
            rng.normal(size=(B, 4, cfg.d_model)).astype(np.float32) * 0.1)
    hidden = M.forward_train(cfg, params, batch)
    ref = torch.einsum("bsd,dv->bsv", hidden, M.lm_head_weight(cfg, params))
    cache = M.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    if cfg.n_encoder_layers:
        _fill_cross(cfg, params, cache, M.encode(cfg, params, batch["src_embeds"]))
    dec = _decode_all(cfg, params, cache, tokens)
    rel = float((dec - ref).abs().max() / ref.abs().max())
    assert rel < 1e-3, f"{arch}: decode/forward rel err {rel}"


def test_ring_buffer_window_decode():
    """SWA ring-buffer decode beyond the window: positions wrap, masking by
    stored position stays correct vs full forward."""
    cfg = smoke_config("h2o-danube-3-4b")
    assert cfg.attn_window == 16
    params = _port_params(cfg)
    B, S = 1, 40  # > 2x window
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S)))
    hidden = M.forward_train(cfg, params, {"tokens": tokens})
    ref = torch.einsum("bsd,dv->bsv", hidden, M.lm_head_weight(cfg, params))
    cache = M.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")  # capacity = window
    assert cache[0]["attn0"]["k"].shape[2] == 16
    dec = _decode_all(cfg, params, cache, tokens)
    rel = float((dec - ref).abs().max() / ref.abs().max())
    assert rel < 1e-3, rel


def test_cells_cover_assignment():
    """40 assigned cells: long_500k only for sub-quadratic archs."""
    cs = cells()
    assert len(cs) == 33  # 10 archs x 4 shapes - 7 skipped long_500k
    subq = {a for a, s in cs if s == "long_500k"}
    assert subq == {"recurrentgemma-9b", "h2o-danube-3-4b", "rwkv6-7b"}


def test_param_counts_sane():
    for arch in ARCH_IDS:
        c = get_config(arch).param_counts()
        assert c["total"] >= c["active"] > 0
    big = get_config("llama4-maverick-400b-a17b").param_counts()
    assert 3.0e11 < big["total"] < 5.5e11, big  # ~400B
    assert 1.0e10 < big["active"] < 3.5e10, big  # ~17B + attn/embed


def test_param_counts_match_the_tree():
    """``param_counts`` is the parameter tree's size, by the reference's
    count (total over padded vocab and heads)."""
    for arch in ("stablelm-3b", "starcoder2-7b"):
        cfg = get_config(arch)
        n = sum(t.numel() for t in jax.tree.leaves(
            M.abstract_params(cfg), is_leaf=lambda x: isinstance(x, torch.Tensor)))
        norms = (2 * cfg.n_layers + 1) * cfg.d_model
        assert n - norms == cfg.param_counts()["total"], arch


def test_long_sequence_paths_match_reference():
    """Beyond ``QCHUNK_THRESHOLD`` attention runs QCHUNK queries at a time,
    and beyond ``RG_CHUNK`` the RG-LRU carries its state across chunks:
    both against the reference, at 3,072 (window 1,500) and 1,024
    positions."""
    from repro.models import layers as ref_layers
    from repro.models import recurrent as ref_recurrent
    from repro_torch.models import recurrent

    cfg, rcfg = smoke_config("h2o-danube-3-4b"), ref_smoke_config("h2o-danube-3-4b")
    rp = _reference("h2o-danube-3-4b")[0]
    p = {k: v[0] for k, v in rp["groups"][0]["attn0"].items()}
    x = np.random.default_rng(0).normal(size=(1, 3072, cfg.d_model)).astype(np.float32)
    ref_attn = jax.jit(lambda p, x: ref_layers.attention(p, x, rcfg, window=1500))
    want = np.asarray(ref_attn(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    got = layers.attention(M.params_from_numpy(p, "cpu"), torch.from_numpy(x), cfg, window=1500)
    _close(got, want, "attention over 3 query chunks")

    rec = {k: v[0] for k, v in _reference("recurrentgemma-9b")[0]["groups"][0]["rec0"].items()}
    x = np.random.default_rng(1).normal(size=(2, 1024, rec["lam"].shape[0])).astype(np.float32)
    want = np.asarray(jax.jit(ref_recurrent.rg_lru)(jax.tree.map(jnp.asarray, rec),
                                                     jnp.asarray(x)))
    got = recurrent.rg_lru(M.params_from_numpy(rec, "cpu"), torch.from_numpy(x))
    _close(got, want, "rg_lru over two chunks")
