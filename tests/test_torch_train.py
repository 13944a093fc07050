"""The port's gradients, optimizer and remat (``repro_torch.train``:
``train_step.value_and_grad``, ``optim``; the remat of
``models.model``) against the reference's (``repro.train``), on the CPU,
at each architecture's reduced config (``smoke_config``). The three-step
trajectories are in ``test_torch_train_launch.py``.

Both packages start from the reference's ``init_params(cfg, PRNGKey(0))``
with its constant leaves drawn at random (``_torch_lm.spread_params``),
carried across as numpy arrays, and get the same batches:
``batch_at(step, seed=1, global_batch=4, seq_len=32, structured=True)``,
with ``prefix_embeds`` and ``src_embeds`` drawn by numpy where the config
has them. The reference runs jitted; the port eagerly.

Limits, and why:

* Gradients (``test_gradients_match_reference``): every element within
  ``GRAD_TOL`` = 1e-5 of the reference gradient tree's global norm. The
  tree's norm and not each leaf's largest value, because
  llama4-maverick-400b-a17b's router gradient is analytically zero (top-1
  gates renormalize to exactly 1) and both packages return rounding noise
  for it, ~1e-10. Measured: at most 2.0e-6 (recurrentgemma-9b). rwkv6-7b
  is held to ``RWKV_GRAD_TOL`` = 5e-3 of the norm (measured 1.5e-3): its
  chunked time-mix rounds its products' inputs, and their cotangents, to
  bf16 as the reference does, and inputs that differ in their last
  float32 bit round apart; the rounding's own effect on its gradient is
  1.2e-2 of the norm. With the rounding taken out of both packages its
  gradients agree within ``GRAD_TOL`` (measured 1.8e-6,
  ``test_rwkv_gradients_match_without_bf16_rounding``).
* ``adamw_update`` alone: bit for bit where the gradient is not clipped.
  Where it is, the global norm (summed in another order) may differ by a
  few ulps (held to 8, measured 3), and so may the clip scale: the
  parameters within 1 ulp, the
  moments within 1e-6 of each leaf's largest |value| (``m`` = 0.9 m +
  0.1 g cancels where the two terms are near opposite; measured 9.7e-8).
* Remat on and off: bit for bit (the same float32 operations recomputed).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models.recurrent as ref_recurrent
from _torch_lm import spread_params, train_batch
from repro.configs import smoke_config as ref_smoke_config
from repro.models import model as RM
from repro.train.optim import adamw_update as ref_adamw_update
from repro.train.optim import global_norm as ref_global_norm
from repro.train.optim import init_opt_state as ref_init_opt_state
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.models import model as M
from repro_torch.models import recurrent
from repro_torch.train import optim, train_step

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
#: of the reference gradient tree's global norm (the docstring says why)
GRAD_TOL = 1e-5
RWKV_GRAD_TOL = 5e-3
#: of the reference's loss
LOSS_TOL, RWKV_LOSS_TOL = 1e-6, 1e-3


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's spread parameters of ``arch`` as numpy."""
    return spread_params(jax.tree.map(np.asarray, RM.init_params(ref_smoke_config(arch), KEY)))


def _ref_keys(tree):
    return ["/".join(str(k.key) if hasattr(k, "key") else str(k.idx) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _grads(arch):
    """(reference loss, reference gradients, port loss, port gradients),
    the gradients as {key: numpy array}."""
    rcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    params, batch = _params(arch), train_batch(rcfg)
    loss, g = jax.jit(jax.value_and_grad(lambda p, b: RM.loss_fn(rcfg, p, b)))(params, batch)
    want = dict(zip(_ref_keys(g), (np.asarray(x) for x in jax.tree.leaves(g))))
    p_loss, p_g = train_step.value_and_grad(cfg, M.params_from_numpy(params, "cpu"),
                                            {k: torch.from_numpy(v) for k, v in batch.items()})
    got = {k: v.numpy() for k, v in M.tree_leaves_with_path(p_g)}
    return float(loss), want, float(p_loss), got


def _hold_grads(arch, tol, loss_tol):
    loss, want, p_loss, got = _grads(arch)
    assert sorted(got) == sorted(want)
    norm = np.sqrt(sum(np.sum(np.square(w.astype(np.float64))) for w in want.values()))
    err = max(float(np.abs(got[k] - want[k]).max()) for k in want) / norm
    assert abs(p_loss - loss) <= loss_tol * abs(loss), (p_loss, loss)
    assert err < tol, f"{arch}: gradients {err:.3g} of the global norm {norm:.4g}"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_gradients_match_reference(arch):
    if arch == "rwkv6-7b":
        _hold_grads(arch, RWKV_GRAD_TOL, RWKV_LOSS_TOL)
    else:
        _hold_grads(arch, GRAD_TOL, LOSS_TOL)


class _NoBf16:
    """``jax.numpy`` with ``bfloat16`` standing for float32: in the
    reference's recurrent module, the time-mix's chunk products then take
    their inputs unrounded."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_rwkv_gradients_match_without_bf16_rounding(monkeypatch):
    """rwkv6-7b's gradients with the bf16 rounding of the time-mix's chunk
    products taken out of both packages: within ``GRAD_TOL``. With it,
    the two packages differ by less than the rounding's own effect on the
    port's gradients (measured 1.5e-3 against 1.2e-2 of the global
    norm)."""
    _, rounded_want, _, rounded = _grads("rwkv6-7b")
    monkeypatch.setattr(ref_recurrent, "jnp", _NoBf16())
    monkeypatch.setattr(recurrent, "_bf16", lambda t: t)
    _hold_grads("rwkv6-7b", GRAD_TOL, LOSS_TOL)
    _, _, _, unrounded = _grads("rwkv6-7b")
    apart = max(float(np.abs(rounded[k] - rounded_want[k]).max()) for k in rounded)
    own = max(float(np.abs(rounded[k] - unrounded[k]).max()) for k in rounded)
    assert apart < own, (apart, own)


def _adamw_case(kind, seed, grad_scale):
    """(params, grads, state) as numpy: a small tree, the state at step
    4 + seed."""
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(64, 33)).astype(np.float32),
              "b": [rng.normal(size=(17,)).astype(np.float32),
                    rng.normal(size=(5, 3, 2)).astype(np.float32)]}
    grads = jax.tree.map(lambda x: (rng.normal(size=x.shape) * grad_scale).astype(np.float32),
                         params)
    mdt = np.float32 if kind == "adamw" else ml_dtypes.bfloat16
    state = {"step": np.array(4 + seed, np.int32),
             "m": jax.tree.map(lambda x: (rng.normal(size=x.shape) * 0.05).astype(mdt), params),
             "v": jax.tree.map(lambda x: rng.uniform(0, 0.01, size=x.shape).astype(mdt), params)}
    if kind == "adamw":
        state["master"] = jax.tree.map(
            lambda x: x + (rng.normal(size=x.shape) * 1e-3).astype(np.float32), params)
    return params, grads, state


def _bits(a):
    """The float's bits as int64 (bf16 by its 16, float32 by its 32)."""
    a = np.asarray(a)
    return (a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)).astype(np.int64)


def _port_leaf(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("kind", optim.KINDS)
def test_adamw_update_matches_reference(kind):
    for seed, grad_scale in ((1, 0.1), (2, 0.1), (0, 3.0), (3, 3.0)):
        params, grads, state = _adamw_case(kind, seed, grad_scale)
        r_params, r_state = ref_adamw_update(*(jax.tree.map(jnp.asarray, t)
                                               for t in (params, grads, state)), kind=kind)
        p_params, p_state = M.params_from_numpy(params, "cpu"), M.params_from_numpy(state, "cpu")
        p_grads = M.params_from_numpy(grads, "cpu")
        out_p, out_s = optim.adamw_update(p_params, p_grads, p_state, kind=kind)
        assert out_p is p_params and out_s is p_state  # in place
        clipped = float(ref_global_norm(jax.tree.map(jnp.asarray, grads))) > 1.0
        pairs = [("params", r_params, p_params)] + [(k, r_state[k], p_state[k]) for k in r_state]
        for name, want_tree, got_tree in pairs:
            for w, g in zip(jax.tree.leaves(want_tree), M.tree_leaves(got_tree)):
                w, g = np.asarray(w), _port_leaf(g)
                assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
                ulps = int(np.abs(_bits(w) - _bits(g)).max())
                if not clipped or name == "step":
                    assert ulps == 0, f"{kind} seed {seed}: {name} {ulps} ulps"
                elif name in ("params", "master"):
                    assert ulps <= 1, f"{kind} seed {seed}: {name} {ulps} ulps"
                else:
                    wf, gf = w.astype(np.float32), g.astype(np.float32)
                    err = np.abs(wf - gf).max() / np.abs(wf).max()
                    assert err < 1e-6, f"{kind} seed {seed}: {name} {err:.3g}"
        gn_ulps = _bits(np.float32(ref_global_norm(jax.tree.map(jnp.asarray, grads)))) - _bits(
            optim.global_norm(p_grads).numpy())
        assert abs(int(gn_ulps)) <= 8, f"{kind} seed {seed}: global norm {int(gn_ulps)} ulps"


@pytest.mark.parametrize("arch", ["stablelm-3b", "recurrentgemma-9b", "seamless-m4t-large-v2"])
def test_remat_matches_no_remat(arch):
    """Rematerialized periods (decoder and encoder) give the loss and the
    gradients bit for bit, and the forward without gradients equals the
    one with."""
    cfg = smoke_config(arch)
    assert cfg.remat
    params = M.params_from_numpy(_params(arch), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    l1, g1 = train_step.value_and_grad(cfg, params, batch)
    l0, g0 = train_step.value_and_grad(dataclasses.replace(cfg, remat=False), params, batch)
    assert torch.equal(l1, l0)
    for a, b in zip(M.tree_leaves(g1), M.tree_leaves(g0)):
        assert torch.equal(a, b)
    with torch.no_grad():
        h0 = M.forward_train(cfg, params, batch)
    assert torch.equal(M.forward_train(cfg, params, batch), h0)


def test_remat_with_a_remainder_group():
    """recurrentgemma-9b's published 38 layers over its period of 3 leave
    a remainder group; so do 4 layers here. The recomputation of each
    period runs that period's own blocks (it ran the last group's, and
    the backward raised ``CheckpointError``), so the loss and gradients
    equal those without remat, bit for bit."""
    cfg = dataclasses.replace(smoke_config("recurrentgemma-9b"), n_layers=4)
    assert [len(p) for p, _ in M.layer_groups(cfg)] == [3, 1]
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    l1, g1 = train_step.value_and_grad(cfg, params, batch)
    l0, g0 = train_step.value_and_grad(dataclasses.replace(cfg, remat=False), params, batch)
    assert torch.equal(l1, l0)
    for a, b in zip(M.tree_leaves(g1), M.tree_leaves(g0)):
        assert torch.equal(a, b)


def test_opt_state_layout_matches_reference():
    """``init_opt_state`` / ``abstract_opt_state`` have the reference's
    nesting, shapes and dtypes; ``master`` does not alias the
    parameters."""
    for arch in ("stablelm-3b", "dbrx-132b"):
        rcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
        want = ref_init_opt_state(jax.tree.map(jnp.asarray, _params(arch)), rcfg.optimizer)
        params = M.params_from_numpy(_params(arch), "cpu")
        got = optim.init_opt_state(params, cfg.optimizer)
        abstract = optim.abstract_opt_state(M.abstract_params(cfg, torch.float32), cfg.optimizer)
        for tree in (got, abstract):
            assert [k for k, _ in M.tree_leaves_with_path(tree)] == _ref_keys(want)
            for w, g in zip(jax.tree.leaves(want), M.tree_leaves(tree)):
                assert tuple(g.shape) == w.shape
                assert str(g.dtype).split(".")[-1] == str(w.dtype)
        if "master" in got:
            for p, m in zip(M.tree_leaves(params), M.tree_leaves(got["master"])):
                assert torch.equal(p, m) and p.data_ptr() != m.data_ptr()


def test_make_train_step_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the step runs on it")
    with pytest.raises(RuntimeError, match="CUDA card"):
        train_step.make_train_step(smoke_config("stablelm-3b"))

