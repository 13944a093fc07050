"""The port's training infrastructure and drivers (``repro_torch.train``:
``data``, ``elastic``, ``compress``, ``checkpoint``, ``optim``;
``repro_torch.launch``: ``train``, ``roofline``) on the CPU, on their own
and against the reference's.

* The reference's own tests of ``tests/test_train_infra.py``, run on the
  port (checkpoint roundtrip, async write and the ``LATEST`` fallback,
  data shard consistency, learnable structured data, straggler and dead
  pod decisions, compression error feedback, AdamW decreasing a loss).
* Bit for bit against the reference: ``batch_at`` and ``Pipeline``, the
  elastic controller's decisions over the same heartbeat logs, and the
  compressor's ``q``, scales and residuals over 20 rounds.
* Checkpoints: either package's restores in the other, with the same
  keys and manifest fields, the leaves bit for bit.
* Three train steps of ``make_train_step`` against the reference's
  jitted step, for stablelm-3b, dbrx-132b (``adamw_bf16``, MoE) and
  rwkv6-7b (its bf16-rounded chunk products), at 1 and 2 microbatches,
  from the reference's parameters with their constant leaves drawn at
  random (``_torch_lm.spread_params``) and the same batches
  (``_torch_lm.train_batch``). The loss within ``LOSS_TOL`` = 1e-6 of
  the reference's and the grad norm within ``GNORM_TOL`` = 1e-5 at each
  step (measured 2.1e-7 and 3.6e-6). Parameters get a looser limit:
  AdamW's update is about ``lr * sign(m / sqrt(v))``, so an element whose
  gradient is rounding noise may move the other way in the other
  package. Every element lies within 2 * lr per step taken, and all but
  ``STRAY_SHARE`` = 1e-4 of them within 1e-5 (measured: 2 of 344,896
  elements of dbrx-132b beyond 1e-5, the largest 6.1e-4 after 3 steps).
  rwkv6-7b's bf16 rounding makes its trajectories part
  (``test_torch_train.py`` says why): its loss within 1e-3 (measured
  8.7e-5), its grad norm within 1e-2 (2.2e-3), every parameter within
  2 * lr per step (largest 1.3e-3 after 3 steps), and after the first
  step all but ``RWKV_STRAY_SHARE`` = 1e-2 of them within 1e-5 (measured
  1.6e-3; after steps 2 and 3, once the parameters have parted, 4.1e-2
  and 0.10, not held). With the rounding taken out of both packages its
  three steps are held as the other families' are.
* The train driver (the port of ``tests/test_launch.py``'s train test):
  6 steps with checkpoints every 3, then a resume to 9, equal bit for bit
  to an uninterrupted 9-step run.
* Roofline: the reference's dicts and model FLOPs, exactly.
"""

import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from _torch_lm import spread_params, train_batch
from test_torch_train import _NoBf16

import repro.models.recurrent as ref_recurrent
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import smoke_config as ref_smoke_config
from repro.launch import roofline as ref_roofline
from repro.models import model as RM
from repro.train import checkpoint as ref_ckpt
from repro.train import compress as ref_compress
from repro.train import data as ref_data
from repro.train import elastic as ref_elastic
from repro.train.optim import init_opt_state as ref_init_opt_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.launch import roofline
from repro_torch.launch import train as T
from repro_torch.models import model as M
from repro_torch.models import recurrent
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import compress, optim, train_step
from repro_torch.train.data import Pipeline, batch_at
from repro_torch.train.elastic import Action, ElasticConfig, ElasticController, remesh_plan
from repro_torch.train.optim import adamw_update, init_opt_state

torch.set_num_threads(2)


def _state(arch="stablelm-3b", seed=0):
    cfg = smoke_config(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    return params, init_opt_state(params, cfg.optimizer)


def _equal_trees(a, b):
    la, lb = M.tree_leaves_with_path(a), M.tree_leaves_with_path(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


# ---------------------------------------------------------------------------
# The reference's tests/test_train_infra.py, on the port
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    params, opt = _state()
    CKPT.save(tmp_path, 7, params, opt, data_cursor=7, mesh_shape=(1, 1))
    assert CKPT.latest_step(tmp_path) == 7
    p2, o2, manifest = CKPT.restore(tmp_path, target_params=params, target_opt=opt)
    assert manifest["step"] == 7 and manifest["data_cursor"] == 7
    _equal_trees(params, p2)
    _equal_trees(opt, o2)


def test_checkpoint_async_and_latest_fallback(tmp_path):
    params, opt = _state()
    t = CKPT.save(tmp_path, 1, params, opt, async_write=True)
    t.join()
    CKPT.save(tmp_path, 2, params, opt)
    # corrupt LATEST to point past a complete checkpoint
    (tmp_path / "LATEST").write_text("99")
    assert CKPT.latest_step(tmp_path) == 2


@given(
    step=st.integers(0, 1000),
    n_shards=st.sampled_from([1, 2, 4, 8]),
    seed=st.integers(0, 2**20),
)
@settings(max_examples=30, deadline=None)
def test_data_pipeline_shard_consistency(step, n_shards, seed):
    """Sharded reads tile the global batch exactly: content is a pure
    function of (seed, step, global example index)."""
    gb, sl, vocab = 16, 12, 97
    full = batch_at(step, seed=seed, global_batch=gb, seq_len=sl, vocab=vocab)
    parts = [
        batch_at(step, seed=seed, global_batch=gb, seq_len=sl, vocab=vocab, shard=s,
                 n_shards=n_shards)
        for s in range(n_shards)
    ]
    glued = np.concatenate([p["tokens"] for p in parts], axis=0)
    np.testing.assert_array_equal(full["tokens"], glued)
    again = batch_at(step, seed=seed, global_batch=gb, seq_len=sl, vocab=vocab)
    np.testing.assert_array_equal(full["targets"], again["targets"])


def test_structured_data_learnable():
    b = batch_at(3, seed=1, global_batch=4, seq_len=64, vocab=101, structured=True)
    pred = (b["tokens"].astype(np.int64) * 31 + 7) % 101
    assert (pred == b["targets"]).mean() > 0.7  # ~90% follow the bigram rule


def test_elastic_straggler_detection():
    ctl = ElasticController(4, ElasticConfig(straggler_factor=2.0, patience=2))
    decisions = []
    for _ in range(3):
        for p in range(4):
            ctl.heartbeat(p, 1.0 if p != 2 else 5.0)  # pod 2 slow
        decisions.append(ctl.evaluate())
    assert decisions[0].action == Action.CONTINUE  # patience not yet reached
    drops = [d for d in decisions if d.action == Action.DROP_PODS]
    assert drops and drops[0].drop == (2,) and drops[0].new_mesh_pods == 3
    assert 2 not in ctl.active  # dropped pod stays dropped
    assert remesh_plan(4, 3)["new_mesh"] == (3, 16, 16)


def test_elastic_dead_pod_and_abort():
    ctl = ElasticController(2, ElasticConfig(dead_after=2, min_pods=2))
    ctl.heartbeat(0, 1.0)
    ctl.miss(1)
    ctl.miss(1)
    assert ctl.evaluate().action == Action.ABORT_RESTART  # dropping would go below min


def test_gradient_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))}
    res = compress.init_residuals(g)
    acc = torch.zeros((64, 64))
    exact = torch.zeros((64, 64))
    for _ in range(20):
        q, s, res = compress.compress(g, res)
        acc = acc + compress.decompress(q, s)["w"]
        exact = exact + g["w"]
    # error feedback: accumulated quantized stream tracks the exact sum
    rel = float((acc - exact).abs().max() / exact.abs().max())
    assert rel < 0.01, rel


@pytest.mark.parametrize("kind", ["adamw", "adamw_bf16"])
def test_adamw_decreases_loss(kind):
    w = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(8, 8)).astype(np.float32))}
    opt = init_opt_state(w, kind)
    target = torch.eye(8)

    def loss(p):
        return torch.mean((p["w"] - target) ** 2)

    l0 = float(loss(w))
    for _ in range(50):
        x = w["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss({"w": x}), [x])
        w, opt = adamw_update(w, {"w": g}, opt, kind=kind, lr=3e-2, weight_decay=0.0)
    assert float(loss(w)) < 0.3 * l0


# ---------------------------------------------------------------------------
# Data, control and compression against the reference, bit for bit
# ---------------------------------------------------------------------------


@given(
    step=st.integers(0, 10**6),
    seed=st.integers(0, 2**20),
    n_shards=st.sampled_from([1, 2, 4]),
    structured=st.booleans(),
    vocab=st.sampled_from([97, 512, 50_304]),
)
@settings(max_examples=25, deadline=None)
def test_batch_at_matches_reference(step, seed, n_shards, structured, vocab):
    for shard in range(n_shards):
        kw = dict(seed=seed, global_batch=8, seq_len=20, vocab=vocab, shard=shard,
                  n_shards=n_shards, structured=structured)
        got, want = batch_at(step, **kw), ref_data.batch_at(step, **kw)
        for k in ("tokens", "targets"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_matches_reference():
    args = (5, 4, 16, 211)
    got = Pipeline(*args, shard=1, n_shards=2, start_step=3, structured=True)
    want = ref_data.Pipeline(*args, shard=1, n_shards=2, start_step=3, structured=True)
    for _ in range(4):
        a, b = next(got), next(want)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["targets"], b["targets"])
    assert got.cursor == want.cursor == 7


@pytest.mark.parametrize("seed", range(4))
def test_elastic_decisions_match_reference(seed):
    """The same seeded heartbeat log (slow pods, missed beats) through both
    controllers: the same decision at every step and the same survivors."""
    rng = np.random.default_rng(seed)
    n = 6
    cfg = dict(straggler_factor=1.5, patience=2, dead_after=3, min_pods=2)
    got = ElasticController(n, ElasticConfig(**cfg))
    want = ref_elastic.ElasticController(n, ref_elastic.ElasticConfig(**cfg))
    slow = rng.choice(n, 2, replace=False)
    for _ in range(12):
        for p in range(n):
            if rng.random() < 0.15:
                got.miss(p), want.miss(p)
            else:
                t = float(rng.uniform(0.9, 1.1) * (2.5 if p in slow else 1.0))
                got.heartbeat(p, t), want.heartbeat(p, t)
        a, b = got.evaluate(), want.evaluate()
        assert (a.action.value, a.drop, a.new_mesh_pods, a.reason) == (
            b.action.value, b.drop, b.new_mesh_pods, b.reason)
    assert got.active == want.active
    assert remesh_plan(4, 3) == ref_elastic.remesh_plan(4, 3)


def test_compression_matches_reference():
    rng = np.random.default_rng(1)
    g = {"w": rng.normal(size=(64, 64)).astype(np.float32),
         "b": [rng.normal(size=(33,)).astype(np.float32) * 1e-3]}
    res, ref_res = compress.init_residuals(M.params_from_numpy(g, "cpu")), \
        ref_compress.init_residuals(g)
    pg, rg = M.params_from_numpy(g, "cpu"), jax.tree.map(jnp.asarray, g)
    for _ in range(20):
        q, s, res = compress.compress(pg, res)
        rq, rs, ref_res = ref_compress.compress(rg, ref_res)
        for got, want in ((q, rq), (s, rs), (res, ref_res),
                          (compress.decompress(q, s), ref_compress.decompress(rq, rs))):
            for a, b in zip(M.tree_leaves(got), jax.tree.leaves(want)):
                b = np.asarray(b)
                assert a.numpy().dtype == b.dtype
                np.testing.assert_array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# Checkpoints across the two packages
# ---------------------------------------------------------------------------


def _ref_state(arch):
    rcfg = ref_smoke_config(arch)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return params, ref_init_opt_state(params, rcfg.optimizer)


def test_port_checkpoint_restores_in_reference(tmp_path):
    params, opt = _state("stablelm-3b", seed=3)
    CKPT.save(tmp_path, 5, params, opt, data_cursor=5, rng_key=np.array([0, 3], np.uint32),
              mesh_shape=(1, 1))
    r_params, r_opt = _ref_state("stablelm-3b")
    got_p, got_o, manifest = ref_ckpt.restore(tmp_path, target_params=r_params, target_opt=r_opt)
    assert manifest["step"] == 5 and manifest["rng_key"] == [0, 3]
    assert manifest["mesh_shape"] == [1, 1]
    for tree, ours in ((got_p, params), (got_o, opt)):
        for a, (_, b) in zip(jax.tree.leaves(tree), M.tree_leaves_with_path(ours)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("arch", ["chatglm3-6b", "dbrx-132b"])
def test_reference_checkpoint_restores_in_port(tmp_path, arch):
    """Including dbrx-132b's bf16 moments, stored as their 2-byte words."""
    r_params, r_opt = _ref_state(arch)
    ref_ckpt.save(tmp_path, 4, r_params, r_opt, data_cursor=4, mesh_shape=(1, 1),
                  rng_key=jax.random.PRNGKey(0))
    params, opt = _state(arch, seed=9)
    got_p, got_o, manifest = CKPT.restore(tmp_path, target_params=params, target_opt=opt)
    assert manifest["step"] == 4 and manifest["data_cursor"] == 4
    for tree, want in ((got_p, r_params), (got_o, r_opt)):
        for (_, a), b in zip(M.tree_leaves_with_path(tree), jax.tree.leaves(want)):
            b = np.asarray(b)
            a = a.view(torch.int16).numpy().view(b.dtype) if a.dtype == torch.bfloat16 \
                else a.numpy()
            assert a.dtype == b.dtype
            assert a.shape == b.shape and a.tobytes() == b.tobytes()


def test_checkpoint_files_match_reference_layout(tmp_path):
    """The same keys in ``params.npz``/``opt.npz`` and the same manifest
    fields; bf16 leaves as the reference writes them (dtype ``V2``)."""
    r_params, r_opt = _ref_state("dbrx-132b")
    params, opt = _state("dbrx-132b")
    ref_ckpt.save(tmp_path / "ref", 1, r_params, r_opt, mesh_shape=(1, 1))
    CKPT.save(tmp_path / "port", 1, params, opt, mesh_shape=(1, 1))
    man = {k: json.loads((tmp_path / k / "step-00000001" / "manifest.json").read_text())
           for k in ("ref", "port")}
    assert sorted(man["ref"]) == sorted(man["port"])
    for field in ("param_keys", "opt_keys", "mesh_shape", "step", "data_cursor", "extra"):
        assert man["ref"][field] == man["port"][field], field
    for name in ("params.npz", "opt.npz"):
        a = np.load(tmp_path / "ref" / "step-00000001" / name)
        b = np.load(tmp_path / "port" / "step-00000001" / name)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert (a[k].dtype.str, a[k].shape) == (b[k].dtype.str, b[k].shape), k
    assert (tmp_path / "port" / "LATEST").read_text() == "1"


def test_restore_checks_shapes_and_places_on_target(tmp_path):
    params, opt = _state("stablelm-3b")
    CKPT.save(tmp_path, 1, params, opt)
    wide, wide_opt = _state("chatglm3-6b")
    with pytest.raises(ValueError, match="shape mismatch"):
        CKPT.restore(tmp_path, target_params=wide, target_opt=wide_opt)
    half = M.tree_map(lambda t: t.to(torch.bfloat16), params, torch.is_tensor)
    got, _, _ = CKPT.restore(tmp_path, target_params=half, target_opt=opt)
    for (_, a), (_, b) in zip(M.tree_leaves_with_path(got), M.tree_leaves_with_path(params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))
    flat_p, flat_o, _ = CKPT.restore(tmp_path)
    assert set(flat_p) == {k for k, _ in M.tree_leaves_with_path(params)}
    assert int(flat_o["step"]) == 0


def test_async_save_copies_before_returning(tmp_path):
    """The step may go on writing the tensors in place while the thread
    writes: what is saved is the state at the call."""
    params, opt = _state("stablelm-3b")
    before = M.tree_map(lambda t: t.clone(), params, torch.is_tensor)
    t = CKPT.save(tmp_path, 1, params, opt, async_write=True)
    for leaf in M.tree_leaves(params):
        leaf.add_(1.0)
    t.join()
    got, _, _ = CKPT.restore(tmp_path, target_params=params, target_opt=opt)
    _equal_trees(got, before)


# ---------------------------------------------------------------------------
# Three train steps against the reference's
# ---------------------------------------------------------------------------

#: of the reference's value (the docstring says why)
LOSS_TOL, GNORM_TOL = 1e-6, 1e-5
RWKV_LOSS_TOL, RWKV_GNORM_TOL = 1e-3, 1e-2
STRAY_SHARE, RWKV_STRAY_SHARE = 1e-4, 1e-2
LR = 3e-4
STEP_ARCHS = ("stablelm-3b", "dbrx-132b", "rwkv6-7b")


@functools.lru_cache(maxsize=None)
def _spread_params(arch):
    """The reference's parameters of ``arch``, constant leaves drawn, as
    numpy."""
    return spread_params(jax.tree.map(np.asarray, RM.init_params(ref_smoke_config(arch),
                                                                 jax.random.PRNGKey(0))))


def _close_tree(got_tree, want_tree, label, steps):
    """Every parameter within 2 * LR per step; returns the share of
    elements beyond 1e-5."""
    far = total = 0
    for w, g in zip(jax.tree.leaves(want_tree), M.tree_leaves(got_tree)):
        d = np.abs(np.asarray(w) - g.numpy())
        assert d.max() <= 2 * LR * steps, f"{label}: a parameter moved {d.max():.3g}"
        far += int((d > 1e-5).sum())
        total += d.size
    return far / total


def _hold_steps(arch, n_microbatches, loss_tol, gnorm_tol, stray_shares):
    """Three steps of ``make_train_step`` from the same parameters and
    batches: loss and grad norm each step, parameters after each, the
    share of elements beyond 1e-5 after step s within ``stray_shares[s]``
    (None: not held)."""
    rcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    ref_step = jax.jit(ref_make_train_step(rcfg, n_microbatches=n_microbatches, lr=LR))
    r_params = jax.tree.map(jnp.asarray, _spread_params(arch))
    r_opt = ref_init_opt_state(r_params, rcfg.optimizer)
    params = M.params_from_numpy(_spread_params(arch), "cpu")
    opt = optim.init_opt_state(params, cfg.optimizer)
    step = train_step.make_train_step(cfg, n_microbatches=n_microbatches, lr=LR, device="cpu")
    for s, stray_share in enumerate(stray_shares):
        batch = train_batch(rcfg, s)
        r_params, r_opt, want = ref_step(r_params, r_opt, batch)
        params, opt, got = step(params, opt, batch)
        label = f"{arch} x{n_microbatches} step {s}"
        for k, tol in (("loss", loss_tol), ("grad_norm", gnorm_tol)):
            w, g = float(want[k]), float(got[k])
            assert abs(g - w) <= tol * abs(w), f"{label}: {k} {g} against {w}"
        stray = _close_tree(params, r_params, label, s + 1)
        assert stray_share is None or stray <= stray_share, \
            f"{label}: {stray:.3g} of elements beyond 1e-5"
        assert int(opt["step"]) == int(r_opt["step"]) == s + 1


@pytest.mark.parametrize("n_microbatches", [1, 2])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_steps_match_reference(arch, n_microbatches):
    """Three steps of ``make_train_step`` against the reference's jitted
    step (the module's docstring gives the limits)."""
    if arch == "rwkv6-7b":
        _hold_steps(arch, n_microbatches, RWKV_LOSS_TOL, RWKV_GNORM_TOL,
                    (RWKV_STRAY_SHARE, None, None))
    else:
        _hold_steps(arch, n_microbatches, LOSS_TOL, GNORM_TOL, (STRAY_SHARE,) * 3)


@pytest.mark.parametrize("n_microbatches", [1, 2])
def test_rwkv_train_steps_match_reference_without_bf16_rounding(n_microbatches, monkeypatch):
    """rwkv6-7b's three steps with the bf16 rounding of its time-mix's chunk
    products taken out of both packages: held as the other families are."""
    monkeypatch.setattr(ref_recurrent, "jnp", _NoBf16())
    monkeypatch.setattr(recurrent, "_bf16", lambda t: t)
    _hold_steps("rwkv6-7b", n_microbatches, LOSS_TOL, GNORM_TOL, (STRAY_SHARE,) * 3)



# ---------------------------------------------------------------------------
# The train driver
# ---------------------------------------------------------------------------

DRIVER = ["--device", "cpu", "--arch", "chatglm3-6b", "--smoke", "--batch", "4", "--seq", "32"]


def _run(args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        params, opt = T.main(DRIVER + args)
    return params, opt, out.getvalue()


def test_train_driver_runs_and_restores(tmp_path):
    """6 steps with checkpoints every 3, then a resume to 9: bit for bit
    the parameters and state of an uninterrupted 9-step run."""
    ckpt = str(tmp_path / "ck")
    _, _, first = _run(["--steps", "6", "--ckpt-dir", ckpt, "--ckpt-every", "3"])
    assert sorted(p.name for p in (tmp_path / "ck").glob("step-*")) == [
        "step-00000003", "step-00000006"]
    man = json.loads((tmp_path / "ck" / "step-00000006" / "manifest.json").read_text())
    assert (man["step"], man["data_cursor"], man["mesh_shape"]) == (6, 6, [1, 1])
    params, opt, resumed = _run(["--steps", "9", "--ckpt-dir", ckpt, "--ckpt-every", "3"])
    assert "restored step 6" in resumed and "step     8 loss" in resumed
    straight_p, straight_o, straight = _run(["--steps", "9"])
    _equal_trees(params, straight_p)
    _equal_trees(opt, straight_o)
    assert int(opt["step"]) == 9 and CKPT.latest_step(ckpt) == 9

    def line(out, i):  # a printed step without its seconds a step
        return out.splitlines()[i].split("(")[0]

    assert line(first, 0) == line(straight, 0) and line(resumed, -1) == line(straight, -1)


def test_train_driver_production_mesh_raises():
    with pytest.raises(RuntimeError, match="production mesh"):
        T.main(DRIVER + ["--steps", "1", "--production-mesh"])


def test_train_driver_loss_falls():
    """The structured stream is learnable: the example's rate drops the
    loss within 30 steps at the smoke width."""
    _, _, out = _run(["--steps", "30", "--lr", "3e-3", "--arch", "stablelm-3b"])
    losses = [float(ln.split()[3]) for ln in out.splitlines() if ln.startswith("step")]
    assert losses[-1] < losses[0] - 0.5, losses


def test_train_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the entry points run on it")
    with pytest.raises(RuntimeError, match="CUDA card"):
        T.main(["--arch", "chatglm3-6b", "--smoke", "--steps", "1"])


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------


def test_roofline_record_analysis():
    rec = {
        "arch": "stablelm-3b",
        "shape": "train_4k",
        "mesh": "16x16",
        "hlo_stats": {
            "flops_per_device": 1.0e14,
            "mem_bytes_per_device": 8.19e12,
            "coll_bytes_per_device": {"all-gather": 5e11},
        },
    }
    r = roofline.analyze_record(rec)
    assert r == ref_roofline.analyze_record(rec)
    assert r["dominant"] == "memory" and abs(r["memory_s"] - 10.0) < 0.1
    d = roofline.model_flops_per_device("rwkv6-7b", "decode_32k", 256)
    t = roofline.model_flops_per_device("rwkv6-7b", "train_4k", 256)
    assert t / d > 1e4
    assert roofline.render_markdown([r]) == ref_roofline.render_markdown([r])


def test_model_flops_match_reference():
    for arch in REF_ARCHS:
        for shape in REF_SHAPES:
            for n_chips in (1, 256, 512):
                assert roofline.model_flops_per_device(arch, shape, n_chips) == \
                    ref_roofline.model_flops_per_device(arch, shape, n_chips), (arch, shape)


def test_roofline_constants_and_missing_results(tmp_path):
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        ref_roofline.PEAK_FLOPS, ref_roofline.HBM_BW, ref_roofline.LINK_BW)
    assert roofline.H100_BF16_FLOPS == 2 * roofline.H100_TF32_FLOPS
    assert roofline.H100_FP32_FLOPS < roofline.H100_FP32X3_FLOPS < roofline.H100_TF32_FLOPS
    with pytest.raises(FileNotFoundError):
        roofline.main(["--results", str(tmp_path / "dryrun.json")])
    recs = [{"arch": "stablelm-3b", "shape": "train_4k", "mesh": "16x16", "status": "ok",
             "hlo_stats": {"flops_per_device": 1e14, "mem_bytes_per_device": 1e12,
                           "coll_bytes_per_device": {}}},
            {"arch": "dbrx-132b", "shape": "train_4k", "mesh": "16x16", "status": "error",
             "hlo_stats": None}]  # a record that failed to compile: skipped
    (tmp_path / "dryrun.json").write_text(json.dumps(recs))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        roofline.main(["--results", str(tmp_path / "dryrun.json"), "--md",
                       str(tmp_path / "roofline.md")])
    assert "| stablelm-3b | train_4k | 16x16 |" in (tmp_path / "roofline.md").read_text()
    assert "worst roofline fraction" in out.getvalue()

