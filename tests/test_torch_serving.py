"""The port's KV-prefix serving plane (DESIGN.md §6, §10, §12, §15) against
the reference.

Ports of ``tests/test_serve_folding.py``, of the two ``batch_fold`` tests of
``tests/test_batch_planning.py`` and of ``tests/test_reuse.py``'s serving
tests run ``graftdb_torch.connect_serving`` alone. The serving plane runs a
token-cost simulator on the host and has no device. Parity tests run one
trace through ``graftdb.connect_serving`` and ``graftdb_torch.connect_serving``
and compare every request's record and admission-time explain, the episode
summaries, ``explain_fold`` and the session's stats (lifecycle counters among
them).
"""

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import graftdb
import graftdb_torch
from graftdb_torch import ServingConfig
from repro.serve.folding import Request as RefRequest
from repro_torch.serve.folding import FoldingScheduler, Request, SimExecutor


def _serve(reqs, fold=True):
    """Run one serving episode through the unified Session surface."""
    session = graftdb_torch.connect_serving(fold=fold)
    session.submit_all(reqs)
    return session.run()


def _reqs(n, prefix_len=256, suffix_len=32, arrival_gap=0.01, n_decode=16):
    rng = np.random.default_rng(0)
    shared = tuple(rng.integers(0, 1000, prefix_len).tolist())
    out = []
    for i in range(n):
        suffix = tuple(rng.integers(0, 1000, suffix_len).tolist())
        out.append(Request(i, shared + suffix, n_decode, arrival=i * arrival_gap))
    return out


def test_folding_reduces_prefill_tokens():
    fold = _serve(_reqs(8), fold=True)
    iso = _serve(_reqs(8), fold=False)
    assert fold["completed"] == iso["completed"] == 8
    f_tok = fold["prefill_tokens"]
    i_tok = iso["prefill_tokens"]
    assert f_tok["represented"] + f_tok["residual"] > 0
    assert i_tok["represented"] == 0
    assert fold["mean_latency"] < iso["mean_latency"]
    assert fold["elapsed"] < iso["elapsed"]


def test_extent_partition_accounting():
    reqs = _reqs(4, prefix_len=128, suffix_len=64)
    session = graftdb_torch.connect_serving(fold=True)
    futures = session.submit_all(reqs)
    session.run()
    for fut in futures[1:]:
        r = fut.result()
        prompt_len = len(fut.request.prompt)
        assert (
            r["represented_tokens"] + r["residual_tokens"] + r["ordinary_tokens"]
            == prompt_len
        )
        assert r["ordinary_tokens"] == 64
        exp = fut.explain()
        assert exp["matched_tokens"] == prompt_len - r["ordinary_tokens"]
    assert futures[0].result()["ordinary_tokens"] == len(reqs[0].prompt)


def test_retention_releases_prefix_states():
    session = graftdb_torch.connect_serving(fold=True)
    session.submit_all(_reqs(4))
    session.run()
    assert session.live_states == 0


def test_no_fold_below_min_share():
    rng = np.random.default_rng(1)
    reqs = [
        Request(i, tuple(rng.integers(0, 1000, 64).tolist()), 4, arrival=0.0)
        for i in range(4)
    ]
    res = _serve(reqs, fold=True)
    assert res["prefill_tokens"]["represented"] == 0


def test_fresh_state_explain_matches_preflight():
    session = graftdb_torch.connect_serving(fold=True)
    req = _reqs(1)[0]
    pre = session.explain_fold(req)
    fut = session.submit(req)
    session.run()
    post = fut.explain()
    assert pre["matched_tokens"] == post["matched_tokens"] == 0
    assert pre["created_state"] and post["created_state"]
    assert post["ordinary_tokens"] == len(req.prompt)


def test_episode_summaries_report_per_episode_tokens():
    session = graftdb_torch.connect_serving(fold=True)
    session.submit_all(_reqs(2))
    s1 = session.run()
    batch2 = _reqs(2)
    for i, r in enumerate(batch2):
        r.rid = 100 + i
    session.submit_all(batch2)
    s2 = session.run()
    assert s1["completed"] == s2["completed"] == 2
    assert s1["prefill_tokens"]["ordinary"] == s2["prefill_tokens"]["ordinary"]
    total = session.stats()["prefill_tokens"]
    assert (
        s1["prefill_tokens"]["ordinary"] + s2["prefill_tokens"]["ordinary"]
        == total["ordinary"]
    )


def test_prefix_state_ids_isolated_per_session():
    """State ids are scheduler-scoped: a second session restarts them."""
    s1 = graftdb_torch.connect_serving(fold=True)
    s1.submit_all(_reqs(3))
    s1.run()
    s2 = graftdb_torch.connect_serving(fold=True)
    futures = s2.submit_all(_reqs(3))
    s2.run()
    assert futures[0].explain()["state_sid"] == 1


@given(
    n=st.integers(2, 10),
    prefix=st.integers(16, 200),
    suffix=st.integers(1, 100),
    gap=st.floats(0.0, 0.2),
)
@settings(max_examples=25, deadline=None)
def test_folding_prefill_work_conservation(n, prefix, suffix, gap):
    """Folding never computes more prefill tokens than isolated execution."""
    def mk():
        rng = np.random.default_rng(42)
        shared = tuple(rng.integers(0, 1000, prefix).tolist())
        return [
            Request(i, shared + tuple(rng.integers(0, 1000, suffix).tolist()), 4, arrival=i * gap)
            for i in range(n)
        ]

    fold = _serve(mk(), fold=True)
    iso = _serve(mk(), fold=False)
    assert fold["completed"] == iso["completed"] == n
    assert (
        fold["prefill_tokens"].get("computed", 0)
        <= iso["prefill_tokens"].get("computed", 0) + 1e-9
    )


def test_retained_prefix_serves_later_wave():
    session = graftdb_torch.connect_serving(
        fold=True, retain_prefixes=True, memory_budget_tokens=2048
    )
    session.submit_all(_reqs(4))
    session.run()
    assert session.live_states >= 1
    wave2 = [
        Request(100 + i, r.prompt, r.n_decode, arrival=10.0 + i * 0.01)
        for i, r in enumerate(_reqs(3))
    ]
    futs = session.submit_all(wave2)
    session.run()
    for f in futs:
        assert f.result()["represented_tokens"] > 0
    base = graftdb_torch.connect_serving(fold=True)
    base.submit_all(_reqs(4))
    base.run()
    assert base.live_states == 0


def test_prefix_token_budget_evicts_oldest_and_is_respected():
    session = graftdb_torch.connect_serving(
        fold=True, retain_prefixes=True, memory_budget_tokens=300
    )
    rng = np.random.default_rng(3)
    waves = [
        [Request(w * 10 + i, tuple(rng.integers(0, 1000, 144).tolist()), 4,
                 arrival=w * 5.0 + i * 0.01) for i in range(2)]
        for w in range(3)
    ]
    for wave in waves:
        session.submit_all(wave)
        session.run()
    lc = session.stats()["lifecycle"]
    assert lc["evicted_states"] > 0
    assert lc["retained_tokens"] <= 300
    assert lc["retained_tokens_high_water"] <= 300
    with pytest.raises(ValueError):
        graftdb_torch.connect_serving(memory_budget_tokens=100)


# ---------------------------------------------------------------------------
# batch_fold (§15, KV-prefix flavor)
# ---------------------------------------------------------------------------


def _serve_requests():
    base = tuple(range(100))
    return [
        Request(rid=1, prompt=base[:40], n_decode=4, arrival=0.0),
        Request(rid=2, prompt=base[:70], n_decode=4, arrival=0.0),
        Request(rid=3, prompt=base, n_decode=4, arrival=0.0),
    ]


def test_serving_batch_fold_longest_first():
    """Three nested same-instant prompts: joint admission folds the shorter
    two onto the longest's fresh state."""
    plain = FoldingScheduler(SimExecutor(), fold=True)
    r_plain = plain.run(_serve_requests())
    batched = FoldingScheduler(SimExecutor(), fold=True, batch_fold=True)
    r_batch = batched.run(_serve_requests())
    assert r_batch["completed"] == r_plain["completed"] == 3
    assert batched.metrics["batch_groups"] == 1
    assert batched.metrics["batch_folded"] == 2
    assert r_batch["prefill_tokens"]["computed"] == 100
    assert r_batch["prefill_tokens"]["computed"] < r_plain["prefill_tokens"]["computed"]
    assert plain.metrics["batch_groups"] == 0


def test_serving_session_batch_fold_config():
    session = graftdb_torch.connect_serving(config=ServingConfig(fold=True, batch_fold=True))
    session.submit_all(_serve_requests())
    summary = session.run()
    assert session.scheduler.batch_fold is True
    assert summary["prefill_tokens"]["batch_groups"] == 1
    assert summary["prefill_tokens"]["batch_folded"] == 2
    with pytest.raises((TypeError, ValueError)):
        ServingConfig(batch_fold="yes")


# ---------------------------------------------------------------------------
# reuse plane: KV-prefix artifacts (§12)
# ---------------------------------------------------------------------------


def test_serving_config_rejects_cache_without_retention():
    with pytest.raises(ValueError):
        ServingConfig(reuse_cache_tokens=1024)


def test_serving_prefix_spill_and_rehydrate():
    """With a zero token budget every retired prefix spills; a repeat
    prompt rehydrates it and folds as if the state never left."""
    prompt = tuple(range(100))
    session = graftdb_torch.connect_serving(
        fold=True, retain_prefixes=True, memory_budget_tokens=0, reuse_cache_tokens=4096,
    )
    session.submit(Request(0, prompt, 4, arrival=0.0))
    session.run()
    ex = session.explain_fold(Request(1, prompt, 4, arrival=1.0))
    assert ex["served_from_cache"]
    session.submit(Request(1, prompt, 4, arrival=1.0))
    session.run()
    lm = session.stats()["lifecycle"]
    assert lm["cache_spills"] >= 1 and lm["cache_hits"] == 1
    assert lm["rehydrate_tokens"] == len(prompt)
    assert session._explains[1]["represented_tokens"] == len(prompt)


def test_serving_prefix_cache_respects_token_budget():
    session = graftdb_torch.connect_serving(
        fold=True, retain_prefixes=True, memory_budget_tokens=0, reuse_cache_tokens=64,
    )
    for i in range(3):
        session.submit(Request(i, tuple(range(i * 1000, i * 1000 + 50)), 2, arrival=float(i)))
    session.run()
    lm = session.stats()["lifecycle"]
    assert lm["cache_evictions"] >= 1
    store = session.scheduler.reuse
    assert store.mem_bytes <= 8 * 64


# ---------------------------------------------------------------------------
# parity with the reference's serving plane
# ---------------------------------------------------------------------------


def _workload(req_cls, n=48, n_prompts=4, prefix=1024, suffix=64, seed=0, t0=0.0, rid0=0):
    """``benchmarks/serve_fold.py``'s workload: Poisson arrivals over a few
    shared prompts, each with its own suffix."""
    rng = np.random.default_rng(seed)
    prompts = [tuple(rng.integers(0, 32000, prefix).tolist()) for _ in range(n_prompts)]
    reqs, t = [], t0
    for i in range(n):
        t += float(rng.exponential(0.05))
        p = prompts[int(rng.integers(0, n_prompts))]
        reqs.append(req_cls(rid0 + i, p + tuple(rng.integers(0, 32000, suffix).tolist()), 32,
                            arrival=t))
    return reqs


def _nested_burst(req_cls, rid0, t):
    base = tuple(range(5000, 5300))
    return [req_cls(rid0 + i, base[: 60 + 80 * i], 8, arrival=t) for i in range(4)]


@pytest.mark.parametrize(
    "cfg",
    [
        dict(fold=False),
        dict(fold=True),
        dict(fold=True, batch_fold=True),
        dict(fold=True, batch_fold=True, retain_prefixes=True, memory_budget_tokens=2048,
             reuse_cache_tokens=4096),
    ],
    ids=["isolated", "fold", "batch-fold", "retain-cache"],
)
def test_serving_session_matches_reference(cfg):
    """Two episodes (the serve_fold workload, then a repeat of it beside a
    same-instant nested burst): every request's record and admission-time
    explain, the episode summaries, a pre-flight ``explain_fold`` after each
    episode and the session's stats equal the reference's."""
    sessions = (graftdb.connect_serving(**cfg), graftdb_torch.connect_serving(**cfg))
    records = ([], [])
    for req_cls, s, rec in zip((RefRequest, Request), sessions, records):
        for episode in range(2):
            reqs = _workload(req_cls, n=24 if episode else 48, seed=episode,
                             t0=0.0, rid0=1000 * episode)
            if episode:
                reqs += _nested_burst(req_cls, 5000, reqs[3].arrival)
            futs = s.submit_all(reqs)
            rec.append(("summary", s.run()))
            rec.extend(
                ("request", f.result(), f.explain(), len(f.request.prompt)) for f in futs
            )
            probe = _workload(req_cls, n=2, seed=episode, rid0=9000)[1]
            rec.append(("explain_fold", s.explain_fold(probe)))
        rec.append(("stats", s.stats(), s.metrics, s.live_states))
    assert records[1] == records[0]
    for kind, *rest in records[1]:
        if kind == "request":
            r, _, n = rest
            assert r["represented_tokens"] + r["residual_tokens"] + r["ordinary_tokens"] == n


@pytest.mark.parametrize(
    "kw",
    [
        dict(min_share=-1),
        dict(prefill_tok_s=0.0),
        dict(decode_step_s=-1.0),
        dict(memory_budget_tokens=100),
        dict(retain_prefixes=True, memory_budget_tokens=-1),
        dict(retain_prefixes=True, reuse_cache_tokens=-1),
    ],
)
def test_serving_config_rejects_bad_values(kw):
    """The port validates the serving knobs as the reference does."""
    with pytest.raises(ValueError):
        graftdb.ServingConfig(**kw)
    with pytest.raises(ValueError):
        ServingConfig(**kw)
