"""Serving driver: continuous batching with dynamic KV-prefix folding.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b --smoke \
      --requests 16 [--device cpu]

A port of the reference's ``launch/serve.py``. Runs a REAL model end to
end on ``--device`` (the CUDA card unless asked for the CPU): prefix
states hold actual KV caches (decode-mode prefill through
``models.model.decode_step``), folded requests fork from the shared
prefix cache and decode greedily; the isolated baseline re-prefills every
prompt. Shows that folding keeps outputs exactly while skipping the
prefill work the shared prefix represents. ``serve_fold`` runs both legs
on any config and parameters; ``main`` runs them on a reduced config.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..models import model as M


class RealExecutor:
    """Model executor: actual prefill/decode with KV-cache forking, in eager
    torch under ``torch.inference_mode`` (where the reference jits its
    step)."""

    def __init__(self, cfg, params, max_len: int = 256, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = M.resolve_device(device)
        self.prefill_tokens_computed = 0

    def _step(self, cache, tok: int, pos: int):
        token = torch.tensor([[tok]], dtype=torch.int64, device=self.device)
        return M.decode_step(self.cfg, self.params, cache, token, pos)

    @torch.inference_mode()
    def prefill_cache(self, tokens: np.ndarray, cache=None, start: int = 0):
        """Sequential decode-mode prefill from position ``start`` (reusing a
        forked cache below ``start``). Returns (cache, last_logits); the
        cache is written in place."""
        if cache is None:
            cache = M.init_cache(self.cfg, 1, self.max_len, dtype=torch.float32,
                                 device=self.device)
        logits = None
        for t in range(start, len(tokens)):
            logits, cache = self._step(cache, int(tokens[t]), t)
            self.prefill_tokens_computed += 1
        return cache, logits

    @torch.inference_mode()
    def decode(self, cache, last_logits, start_pos: int, n: int) -> List[int]:
        out = []
        logits = last_logits
        for i in range(n):
            tok = int(torch.argmax(logits[0, -1]))
            out.append(tok)
            logits, cache = self._step(cache, tok, start_pos + i)
        return out


def fork(cache):
    """A copy of every leaf: decoding writes a cache in place, so a request
    that forked the shared prefix's cache must not write into it."""
    with torch.inference_mode():
        return M.tree_map(lambda t: t.clone(), cache, lambda x: isinstance(x, torch.Tensor))


def _leg_end(t0: float, device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def serve_fold(cfg, params, shared: np.ndarray, prompts: Sequence[np.ndarray], n_decode: int,
               device="cuda") -> Dict:
    """Both legs over ``prompts``, each of which starts with ``shared``:
    ``isolated`` prefills every prompt in full, ``folded`` prefills
    ``shared`` once and forks its cache for each prompt's suffix. Returns
    each leg's outputs (``n_decode`` greedy tokens a prompt), prefill
    tokens computed, decode steps and wall seconds, and whether the
    outputs are identical."""
    dev = M.resolve_device(device)

    ex = RealExecutor(cfg, params, device=dev)
    t0 = time.perf_counter()
    iso_out = []
    for p in prompts:
        cache, logits = ex.prefill_cache(p)
        iso_out.append(ex.decode(cache, logits, len(p), n_decode))
    iso_s = _leg_end(t0, dev)

    ex2 = RealExecutor(cfg, params, device=dev)
    t0 = time.perf_counter()
    prefix_cache, _ = ex2.prefill_cache(shared)
    fold_out = []
    for p in prompts:
        cache, logits = ex2.prefill_cache(p, cache=fork(prefix_cache), start=len(shared))
        fold_out.append(ex2.decode(cache, logits, len(p), n_decode))
    fold_s = _leg_end(t0, dev)

    decoded = len(prompts) * n_decode
    return {
        "identical": iso_out == fold_out,
        "isolated": {"outputs": iso_out, "prefill_tokens": ex.prefill_tokens_computed,
                     "decode_steps": ex.prefill_tokens_computed + decoded, "seconds": iso_s},
        "folded": {"outputs": fold_out, "prefill_tokens": ex2.prefill_tokens_computed,
                   "decode_steps": ex2.prefill_tokens_computed + decoded, "seconds": fold_s},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prefix-len", type=int, default=48)
    ap.add_argument("--suffix-len", type=int, default=8)
    ap.add_argument("--decode", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = M.resolve_device(args.device)
    rng = np.random.default_rng(0)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    shared = rng.integers(0, cfg.vocab, args.prefix_len)
    prompts = [
        np.concatenate([shared, rng.integers(0, cfg.vocab, args.suffix_len)])
        for _ in range(args.requests)
    ]
    res = serve_fold(cfg, params, shared, prompts, args.decode, device=dev)
    iso, fold = res["isolated"], res["folded"]
    iso_tokens, fold_tokens = iso["prefill_tokens"], fold["prefill_tokens"]

    match = res["identical"]
    print(f"outputs identical: {match}")
    print(f"isolated: {iso_tokens} prefill tokens, {iso['seconds']:.1f}s")
    print(f"folded:   {fold_tokens} prefill tokens, {fold['seconds']:.1f}s "
          f"({iso_tokens/max(fold_tokens,1):.1f}x fewer)")
    if not match:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
