"""Deterministic synthetic token pipeline.

Batches are a pure function of (seed, global step, shard index), so:

* restart resumes mid-epoch from the checkpointed cursor with no duplicated
  or skipped batches,
* elastic rescale is safe: a resharded job re-derives exactly the batches it
  would have seen (the cursor is in global steps, and per-step data is
  sliced by global example index, not by worker count),
* straggler-dropped pods change only which host materializes a slice, never
  the data content.

The generator is a counter-based hash (SplitMix64-style) — stateless,
O(1)-seekable, reproducible across hosts.

A copy of the reference's ``train/data.py`` (NumPy only; the port imports
nothing of the reference): the same (step, seed, shard, n_shards,
structured) give the same tokens, bit for bit.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _splitmix(x: np.ndarray) -> np.ndarray:
    x = (x + _GOLDEN) * np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def batch_at(
    step: int,
    *,
    seed: int,
    global_batch: int,
    seq_len: int,
    vocab: int,
    shard: int = 0,
    n_shards: int = 1,
    structured: bool = False,
) -> Dict[str, np.ndarray]:
    """The shard-local slice of the global batch for ``step``.

    ``structured=True`` draws from a learnable affine-bigram process
    (t_{i+1} = 31*t_i + 7 mod V with 10% noise) so example training runs
    show a falling loss; the default is uniform noise (throughput work)."""
    per = global_batch // n_shards
    ex0 = np.uint64(step) * np.uint64(global_batch) + np.uint64(shard * per)
    idx = ex0 + np.arange(per, dtype=np.uint64)
    base = _splitmix(idx * np.uint64(seed * 2 + 1))[:, None]
    pos = np.arange(seq_len + 1, dtype=np.uint64)[None, :]
    rnd = _splitmix(base + pos * _GOLDEN)
    toks = (rnd % np.uint64(vocab)).astype(np.int32)
    if structured:
        out = np.empty_like(toks)
        out[:, 0] = toks[:, 0]
        noise = (rnd % np.uint64(10)) == 0  # 10% resample
        for i in range(1, toks.shape[1]):
            pred = (out[:, i - 1].astype(np.int64) * 31 + 7) % vocab
            out[:, i] = np.where(noise[:, i], toks[:, i], pred.astype(np.int32))
        toks = out
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class Pipeline:
    """Prefetching iterator with a persistent cursor (checkpointable)."""

    def __init__(self, seed: int, global_batch: int, seq_len: int, vocab: int,
                 shard: int = 0, n_shards: int = 1, start_step: int = 0,
                 structured: bool = False):
        self.seed, self.global_batch, self.seq_len, self.vocab = seed, global_batch, seq_len, vocab
        self.shard, self.n_shards = shard, n_shards
        self.cursor = start_step
        self.structured = structured

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = batch_at(
            self.cursor,
            seed=self.seed,
            global_batch=self.global_batch,
            seq_len=self.seq_len,
            vocab=self.vocab,
            shard=self.shard,
            n_shards=self.n_shards,
            structured=self.structured,
        )
        self.cursor += 1
        return b
