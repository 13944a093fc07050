"""The one traffic generator: reads a mix's data file, makes its requests.

A mix is a JSON file under ``graftbench/traffic/``. Its keys:

* ``loop``: ``"closed"``, the one loop there is (each client keeps one
  query outstanding and sends the next at its completion).
* ``zipf_alpha``, ``deck_size``: template popularity. Templates come in
  shuffled decks of ``deck_size`` cards whose counts follow Zipf(alpha)
  over the configuration's rank order, so every seed sends the same mix
  of templates in another order; parameters are drawn afresh for each
  query (``sampler.sample_params``).
* ``clients``, ``stagger_s`` (client c sends its first query
  c * stagger_s after the start) and ``drain_s`` (how long after the
  window's close its queries may take to finish, the clients still
  sending; one not done by then has failed).

Everything is drawn from the run's seed, so a seed repeats its traffic.
"""

from __future__ import annotations

import itertools
import json
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np

from .sampler import sample_params, zipf_deck

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"

Instance = Tuple[str, Dict]


def load(name: str) -> Dict:
    spec = json.loads((TRAFFIC_DIR / f"{name}.json").read_text())
    if spec.get("loop") != "closed":
        raise ValueError(f"traffic {name}: loop must be 'closed'")
    return spec


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """One of the run's independent random streams (any integer seed)."""
    return np.random.default_rng([seed & (2**64 - 1), stream])


def instances(spec: Dict, templates: List[str], seed: int) -> Iterator[Instance]:
    """Endless (template, params) of the mix: shuffled Zipf decks."""
    rng = rng_for(seed, 1)
    deck = zipf_deck(templates, float(spec["zipf_alpha"]), int(spec["deck_size"]))
    for _ in itertools.count():
        for i in rng.permutation(len(deck)):
            t = deck[int(i)]
            yield t, sample_params(t, rng)
