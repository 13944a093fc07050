"""Query instances: the benchmark's frozen copy of the template sampler.

A copy of the port's parameter sampler (``repro_torch.relational.queries``
``_sample_params``): the nine TPC-H-derived templates' parameters drawn
uniformly from the benchmark's domains (paper §6.1). A template's rank in
the Zipf order is given by the configuration file, as the repository's
``DEFAULT_TEMPLATES`` gives it. NumPy only.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .datagen import COLORS, NATIONS, REGIONS, SEGMENTS, TYPES, days


def first_of_month(year: int, month: int) -> int:
    return days(f"{year:04d}-{month:02d}-01")


def sample_params(template: str, rng: np.random.Generator) -> Dict:
    if template == "q1":
        return {"delta": int(rng.integers(60, 121))}
    if template == "q3":
        return {
            "segment": float(rng.integers(0, len(SEGMENTS))),
            "date": float(days("1995-03-01") + rng.integers(0, 31)),
        }
    if template == "q4":
        y = int(rng.integers(1993, 1998))
        m = int(rng.integers(1, 13)) if y < 1997 else int(rng.integers(1, 11))
        return {"date": float(first_of_month(y, m))}
    if template == "q5":
        return {
            "region": float(rng.integers(0, len(REGIONS))),
            "date": float(first_of_month(int(rng.integers(1993, 1998)), 1)),
        }
    if template == "q6":
        return {
            "date": float(first_of_month(int(rng.integers(1993, 1998)), 1)),
            "discount": float(rng.integers(2, 10)) / 100.0,
            "quantity": float(rng.integers(24, 26)),
        }
    if template == "q7":
        n1 = int(rng.integers(0, 25))
        n2 = int(rng.integers(0, 24))
        if n2 >= n1:
            n2 += 1
        return {"nation1": float(n1), "nation2": float(n2)}
    if template == "q8":
        nation_idx = int(rng.integers(0, 25))
        return {
            "nation": float(nation_idx),
            "region": float(NATIONS[nation_idx][1]),
            "type": float(rng.integers(0, len(TYPES))),
        }
    if template == "q9":
        return {"color": float(rng.integers(0, len(COLORS)))}
    if template == "q10":
        months = [(y, m) for y in (1993, 1994) for m in range(1, 13)] + [(1995, 1)]
        y, m = months[int(rng.integers(0, len(months)))]
        return {"date": float(first_of_month(y, m))}
    raise KeyError(template)


def zipf_deck(templates: List[str], alpha: float, size: int) -> List[str]:
    """``size`` cards whose template counts follow Zipf(``alpha``) over
    ``templates`` in rank order: the largest-remainder apportionment of
    ``size`` over the Zipf shares, so counts never rise with rank. Every
    template has to get a card. Shuffled decks give each seed the same
    template mix in another order."""
    w = np.arange(1, len(templates) + 1, dtype=np.float64) ** (-alpha)
    share = w / w.sum() * size
    counts = np.floor(share).astype(int)
    order = np.argsort(-(share - counts), kind="stable")
    counts[order[: size - int(counts.sum())]] += 1
    if counts.min() < 1:
        raise ValueError(f"a deck of {size} gives {templates[int(counts.argmin())]} no card")
    return [t for t, c in zip(templates, counts) for _ in range(int(c))]
