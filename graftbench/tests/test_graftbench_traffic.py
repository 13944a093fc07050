"""The traffic generator repeats exactly for a seed, and sends the Zipf mix
that its configuration states."""

import itertools
from collections import Counter

import numpy as np
import pytest

from graftbench import traffic
from graftbench.sampler import zipf_deck

TEMPLATES = ["q3", "q10", "q1", "q5", "q4", "q7", "q8", "q6", "q9"]
SEED = 2**31 + 12345  # larger than 32 signed bits hold


def take(spec, seed, n):
    return list(itertools.islice(traffic.instances(spec, TEMPLATES, seed), n))


def test_closed_loop_instances_repeat_for_a_seed():
    spec = traffic.load("closed32")
    assert take(spec, SEED, 200) == take(spec, SEED, 200)
    assert take(spec, SEED, 200) != take(spec, SEED + 1, 200)


def test_every_seed_sends_the_same_template_mix():
    spec = traffic.load("closed32")
    deck = int(spec["deck_size"])
    for seed in (1, SEED, 7):
        got = Counter(t for t, _ in take(spec, seed, 3 * deck))
        assert got == Counter({t: 3 * c for t, c in Counter(zipf_deck(TEMPLATES, 1.0, deck)).items()})


MIXES = sorted(p.stem for p in traffic.TRAFFIC_DIR.glob("*.json"))


@pytest.mark.parametrize("size", sorted({int(traffic.load(m)["deck_size"]) for m in MIXES})
                         + [27, 38, 57, 100])
def test_zipf_deck_follows_the_rank_order(size):
    counts = [Counter(zipf_deck(TEMPLATES, 1.0, size))[t] for t in TEMPLATES]
    assert sum(counts) == size and min(counts) >= 1
    assert counts == sorted(counts, reverse=True)  # never rising with rank
    # each count within one card of its Zipf share
    share = size / np.arange(1, 10) / (1 / np.arange(1, 10)).sum()
    assert np.all(np.abs(np.array(counts) - share) < 1)


def test_zipf_deck_by_hand():
    assert Counter(zipf_deck(TEMPLATES, 0.0, 18)) == Counter({t: 2 for t in TEMPLATES})
    got = Counter(zipf_deck(TEMPLATES, 1.0, 19))
    assert [got[t] for t in TEMPLATES] == [7, 3, 2, 2, 1, 1, 1, 1, 1]
    with pytest.raises(ValueError):
        zipf_deck(TEMPLATES, 1.0, 8)


def test_closed_mixes_share_one_deck():
    assert len({(traffic.load(m)["zipf_alpha"], traffic.load(m)["deck_size"])
                for m in MIXES}) == 1
