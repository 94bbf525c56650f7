"""The traffic generator: the same seed gives the same requests, every
seed the same bands of lengths and gaps in another order, and every
length within its clips."""
import collections
import json

import numpy as np
import pytest

from perfbench import harness
from perfbench.traffic import Traffic, exponential_gaps, lognormal_sizes

MIXES = sorted(p.stem for p in (harness.ROOT / "traffic").glob("*.json"))
SEEDS = (0, 7, 2 ** 31 + 11, 2 ** 33 + 5)


def _spec(name):
    with open(harness.ROOT / "traffic" / f"{name}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("mix", MIXES)
def test_deterministic_by_seed(mix):
    spec = _spec(mix)
    a, b = Traffic(spec, 2 ** 31 + 3, 1000), Traffic(spec, 2 ** 31 + 3, 1000)
    for i in (0, 1, 63, 64, 500):
        x, y = a.item(i), b.item(i)
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new_tokens, x.gap_s) == (y.max_new_tokens, y.gap_s)
    c = Traffic(spec, 2 ** 31 + 4, 1000)
    assert any(not np.array_equal(a.item(i).prompt, c.item(i).prompt)
               for i in range(4))


@pytest.mark.parametrize("mix", MIXES)
def test_within_clips_and_context(mix):
    spec = _spec(mix)
    for seed in SEEDS:
        t = Traffic(spec, seed, 50304)
        for i in range(0, 3 * spec["strata"], 5):
            it = t.item(i)
            assert spec["prompt"]["min"] <= len(it.prompt) <= \
                spec["prompt"]["max"]
            assert spec["output"]["min"] <= it.max_new_tokens <= \
                spec["output"]["max"]
            assert len(it.prompt) + it.max_new_tokens <= \
                spec["serve"]["max_seq"]
            assert it.prompt.min() >= 0 and it.prompt.max() < 50304


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_serves_the_same_requests_per_block(mix):
    """Interleaved: the same (prompt, output) pairs in every block, in
    another order. Shuffled: one prompt, one output length and one gap of
    each band in every block, the pairing and the order the seed's, the
    gaps spanning strata / rate seconds."""
    spec = _spec(mix)
    n = spec["strata"]
    blocks, orders = set(), set()
    for seed in SEEDS:
        t = Traffic(spec, seed, 100)
        for block in (0, 3):
            sizes = [t.sizes(block * n + j) for j in range(n)]
            gaps = [t.gap(block * n + j) for j in range(n)]
            orders.add(tuple(sizes))
            if t.order == "interleaved":
                blocks.add(tuple(sorted(sizes)))
                assert sorted(gaps) == sorted(t.gap(j) for j in range(n))
                continue
            for key, col in (("prompt", 0), ("output", 1)):
                lo = lognormal_sizes(spec[key], n, np.zeros(n))
                hi = lognormal_sizes(spec[key], n, np.ones(n) - 1e-9)
                got = np.sort([s[col] for s in sizes])
                assert (lo <= got).all() and (got <= hi).all()
            if spec["loop"] == "open":
                assert sum(gaps) == pytest.approx(n / spec["rate_per_s"])
                assert len(set(gaps)) == n
    assert len(blocks) <= 1              # interleaved: the same pairs
    assert len(orders) > 1               # in another order


def test_shuffled_pairs_by_seed():
    spec = dict(_spec(MIXES[0]), order="shuffled", strata=16, loop="open",
                rate_per_s=2.0)
    pairs = {tuple(Traffic(spec, seed, 100).sizes(j) for j in range(16))
             for seed in SEEDS}
    assert len(pairs) == len(SEEDS)


def test_gaps_average_the_rate():
    rng = np.random.default_rng(0)
    for rate in (0.5, 4.0, 9.0):
        for u in (None, rng.random(64)):
            g = exponential_gaps(rate, 64, u)
            assert abs(g.mean() - 1 / rate) < 1e-12 and (g > 0).all()
