"""The one traffic generator: every mix is a data file under
``perfbench/traffic/`` that this module reads.

Lengths are lognormal (a median and a sigma, clipped to [min, max]),
inter-arrival gaps exponential (a Poisson stream at ``rate_per_s``).
Both are drawn by stratified quantiles: the requests come in blocks of
``strata``, each holding one prompt length, one output length and one
gap of each of ``strata`` equal-probability bands. So every seed offers
the same amount of work per block, where free draws let the seed move
the work, and the tails spread from seed to seed by as much again. The
mix's ``order`` says what the seed draws within a block:

* ``"interleaved"`` (``strata`` a power of two): a band's middle
  quantile; a prompt band paired with an output band by one fixed
  permutation; the bands in bit-reversed order (long and short
  alternating evenly), rotated by a seeded offset. Two seeds differ in
  that phase and in the prompt tokens. For a closed loop, whose
  arrivals are its completions.
* ``"shuffled"``: within each band a quantile drawn from the seed; the
  prompt bands, the output bands and the gaps each in an order of their
  own drawn from the seed, so the pairing of prompt and output lengths
  is the seed's too. The gaps are scaled to span ``strata / rate_per_s``
  seconds a block: the arrivals are a Poisson stream conditioned on its
  count in each block, bursts included.

Prompt tokens are uniform over the vocabulary, drawn per request from
(seed, stream, index).
"""
from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np

_NORMAL = statistics.NormalDist()


@dataclasses.dataclass(frozen=True)
class Item:
    index: int
    prompt: np.ndarray          # (len,) int32
    max_new_tokens: int
    gap_s: float                # open loop: time since the previous arrival


def _band_quantiles(strata: int, u=None) -> np.ndarray:
    """One quantile per band: its middle, or ``u`` (in [0, 1)) into it."""
    return (np.arange(strata) + (0.5 if u is None else u)) / strata


def lognormal_sizes(spec: dict, strata: int, u=None) -> np.ndarray:
    """One length per band, ascending: exp(ln(median) + sigma z_q),
    rounded and clipped to [min, max]."""
    mu, sigma = math.log(spec["median"]), spec["sigma"]
    q = np.clip(_band_quantiles(strata, u), 1e-12, 1 - 1e-12)
    z = np.array([_NORMAL.inv_cdf(float(x)) for x in q])
    sizes = np.rint(np.exp(mu + sigma * z)).astype(np.int64)
    return np.clip(sizes, spec["min"], spec["max"])


def exponential_gaps(rate: float, strata: int, u=None) -> np.ndarray:
    """One gap per band of an exponential of mean 1 / rate, scaled to
    that mean exactly."""
    q = np.clip(_band_quantiles(strata, u), 0.0, 1 - 1e-12)
    g = -np.log1p(-q)
    return g / g.mean() / rate


class Traffic:
    """The requests of one mix under one seed, by index."""

    def __init__(self, spec: dict, seed: int, vocab: int, *,
                 stream: int = 0):
        self.spec, self.seed, self.vocab = spec, int(seed), int(vocab)
        self.stream = stream
        self.strata = int(spec["strata"])
        self.order = spec.get("order", "interleaved")
        self.open = spec["loop"] == "open"
        if self.order == "interleaved":
            if self.strata < 1 or self.strata & (self.strata - 1):
                raise ValueError(f"strata must be a power of two, got "
                                 f"{self.strata}")
            bits = self.strata.bit_length() - 1
            self._interleaved = np.array(
                [int(format(i, f"0{bits}b")[::-1] or "0", 2)
                 for i in range(self.strata)])
            #: the output band of each prompt band: fixed, not seeded
            self._pairing = np.random.Generator(np.random.PCG64(
                np.random.SeedSequence([self.strata]))).permutation(
                    self.strata)
        elif self.order != "shuffled" or self.strata < 1:
            raise ValueError(f"unknown order {self.order!r} or strata "
                             f"{self.strata}")
        self._blocks: dict[int, tuple] = {}

    def _block(self, block: int) -> tuple:
        """(prompt lengths, output lengths, gaps) of the block's positions."""
        got = self._blocks.get(block)
        if got is not None:
            return got
        n, spec = self.strata, self.spec
        rng = np.random.Generator(np.random.PCG64(
            np.random.SeedSequence([self.seed, self.stream, 1, block])))
        if self.order == "interleaved":
            prompt = lognormal_sizes(spec["prompt"], n)
            output = lognormal_sizes(spec["output"], n)[self._pairing]
            bands = np.roll(self._interleaved, int(rng.integers(n)))
            gap_bands = np.roll(self._interleaved, int(rng.integers(n)))
            gaps = (exponential_gaps(spec["rate_per_s"], n)[gap_bands]
                    if self.open else np.zeros(n))
            got = (prompt[bands], output[bands], gaps)
        else:
            prompt = lognormal_sizes(spec["prompt"], n, rng.random(n))
            output = lognormal_sizes(spec["output"], n, rng.random(n))
            gaps = (exponential_gaps(spec["rate_per_s"], n, rng.random(n))
                    if self.open else np.zeros(n))
            got = (prompt[rng.permutation(n)], output[rng.permutation(n)],
                   gaps[rng.permutation(n)])
        self._blocks[block] = got
        return got

    def sizes(self, index: int) -> tuple[int, int]:
        block, j = divmod(index, self.strata)
        prompt, output, _ = self._block(block)
        return int(prompt[j]), int(output[j])

    def gap(self, index: int) -> float:
        """Open loop: seconds from arrival ``index - 1`` (or the start)
        to arrival ``index``; 0 in a closed loop."""
        block, j = divmod(index, self.strata)
        return float(self._block(block)[2][j])

    def item(self, index: int) -> Item:
        n_prompt, n_out = self.sizes(index)
        rng = np.random.Generator(np.random.PCG64(
            np.random.SeedSequence([self.seed, self.stream, 2, index])))
        prompt = rng.integers(0, self.vocab, size=n_prompt, dtype=np.int64)
        return Item(index, prompt.astype(np.int32), n_out, self.gap(index))
