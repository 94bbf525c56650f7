"""Procedural MNIST-like digits (offline container: no downloads).

Each class is a set of stroke segments on a 28x28 canvas; samples add
per-example jitter (translation, thickness, amplitude noise) so a classifier
has real within-class variance to learn. Not MNIST pixels, but the same
task shape: 784-dim grayscale in [0,1], 10 classes — enough to reproduce
the paper's §4.1 training curves and the quantized-inference accuracy
comparison on real learned weights.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_dataset", "SynthDigits"]

# stroke endpoints per digit on a [0,1]^2 canvas: (x0, y0, x1, y1)
_STROKES = {
    0: [(.3, .2, .7, .2), (.7, .2, .7, .8), (.7, .8, .3, .8), (.3, .8, .3, .2)],
    1: [(.5, .2, .5, .8), (.4, .3, .5, .2)],
    2: [(.3, .3, .5, .2), (.5, .2, .7, .3), (.7, .3, .3, .8), (.3, .8, .7, .8)],
    3: [(.3, .2, .7, .3), (.7, .3, .5, .5), (.5, .5, .7, .7), (.7, .7, .3, .8)],
    4: [(.6, .2, .3, .6), (.3, .6, .75, .6), (.65, .4, .65, .85)],
    5: [(.7, .2, .3, .2), (.3, .2, .3, .5), (.3, .5, .7, .6), (.7, .6, .6, .8),
        (.6, .8, .3, .8)],
    6: [(.65, .2, .35, .5), (.35, .5, .35, .75), (.35, .75, .65, .75),
        (.65, .75, .65, .55), (.65, .55, .35, .55)],
    7: [(.3, .2, .7, .2), (.7, .2, .45, .8)],
    8: [(.5, .2, .3, .35), (.3, .35, .7, .6), (.7, .6, .5, .8), (.5, .8, .3, .6),
        (.3, .6, .7, .35), (.7, .35, .5, .2)],
    9: [(.65, .45, .35, .45), (.35, .45, .35, .25), (.35, .25, .65, .25),
        (.65, .25, .65, .8), (.65, .8, .45, .85)],
}


def _render(strokes, rng, size=28, thickness=1.3):
    img = np.zeros((size, size), np.float32)
    dx, dy = rng.uniform(-2.5, 2.5, 2)
    th = thickness * rng.uniform(0.7, 1.5)
    amp = rng.uniform(0.75, 1.0)
    jit = rng.uniform(-0.025, 0.025, (len(strokes), 4))
    ys, xs = np.mgrid[0:size, 0:size]
    for (x0, y0, x1, y1), j in zip(strokes, jit):
        x0, y0, x1, y1 = (np.array([x0, y0, x1, y1]) + j) * size
        x0 += dx; x1 += dx; y0 += dy; y1 += dy
        # distance from each pixel to the segment
        px, py = xs + 0.5, ys + 0.5
        vx, vy = x1 - x0, y1 - y0
        ll = max(vx * vx + vy * vy, 1e-6)
        t = np.clip(((px - x0) * vx + (py - y0) * vy) / ll, 0, 1)
        d2 = (px - (x0 + t * vx)) ** 2 + (py - (y0 + t * vy)) ** 2
        img = np.maximum(img, amp * np.exp(-d2 / (2 * th * th)))
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0, 1)


def make_dataset(n: int, *, seed: int = 0, flat: bool = True):
    """Returns (x (n, 784) float32 in [0,1], y (n,) int32)."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, 10, n).astype(np.int32)
    xs = np.stack([_render(_STROKES[int(c)], rng) for c in ys])
    if flat:
        xs = xs.reshape(n, -1)
    return xs.astype(np.float32), ys


class SynthDigits:
    """Mini-batch iterator matching the paper's training setup (B=64)."""

    def __init__(self, n_train=8192, n_test=2048, batch_size=64, seed=0):
        self.x_train, self.y_train = make_dataset(n_train, seed=seed)
        self.x_test, self.y_test = make_dataset(n_test, seed=seed + 1)
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed + 2)

    def batches(self, epochs: int = 1):
        n = len(self.x_train)
        for _ in range(epochs):
            order = self._rng.permutation(n)
            for i in range(0, n - self.batch_size + 1, self.batch_size):
                idx = order[i:i + self.batch_size]
                yield self.x_train[idx], self.y_train[idx]
