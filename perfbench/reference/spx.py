"""A frozen copy of the SPx arithmetic that the configurations state for
their weights (the paper's sum-of-powers-of-two codes, here ``sp2_4``):
the level set, the per-column MSE calibration of the scale and the
nearest-level rounding, in plain torch. It reproduces the codes a
conforming quantizer gives, bit for bit on the same device and shapes,
and returns the dequantized f32 weight. Imports torch and numpy only.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

#: per-term bit widths of the SPx schemes the configurations may state
SCHEMES = {"sp2_4": (2, 1)}


@functools.lru_cache(maxsize=None)
def levels(scheme: str) -> np.ndarray:
    """±sum of one power-of-two term per width b (0 or ±2^-1 ...
    ±2^-(2^b - 1)), normalized to a largest magnitude of 1, ascending."""
    acc = np.array([0.0])
    for b in SCHEMES[scheme]:
        mags = 0.5 ** np.arange(1, 2 ** b)
        term = np.concatenate([[0.0], mags, -mags])
        acc = (acc[:, None] + term[None, :]).ravel()
    lv = np.unique(np.concatenate([acc, -acc]))
    return (lv / np.abs(lv).max()).astype(np.float64)


def _lut(lv: np.ndarray, device) -> torch.Tensor:
    n = len(lv)
    size = 2 ** max(1, int(np.ceil(np.log2(n))))
    padded = np.concatenate([lv, np.full(size - n, lv[-1])])
    return torch.as_tensor(padded.astype(np.float32), device=device)


def _codes(x: torch.Tensor, lv: np.ndarray, scale: torch.Tensor):
    """Nearest level of x / scale: a search over the f32 midpoints, a
    value on a midpoint taking the lower level."""
    mids = torch.as_tensor(((lv[1:] + lv[:-1]) / 2.0).astype(np.float32),
                           device=x.device)
    xn = torch.clamp((x / scale).to(torch.float32), float(lv[0]),
                     float(lv[-1]))
    return torch.searchsorted(mids, xn.contiguous(), right=False,
                              out_int32=True).to(torch.uint8)


def fake_quantize(w: torch.Tensor, scheme: str, *, num_grid: int = 24,
                  lo: float = 0.4, hi: float = 1.05) -> torch.Tensor:
    """The dequantized f32 weight of ``w`` (..., K, N): one scale per
    output column (and per leading index), the fraction of the column's
    largest magnitude, among ``num_grid`` evenly spaced in [lo, hi], that
    leaves the least squared error (the first such on a tie)."""
    lv = levels(scheme)
    lut = _lut(lv, w.device)
    axes = (w.ndim - 2,)
    base = torch.clamp(torch.amax(torch.abs(w), dim=axes, keepdim=True),
                       min=1e-12)
    w32 = w.to(torch.float32)
    best_err = best_frac = None
    for f in np.linspace(lo, hi, num_grid).astype(np.float32):
        frac = torch.tensor(f, dtype=torch.float32, device=w.device)
        scale = base * frac
        wh = lut[_codes(w, lv, scale).long()] * scale
        err = torch.sum((wh - w32) ** 2, dim=axes, keepdim=True)
        if best_err is None:
            best_err, best_frac = err, torch.full_like(err, float(f))
        else:
            better = err < best_err
            best_err = torch.where(better, err, best_err)
            best_frac = torch.where(better, frac, best_frac)
    scale = (base * best_frac).to(torch.float32)
    return lut[_codes(w, lv, scale).long()] * scale


def is_quantized(path: tuple, leaf: torch.Tensor, rule: dict) -> bool:
    """Whether the configuration states ``leaf`` at ``path`` in codes: a
    matrix (or stack) of at least ``min_size`` elements with an even last
    dimension, none of whose path keys is a dense one."""
    if set(path) & set(rule["dense_keys"]):
        return False
    return (leaf.ndim >= 2 and leaf.numel() >= rule["min_size"]
            and leaf.shape[-1] % 2 == 0)
