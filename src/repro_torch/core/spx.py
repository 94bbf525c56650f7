"""SPx non-uniform quantization (the paper's §3.2, Eq. 3.1 / 3.3 / 3.4).

The paper generalizes Power-of-Two (PoT) quantization to *sums of x
power-of-two terms*:

    Q(b, alpha) = ±alpha * sum_i q_i,
    q_i in {0, ±1/2^(2^{b_i}-1), ±1/2^(2^{b_i}-2), ..., ±1/2},
    b = 1 (sign) + sum_i b_i.

The level sets are numpy (built once per scheme and cached); quantize and
dequantize run on torch tensors on whatever device the input lives on.
Codes are bit-identical to ``repro.core.spx`` for every scheme: the
midpoints are rounded to f32 before the search, and a value exactly on a
midpoint takes the lower level (``searchsorted`` with ``side="left"``).
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "pot_levels", "sp2_levels", "spx_levels", "uniform_levels", "codebook",
    "quantize_to_codes", "dequantize_codes", "calibrate_minmax",
    "calibrate_mse", "pack_int4", "unpack_int4", "SCHEMES", "scheme_levels",
    "code_width", "KV_CODE_BYTES", "KV_SCALE_BYTES", "kv_token_side_bytes",
]

#: Quantized KV-cache storage layout: one uint8 code per element plus one
#: f32 scale per (token, head) side.
KV_CODE_BYTES = 1
KV_SCALE_BYTES = 4


def kv_token_side_bytes(dh: int) -> int:
    """Bytes one token's K *or* V occupies for one KV head in the
    quantized codes+scale cache layout."""
    return dh * KV_CODE_BYTES + KV_SCALE_BYTES


# ---------------------------------------------------------------------------
# Level-set construction (numpy; done once per scheme, cached)
# ---------------------------------------------------------------------------

def _single_term_set(b_i: int) -> np.ndarray:
    """q_i in {0, ±1/2^(2^{b_i}-1), ..., ±1/2}  (paper Eq. 3.4, inner set)."""
    if b_i <= 0:
        return np.array([0.0])
    exps = np.arange(1, 2 ** b_i)          # 1 .. 2^{b_i}-1
    mags = 0.5 ** exps                     # 1/2 .. 1/2^(2^{b_i}-1)
    return np.concatenate([[0.0], mags, -mags])


@functools.lru_cache(maxsize=None)
def spx_levels(term_bits: tuple[int, ...]) -> np.ndarray:
    """Canonical SPx level set on [-1, 1] for the given per-term bit widths
    (Eq. 3.4): all distinct values of ±sum_i q_i, normalized so the largest
    magnitude is exactly 1, sorted ascending."""
    acc = np.array([0.0])
    for b_i in term_bits:
        term = _single_term_set(int(b_i))
        acc = (acc[:, None] + term[None, :]).ravel()
    acc = np.concatenate([acc, -acc])
    levels = np.unique(acc)
    m = np.abs(levels).max()
    if m > 0:
        levels = levels / m
    return levels.astype(np.float64)


@functools.lru_cache(maxsize=None)
def pot_levels(b: int) -> np.ndarray:
    """Eq. 3.1: alpha * {0, ±1/2^(2^{b-1}-1), ..., ±1/2, ±1}."""
    exps = np.arange(0, 2 ** (b - 1))
    mags = 0.5 ** exps
    levels = np.unique(np.concatenate([[0.0], mags, -mags]))
    return levels.astype(np.float64)


def sp2_levels(b: int) -> np.ndarray:
    """Eq. 3.3 with the balanced split b1 + b2 = b - 1 (Chang et al.)."""
    b1 = (b - 1 + 1) // 2
    b2 = (b - 1) - b1
    return spx_levels((b1, b2))


@functools.lru_cache(maxsize=None)
def uniform_levels(b: int) -> np.ndarray:
    """Symmetric uniform b-bit levels (the §3.2.A baseline)."""
    n = 2 ** (b - 1) - 1
    return (np.arange(-n, n + 1) / n).astype(np.float64)


#: Named schemes; names carry the *code width* (bits stored per weight).
SCHEMES = {
    "uniform8": ("uniform", 8),
    "uniform4": ("uniform", 4),
    "pot4": ("pot", 4),
    "pot3": ("pot", 3),
    "sp2_4": ("spx", (2, 1)),        # 4-bit SP2 (15 levels)
    "sp2_8": ("spx", (4, 2)),        # 8-bit SP2 (179 levels)
    "spx_5_x3": ("spx", (2, 2, 1)),  # 5-bit, x=3 terms — the paper's extension
    "spx_8_x3": ("spx", (3, 2, 2)),  # 8-bit, x=3 terms (131 levels)
}


def scheme_levels(scheme: str) -> np.ndarray:
    family, arg = SCHEMES[scheme]
    if family == "uniform":
        return uniform_levels(arg)
    if family == "pot":
        return pot_levels(arg)
    if family == "spx":
        return spx_levels(tuple(arg))
    raise ValueError(f"unknown scheme family {family!r}")


def code_width(levels: np.ndarray | Sequence[float]) -> int:
    """Bits needed to index the level set."""
    n = len(levels)
    return max(1, int(np.ceil(np.log2(n))))


# ---------------------------------------------------------------------------
# Codebook quantize / dequantize
# ---------------------------------------------------------------------------

def codebook(levels: np.ndarray, dtype=torch.float32,
             device=None) -> torch.Tensor:
    """Levels as a LUT tensor, padded to the next power of two so codes
    fill the integer range (padding repeats the last level — those codes
    are never produced by quantize)."""
    n = len(levels)
    size = 2 ** code_width(levels)
    padded = np.concatenate([levels, np.full(size - n, levels[-1])])
    return torch.as_tensor(padded.astype(np.float32), device=device).to(dtype)


def _midpoints(levels: np.ndarray) -> np.ndarray:
    return (levels[1:] + levels[:-1]) / 2.0


def quantize_to_codes(x: torch.Tensor, levels: np.ndarray,
                      scale: torch.Tensor) -> torch.Tensor:
    """Nearest-level uint8 codes for ``x`` given a broadcastable per-channel
    ``scale``: searchsorted over the f32 midpoints, ties to the lower
    level."""
    mids = torch.as_tensor(_midpoints(levels).astype(np.float32),
                           device=x.device)
    xn = (x / scale).to(torch.float32)
    xn = torch.clamp(xn, float(levels[0]), float(levels[-1]))
    codes = torch.searchsorted(mids, xn.contiguous(), right=False,
                               out_int32=True)
    return codes.to(torch.uint8)


def dequantize_codes(codes: torch.Tensor, lut: torch.Tensor,
                     scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """codes -> lut[codes] * scale. ``lut`` from ``codebook()``."""
    return (lut[codes.long()] * scale).to(dtype)


# ---------------------------------------------------------------------------
# Calibration of alpha (per-channel scale)
# ---------------------------------------------------------------------------

def _reduce_axes(x: torch.Tensor, channel_axis: int | None,
                 axes: tuple | None = None) -> tuple:
    if axes is not None:
        return tuple(a % x.ndim for a in axes)
    if channel_axis is None:
        return tuple(range(x.ndim))
    channel_axis = channel_axis % x.ndim
    return tuple(a for a in range(x.ndim) if a != channel_axis)


def calibrate_minmax(x: torch.Tensor, channel_axis: int | None = -1,
                     axes: tuple | None = None) -> torch.Tensor:
    """alpha = max|x| per channel (keepdims). ``axes`` overrides
    ``channel_axis``: reduce exactly those axes."""
    axes = _reduce_axes(x, channel_axis, axes)
    a = torch.amax(torch.abs(x), dim=axes, keepdim=True)
    return torch.clamp(a, min=1e-12)


def calibrate_mse(x: torch.Tensor, scheme: str,
                  channel_axis: int | None = -1, num_grid: int = 24,
                  lo: float = 0.4, hi: float = 1.05,
                  axes: tuple | None = None) -> torch.Tensor:
    """MSE-optimal alpha: sweep a grid of fractions of max|x| per channel
    and keep the scale with the least quantization error. A running
    minimum replaces the reference's stack of every grid point's error, so
    a full-width stacked weight never holds ``num_grid`` error tensors; a
    strict ``<`` keeps the first minimum, as ``argmin`` does."""
    levels = scheme_levels(scheme)
    lut = codebook(levels, device=x.device)
    base = calibrate_minmax(x, channel_axis, axes)
    fracs = np.linspace(lo, hi, num_grid).astype(np.float32)
    axes = _reduce_axes(x, channel_axis, axes)
    x32 = x.to(torch.float32)
    best_err = best_frac = None
    for f in fracs:
        frac = torch.tensor(f, dtype=torch.float32, device=x.device)
        scale = base * frac
        codes = quantize_to_codes(x, levels, scale)
        xh = dequantize_codes(codes, lut, scale)
        err = torch.sum((xh - x32) ** 2, dim=axes, keepdim=True)
        if best_err is None:
            best_err, best_frac = err, torch.full_like(err, float(f))
        else:
            better = err < best_err
            best_err = torch.where(better, err, best_err)
            best_frac = torch.where(better, frac, best_frac)
    return base * best_frac


# ---------------------------------------------------------------------------
# int4 packing (two codes per byte)
# ---------------------------------------------------------------------------

def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack uint8 codes (<16) pairwise along the LAST axis: even index ->
    low nibble. Last dim must be even."""
    if codes.shape[-1] % 2:
        raise ValueError(
            f"pack_int4 needs an even last dim (two 4-bit codes per byte); "
            f"got shape {tuple(codes.shape)} with last dim "
            f"{codes.shape[-1]}. Pad the weight or pass pack=False.")
    lo = codes[..., 0::2]
    hi = codes[..., 1::2]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4; doubles the last axis."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2).to(torch.uint8)
