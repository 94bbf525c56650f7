"""QuantizedTensor: SPx-coded weight container.

A QuantizedTensor stores a 2-D (or stacked 3-D+, for layers stacked over
periods) weight as:
  * ``codes``  — uint8 level indices (optionally two int4 codes per byte),
  * ``scale``  — per-output-channel alpha (float32, broadcastable),
  * a static codebook identified by ``scheme`` (LUT made on demand).

The hand-written Hopper kernel that multiplies by it lives in
``repro_torch.kernels``; ``kernels.ops.spx_matmul`` selects it.
"""
from __future__ import annotations

import dataclasses

import torch

from . import spx

__all__ = ["QuantizedTensor", "quantize_weight", "dequantize"]


@dataclasses.dataclass
class QuantizedTensor:
    codes: torch.Tensor         # uint8; last dim possibly packed (int4)
    scale: torch.Tensor         # f32, broadcastable to logical shape
    scheme: str                 # key into spx.SCHEMES
    packed: bool                # True => two 4-bit codes per byte on last dim

    @property
    def logical_shape(self) -> tuple:
        s = tuple(self.codes.shape)
        return s[:-1] + (s[-1] * 2,) if self.packed else s

    @property
    def shape(self) -> tuple:
        return self.logical_shape

    @property
    def ndim(self) -> int:
        return len(self.logical_shape)

    @property
    def bits(self) -> int:
        return spx.code_width(spx.scheme_levels(self.scheme))

    def lut(self) -> torch.Tensor:
        return spx.codebook(spx.scheme_levels(self.scheme),
                            device=self.codes.device)

    def __getitem__(self, i) -> "QuantizedTensor":
        """Slice the leading (period / expert) dim of a stacked weight."""
        return QuantizedTensor(self.codes[i], self.scale[i], self.scheme,
                               self.packed)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.codes.to(device), self.scale.to(device),
                               self.scheme, self.packed)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize(self, dtype)


def quantize_weight(w: torch.Tensor, scheme: str = "sp2_4", *,
                    contract_axis: int = -2, calibration: str = "mse",
                    pack: bool | None = None) -> QuantizedTensor:
    """Quantize a weight tensor to SPx codes with per-channel calibration.
    The scale reduces over ``contract_axis`` only: per output channel for
    2-D (K, N) weights, per (layer, channel) for stacked (P, K, N) ones."""
    axes = (contract_axis,)
    if calibration == "mse":
        scale = spx.calibrate_mse(w, scheme, axes=axes)
    elif calibration == "minmax":
        scale = spx.calibrate_minmax(w, axes=axes)
    else:
        raise ValueError(f"unknown calibration {calibration!r}")
    levels = spx.scheme_levels(scheme)
    codes = spx.quantize_to_codes(w, levels, scale)
    width = spx.code_width(levels)
    if pack is None:
        pack = width <= 4 and w.shape[-1] % 2 == 0
    if pack and width > 4:
        raise ValueError(f"cannot int4-pack a {width}-bit scheme {scheme!r}")
    if pack:
        codes = spx.pack_int4(codes)
    return QuantizedTensor(codes, scale.to(torch.float32), scheme, bool(pack))


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    codes = spx.unpack_int4(qt.codes) if qt.packed else qt.codes
    return spx.dequantize_codes(codes, qt.lut(), qt.scale, dtype=dtype)
