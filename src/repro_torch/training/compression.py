"""SPx gradient compression with error feedback: the paper's quantizer on
the data-parallel gradient reduction (``repro.training.compression``).

Each eligible gradient leaf (floating, at least ``min_size`` elements) has
the residual of the previous step added back, is quantized to the
scheme's codes with one f32 scale per last-dim channel, and is replaced by
its dequantized value; the new residual (what quantization dropped) is
carried to the next step. Error feedback keeps the scheme unbiased over
time. The compressed representation here is the fake-quantized tensor:
a reduction then moves values that carry at most 8 bits of information.

    comp = GradCompressor("sp2_8")
    ef = comp.init(grads)                     # error-feedback buffers
    grads_c, ef = comp.compress(grads, ef)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import spx
from repro_torch.nn.layers import tree_leaves, tree_map

__all__ = ["GradCompressor"]


@dataclasses.dataclass(frozen=True)
class GradCompressor:
    scheme: str = "sp2_8"
    min_size: int = 4096        # small leaves are not compressed

    def _eligible(self, leaf: torch.Tensor) -> bool:
        return leaf.numel() >= self.min_size and leaf.is_floating_point()

    def init(self, grads):
        """Zero residuals: f32 of each eligible leaf's shape, a scalar 0
        for the others."""
        return tree_map(
            lambda _, g: torch.zeros(g.shape if self._eligible(g) else (),
                                     dtype=torch.float32, device=g.device),
            grads)

    def compress(self, grads, ef):
        """Returns (compressed grads, new error-feedback state), trees of
        the grads' structure."""
        levels = spx.scheme_levels(self.scheme)
        flat_e = iter(tree_leaves(ef))
        out = []

        def one(_, g):
            e = next(flat_e)
            if not self._eligible(g):
                out.append(torch.zeros((), dtype=torch.float32,
                                       device=g.device))
                return g
            g32 = g.to(torch.float32) + e            # add back the residual
            scale = torch.clamp(torch.amax(torch.abs(g32), dim=-1,
                                           keepdim=True), min=1e-20)
            codes = spx.quantize_to_codes(g32, levels, scale)
            gq = spx.dequantize_codes(
                codes, spx.codebook(levels, device=g.device), scale)
            out.append(g32 - gq)                     # the new residual
            return gq.to(g.dtype)

        gq = tree_map(one, grads)
        it = iter(out)
        return gq, tree_map(lambda _, g: next(it), grads)

    def wire_bits(self) -> int:
        return spx.code_width(spx.scheme_levels(self.scheme))
