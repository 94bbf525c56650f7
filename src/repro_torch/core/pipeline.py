"""Analytical model of the paper's §3.1 load/compute decoupling.

The paper's input buffer decouples RAM->buffer loading (clk_inbuff) from
PU compute (clk_compute); the pipeline is sound iff loading stays ahead of
compute. A tiled matrix product on a GPU keeps the same condition: while
the tensor cores work on one (activation, weight-code) tile, the copy of
the next tile from device memory into shared memory must finish:

    t_load(block)    = bytes(block) / hbm_bw
    t_compute(block) = flops(block) / peak_bf16_flops

``plan_matmul_blocks`` evaluates that inequality for candidate tile shapes
and keeps the one with the largest margin whose double-buffered working
set fits a block's shared memory. The arithmetic is the reference's
(``repro.core.pipeline``), verbatim; only the default hardware differs:
the port's is one H100 SXM (``H100_SXM``). The port's kernels choose their
own tiles; this model reports the paper's feasibility margin
(``benchmarks/fig5.py``).

Quantization enters t_load directly: b-bit SPx codes shrink the weight
tile's bytes by 16/b against bf16, which widens the margin and shrinks the
working set.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["HwSpec", "H100_SXM", "BlockPlan", "plan_matmul_blocks"]


@dataclasses.dataclass(frozen=True)
class HwSpec:
    """One accelerator, in the reference's fields. On Hopper:

    peak_bf16_flops  dense bf16 tensor-core rate of the card, FLOP/s
    hbm_bw           device-memory (HBM3) bandwidth, bytes/s
    ici_bw           NVLink bandwidth to the other cards of the host, per
                     direction, bytes/s
    vmem_bytes       shared memory one thread block may opt into, bytes
                     (the working set of one tile lives there)
    mxu_dim          rows of one warpgroup ``wgmma`` (its M): the smallest
                     tile the planner falls back to
    """
    name: str
    peak_bf16_flops: float
    hbm_bw: float
    ici_bw: float
    vmem_bytes: int
    mxu_dim: int = 128


#: NVIDIA H100 SXM5 (data sheet and Hopper white paper): 989 TFLOP/s dense
#: bf16, 3.35 TB/s HBM3, NVLink 900 GB/s all to all (450 each way), 227 KiB
#: of shared memory per block, 64-row wgmma.
H100_SXM = HwSpec(
    name="h100_sxm",
    peak_bf16_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    vmem_bytes=227 * 1024,
    mxu_dim=64,
)


@dataclasses.dataclass
class BlockPlan:
    bm: int
    bn: int
    bk: int
    weight_bits: int
    vmem_bytes: int             # working set incl. double buffers + acc
    t_load: float               # s, per tile step (next tile's copy)
    t_compute: float            # s, per tile step (tensor cores on this one)
    pipelined: bool             # t_load <= t_compute (paper's condition)
    arithmetic_intensity: float # flops / HBM byte for the whole matmul

    @property
    def margin(self) -> float:
        """compute/load ratio; >1 means the copy is fully hidden."""
        return self.t_compute / max(self.t_load, 1e-30)


def _block_cost(m, n, k, bm, bn, bk, weight_bits, act_bytes, hw: HwSpec):
    # Per tile step one activation tile (bm x bk) and one weight tile
    # (bk x bn) at `weight_bits` stream in; the f32 accumulator (bm x bn)
    # stays on chip across the k-loop (written back once per (m, n) tile).
    load_bytes = bm * bk * act_bytes + bk * bn * weight_bits / 8
    flops = 2.0 * bm * bn * bk
    t_load = load_bytes / hw.hbm_bw
    t_compute = flops / hw.peak_bf16_flops
    # double-buffered inputs + accumulator + dequantized weight tile
    vmem = 2 * (bm * bk * act_bytes + bk * bn * weight_bits / 8) \
        + bm * bn * 4 + bk * bn * 2
    return load_bytes, flops, t_load, t_compute, int(vmem)


def plan_matmul_blocks(m: int, n: int, k: int, *, weight_bits: int = 16,
                       act_bytes: int = 2, hw: HwSpec = H100_SXM,
                       candidates=(128, 256, 512, 1024, 2048),
                       vmem_fraction: float = 0.9) -> BlockPlan:
    """Pick (bm, bn, bk) from ``candidates`` maximizing the pipeline margin
    subject to the working set fitting ``vmem_fraction`` of
    ``hw.vmem_bytes``, as the reference does. (The reference's per-dimension
    candidate lists serve its block planner, which the port does not
    have.)

    When no candidate fits (on ``H100_SXM``, 16-bit weights at the
    smallest candidate, 128 x 128 x 128, need 224 KiB against a budget of
    204 KiB), the plan is one ``hw.mxu_dim`` tile in each dimension with
    the reference's nominal intensity ``2 * mxu_dim / 3``.
    """
    best = None
    for bm in candidates:
        if bm > max(m, hw.mxu_dim):
            continue
        for bn in candidates:
            if bn > max(n, hw.mxu_dim):
                continue
            for bk in candidates:
                if bk > max(k, hw.mxu_dim):
                    continue
                load_b, flops, t_l, t_c, vmem = _block_cost(
                    m, n, k, bm, bn, bk, weight_bits, act_bytes, hw)
                if vmem > hw.vmem_bytes * vmem_fraction:
                    continue
                # whole-matmul arithmetic intensity at this blocking: the
                # activation tile re-streams once per n-block, weights once
                # per m-block.
                n_m, n_n, n_k = (math.ceil(m / bm), math.ceil(n / bn),
                                 math.ceil(k / bk))
                total_bytes = (n_n * m * k * act_bytes
                               + n_m * k * n * weight_bits / 8
                               + m * n * act_bytes)
                ai = (2.0 * m * n * k) / total_bytes
                plan = BlockPlan(bm, bn, bk, weight_bits, vmem, t_l, t_c,
                                 t_l <= t_c, ai)
                key = (plan.pipelined, plan.margin, -vmem)
                if best is None or key > (best.pipelined, best.margin,
                                          -best.vmem_bytes):
                    best = plan
    if best is None:  # nothing fits: one mxu_dim tile
        load_b, flops, t_l, t_c, vmem = _block_cost(
            m, n, k, hw.mxu_dim, hw.mxu_dim, hw.mxu_dim, weight_bits,
            act_bytes, hw)
        best = BlockPlan(hw.mxu_dim, hw.mxu_dim, hw.mxu_dim, weight_bits,
                         vmem, t_l, t_c, t_l <= t_c, 2.0 * hw.mxu_dim / 3)
    return best
