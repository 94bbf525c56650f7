"""The benchmark's frozen arithmetic: the card's peaks, the tensor-core
bound of a launch, the model flops of a serving step, and the percentile
rule. Nothing here reads the program: a change to the port cannot move
these numbers.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, no
sparsity, at the 700 W limit): 989 TFLOP/s in bf16 on the tensor cores,
3.35 TB/s of HBM3.
"""
from __future__ import annotations

import math

#: dense bf16 tensor-core peak of one H100 SXM, FLOP/s
PEAK_FLOPS = 989e12
#: HBM3 bandwidth of one H100 SXM, bytes/s
PEAK_BYTES = 3.35e12

F32 = 4


def tc_bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes over bandwidth or flops
    over the tensor-core peak, whichever is larger."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS)


def nearest_rank(values, q: float) -> float:
    """The q-quantile (0 < q <= 1) by nearest rank: the ceil(q * n)-th
    smallest value, a value of the sample itself."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of an empty sample")
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


# -- launches -----------------------------------------------------------------

def spx_matmul_cost(m: int, k: int, n: int, packed: bool,
                    lut_size: int) -> tuple[float, float]:
    """(bytes, flops) of one ``x (M, K) @ lut[codes] * scale`` launch: x
    read once, the codes (half a byte each when packed), the scales and
    the LUT read once, the output written once; 2 M K N flops."""
    codes = k * n // 2 if packed else k * n
    nbytes = m * k * F32 + codes + n * F32 + lut_size * F32 + m * n * F32
    return float(nbytes), 2.0 * m * k * n


def paged_decode_cost(ctx, n_valid, *, n_heads: int, n_kv_heads: int,
                      head_dim: int) -> tuple[float, float]:
    """(bytes, flops) of one layer's ragged decode launch over rows with
    ``ctx[i]`` tokens in the pages and ``n_valid[i]`` new queries: the
    K and V of every token a row attends read once (f32), q read and the
    output written once; 4 Hq dh flops per (query, key) pair."""
    nbytes = flops = 0.0
    for c, w in zip(ctx, n_valid):
        c, w = int(c), int(w)
        if w <= 0:
            continue
        nbytes += (c + w) * n_kv_heads * head_dim * F32 * 2
        nbytes += 2 * w * n_heads * head_dim * F32
        pairs = w * c + w * (w + 1) // 2
        flops += 4.0 * n_heads * head_dim * pairs
    return nbytes, flops


def moe_cost(arch: dict, rows: int, valid: int) -> tuple[float, float]:
    """(bytes, flops) of one MoE layer over ``rows`` rows of which
    ``valid`` carry a token: every expert's 4-bit codes and f32 column
    scales read once, the rows read and written once (f32); the router's
    2 D E flops per row and 6 D F flops per routed (token, expert)
    assignment, top_k of them per valid token."""
    d, f, e = arch["d_model"], arch["d_ff"], arch["n_experts"]
    codes = e * 3 * d * f // 2
    scales = e * (2 * f + d) * F32
    nbytes = codes + scales + 2 * rows * d * F32
    flops = 2.0 * d * e * rows + 6.0 * d * f * arch["top_k"] * valid
    return float(nbytes), flops


# -- the model ----------------------------------------------------------------

def _slot_kinds(arch: dict):
    """(mixer, ffn) of every layer, in order."""
    pattern = arch["pattern"]
    for i in range(arch["n_layers"]):
        mixer, _, ffn = pattern[i % len(pattern)].partition("+")
        yield mixer, ffn


def active_matmul_params(arch: dict) -> int:
    """Weights one token multiplies by on its way through the stack:
    attention's four projections, the dense FFN or the router and top_k
    experts. The head is counted apart (only where logits are taken)."""
    d, dh = arch["d_model"], arch["head_dim"]
    hq, hkv = arch["n_heads"], arch["n_kv_heads"]
    total = 0
    for mixer, ffn in _slot_kinds(arch):
        if mixer != "attn":
            raise ValueError(f"no flop rule for mixer {mixer!r}")
        total += 2 * d * hq * dh + 2 * d * hkv * dh
        if ffn == "dense":
            total += 3 * d * arch["d_ff"]
        elif ffn == "moe":
            total += d * arch["n_experts"]
            total += arch["top_k"] * 3 * d * arch["d_ff"]
        elif ffn:
            raise ValueError(f"no flop rule for ffn {ffn!r}")
    return total


def n_attention_layers(arch: dict) -> int:
    return sum(1 for mixer, _ in _slot_kinds(arch) if mixer == "attn")


def step_flops(arch: dict, ctx, n_valid, logit_rows: int) -> float:
    """Useful flops of one model call: 2 x active weights per valid token,
    attention's 4 L H dh per (query, key) pair over each token's causal
    context, and the head's 2 D V for each of ``logit_rows`` rows.
    Padded rows and padded positions count nothing."""
    per_token = 2.0 * active_matmul_params(arch)
    attn = 4.0 * n_attention_layers(arch) * arch["n_heads"] * arch["head_dim"]
    flops = 0.0
    for c, w in zip(ctx, n_valid):
        c, w = int(c), int(w)
        if w <= 0:
            continue
        flops += per_token * w
        flops += attn * (w * c + w * (w + 1) // 2)
    return flops + 2.0 * arch["d_model"] * arch["vocab_size"] * logit_rows
