"""Mixture-of-Experts (top-k, capacity-bounded), on one device.

The reference (``repro.nn.moe``) shards experts over a mesh's model axis
with ``shard_map``; this port runs the same body with every expert local
(the reference's ``model_axis=None`` path). Each expert takes at most
``C = expert_capacity(T, E, k, capacity_factor)`` of the T tokens it is
handed; assignments are queued token-major (token 0's k choices, then
token 1's, ...) and an assignment past its expert's capacity is dropped.
Every row of the (B, S) input is a token here, padding included, as in
the reference: which tokens drop depends on the whole batch.

Router ties: ``jax.lax.top_k`` takes the lower expert index first when two
probabilities are equal; a stable descending sort does the same here
(``torch.topk`` promises no order for ties on the card).

The experts run as the reference runs them, outside any kernel: each
stacked weight (E, D, F), a ``QuantizedTensor`` after ``quantize_params``,
is dequantized to the activation dtype and applied as a batched product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantized import QuantizedTensor, dequantize
from repro_torch.runtime import Runtime

from .layers import dense_init
from .mlp import mlp_apply, mlp_init

__all__ = ["moe_init", "moe_apply", "expert_capacity"]


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             *, n_shared: int = 0, dtype=torch.float32,
             device="cpu") -> dict:
    """Experts are stacked swiglu FFNs: gate/up (E, D, F), down (E, F, D)."""
    kw = dict(generator=gen, dtype=dtype, device=device)
    s = d_model ** -0.5
    p = {
        "router": dense_init(gen, d_model, n_experts, dtype=torch.float32,
                             device=device),
        "gate": torch.randn((n_experts, d_model, d_ff), **kw) * s,
        "up": torch.randn((n_experts, d_model, d_ff), **kw) * s,
        "down": torch.randn((n_experts, d_ff, d_model), **kw)
        * (d_ff ** -0.5),
    }
    if n_shared:
        p["shared"] = mlp_init(gen, d_model, d_ff * n_shared,
                               variant="swiglu", dtype=dtype, device=device)
    return p


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float = 1.25) -> int:
    c = int(n_tokens * top_k * capacity_factor / n_experts) + 1
    # rounded up to a multiple of 8, at least 8
    return max(8, -(-c // 8) * 8)


def _dense_w(w, dtype) -> torch.Tensor:
    return dequantize(w, dtype) if isinstance(w, QuantizedTensor) \
        else w.to(dtype)


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _moe_local(x, router_w, gate_w, up_w, down_w, *, top_k: int,
               n_experts: int, capacity_factor: float):
    """The reference's shard-local body with every expert local.
    x: (T, D); gate/up_w (E, D, F), down_w (E, F, D), dense or
    QuantizedTensor. Returns (y (T, D), aux loss)."""
    t, d = x.shape
    e = n_experts
    logits = torch.matmul(x.to(torch.float32),
                          router_w.to(torch.float32))       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, top_k)                      # (T, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)          # renormalize

    # capacity dispatch: queue position of each assignment, token-major
    cap = expert_capacity(t, e, top_k, capacity_factor)
    flat_e = top_e.reshape(-1)                               # (T*k,)
    flat_p = top_p.reshape(-1)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(top_k)
    onehot = F.one_hot(flat_e, e + 1)                        # (T*k, E+1)
    slot = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    keep = slot < cap
    e_idx = torch.where(keep, flat_e, e)                     # drop -> parked
    s_idx = torch.where(keep, slot, 0)

    # tokens gathered into (E, C, D); row E is the parked scratch row
    dispatch = torch.zeros((e + 1, cap), dtype=torch.long, device=x.device)
    dispatch[e_idx, s_idx] = flat_tok
    valid = torch.zeros((e + 1, cap), dtype=torch.bool, device=x.device)
    valid[e_idx, s_idx] = keep
    xg = x[dispatch[:e].reshape(-1)].reshape(e, cap, d)
    xg = torch.where(valid[:e, :, None], xg, torch.zeros_like(xg))

    # the experts (swiglu), on dequantized weights
    gw = _dense_w(gate_w, xg.dtype)
    uw = _dense_w(up_w, xg.dtype)
    dw = _dense_w(down_w, xg.dtype)
    h = F.silu(torch.bmm(xg, gw)) * torch.bmm(xg, uw)
    y_e = torch.bmm(h, dw)                                   # (E, C, D)

    # combine in the activation dtype: each token's kept assignments added
    # into zeros in ascending expert order, the order of the reference's
    # scatter-add over the (E, C) dispatch grid; deterministic on the card
    y_e = torch.cat([y_e, torch.zeros_like(y_e[:1])])        # parked row 0
    w = torch.where(keep, flat_p, torch.zeros_like(flat_p))
    contrib = (y_e[e_idx, s_idx] * w[:, None].to(y_e.dtype)).to(x.dtype)
    order = torch.argsort(top_e, dim=-1)                     # (T, k)
    contrib = torch.gather(contrib.reshape(t, top_k, d), 1,
                           order[:, :, None].expand(t, top_k, d))
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(top_k):
        y = y + contrib[:, j]

    # load-balance aux loss (Switch-style)
    me = F.one_hot(top_e[:, 0], e).to(torch.float32).mean(dim=0)
    ce = probs.mean(dim=0)
    aux = e * torch.sum(me * ce)
    return y, aux


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int, n_experts: int,
              capacity_factor: float = 1.25, rt: Runtime):
    """x: (B, S, D) -> (B, S, D). Returns (y, aux_loss)."""
    b, s, d = x.shape
    y, aux = _moe_local(x.reshape(b * s, d), p["router"]["w"], p["gate"],
                        p["up"], p["down"], top_k=top_k, n_experts=n_experts,
                        capacity_factor=capacity_factor)
    y = y.reshape(b, s, d)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, variant="swiglu", rt=rt)
    return y, aux
