"""Mixture-of-Experts (top-k, capacity-bounded), on one device or
expert-parallel over the shards of ``Runtime.mesh``.

The reference (``repro.nn.moe``) shards experts over a mesh's model axis
with ``shard_map``; ``moe_apply`` runs its body with every expert local
(the reference's ``model_axis=None`` path), ``moe_apply_sharded`` runs it
once per shard over that shard's experts (the reference's ``shard_map``
body, its ``psum`` a ``shard_sum``). Each expert takes at most
``C = expert_capacity(T, E, k, capacity_factor)`` of the T tokens it is
handed, E the global expert count; assignments are queued token-major
(token 0's k choices, then token 1's, ...) and an assignment past its
expert's capacity is dropped. Every row of the (B, S) input is a token
here, padding included, as in the reference: which tokens drop depends on
the whole batch.

Router ties: ``jax.lax.top_k`` takes the lower expert index first when two
probabilities are equal; a stable descending sort does the same here
(``torch.topk`` promises no order for ties on the card).

The experts run as the reference runs them, outside any kernel: each
stacked weight (E, D, F), a ``QuantizedTensor`` after ``quantize_params``,
is dequantized to the activation dtype and applied as a batched product,
a block of experts at a time where one weight's block would pass
``EXPERT_BLOCK_ELEMS`` elements (each expert's product is the same
either way).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import collectives
from repro_torch.core.quantized import QuantizedTensor, dequantize
from repro_torch.runtime import Runtime

from .layers import dense_init
from .mlp import mlp_apply, mlp_apply_sharded, mlp_init

__all__ = ["moe_init", "moe_apply", "moe_apply_sharded", "expert_capacity"]


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


#: the most elements of one expert weight (gate, up or down) that one
#: batched product dequantizes at once: a larger stack runs a block of
#: experts at a time, so that a full-width jamba MoE layer (16 experts of
#: 8192 x 24576, 38.6 GB in f32) never holds all of them in f32
EXPERT_BLOCK_ELEMS = 1 << 29


def _experts(xg, gate_w, up_w, down_w) -> torch.Tensor:
    """A block of swiglu experts on their dequantized weights: xg (E, C,
    D) -> (E, C, D)."""
    gw = _dense_w(gate_w, xg.dtype)
    uw = _dense_w(up_w, xg.dtype)
    dw = _dense_w(down_w, xg.dtype)
    h = F.silu(torch.bmm(xg, gw)) * torch.bmm(xg, uw)
    return torch.bmm(h, dw)


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _moe_local(x, router_w, gate_w, up_w, down_w, *, top_k: int,
               n_experts: int, capacity_factor: float, e0: int = 0):
    """The reference's shard-local body. x: (T, D), the same on every
    shard; gate/up_w (E_loc, D, F), down_w (E_loc, F, D), dense or
    QuantizedTensor: experts [e0, e0 + E_loc) of the ``n_experts`` (all
    of them at e0 = 0, E_loc = n_experts). The router and the capacity
    are global, so every shard routes and drops as one device does; an
    assignment to another shard's expert is parked. Returns (y (T, D),
    the partial sum of this shard's experts, and the aux loss)."""
    t, d = x.shape
    e = n_experts
    e_loc = gate_w.shape[0]
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
    local_e = flat_e - e0
    mine = (local_e >= 0) & (local_e < e_loc)
    local_e = torch.where(mine, local_e, e_loc)              # foreign: parked
    onehot = F.one_hot(local_e, e_loc + 1)                   # (T*k, E_loc+1)
    slot = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    keep = mine & (slot < cap)
    e_idx = torch.where(keep, local_e, e_loc)                # drop -> parked
    s_idx = torch.where(keep, slot, 0)

    # tokens gathered into (E_loc, C, D); row E_loc is the parked scratch
    dispatch = torch.zeros((e_loc + 1, cap), dtype=torch.long,
                           device=x.device)
    dispatch[e_idx, s_idx] = flat_tok
    valid = torch.zeros((e_loc + 1, cap), dtype=torch.bool, device=x.device)
    valid[e_idx, s_idx] = keep
    xg = x[dispatch[:e_loc].reshape(-1)].reshape(e_loc, cap, d)
    xg = torch.where(valid[:e_loc, :, None], xg, torch.zeros_like(xg))

    # the experts (swiglu), on dequantized weights, a block of experts at
    # a time where their f32 weights would be large
    per = max(1, EXPERT_BLOCK_ELEMS // (d * gate_w.shape[-1]))
    y_e = torch.cat([_experts(xg[lo:lo + per], gate_w[lo:lo + per],
                              up_w[lo:lo + per], down_w[lo:lo + per])
                     for lo in range(0, e_loc, per)]
                    or [xg])                                 # (E_loc, C, D)

    # combine in the activation dtype: each token's kept assignments added
    # into zeros in ascending expert order, the order of the reference's
    # scatter-add over the (E_loc, C) dispatch grid (a parked one adds an
    # exact zero); deterministic on the card
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


def moe_apply_sharded(ps: list, x: torch.Tensor, *, top_k: int,
                      n_experts: int, capacity_factor: float = 1.25,
                      rt: Runtime):
    """``moe_apply`` expert-parallel over the shards of ``rt.mesh``: shard
    s holds experts [s * E / n, (s + 1) * E / n) and the replicated
    router (``sharding.shard_params``), routes every token of x as one
    device does and runs its own experts; the partial outputs, in the
    activation dtype, are summed in shard order (where the reference
    ``psum``s; the dispatch and this combine are counted as
    ``all-to-all``, ``collectives``). A shared expert is a tensor-parallel
    MLP. x:
    (B, S, D) on the first shard's device. Returns (y, aux_loss) there;
    every shard routes the same tokens through the same router, so each
    computes the same aux loss and shard 0's is the group's (the
    reference's ``shard_map`` yields each data group's own; the train
    step combines the groups' as the reference does,
    ``models.lm.mesh_loss``)."""
    b, s, d = x.shape
    parts, aux, e0 = [], None, 0
    # the dispatch: every token to every expert shard
    collectives.note("all-to-all", rt.mesh.ids, collectives.nbytes(x))
    for p, dev in zip(ps, rt.mesh.devices):
        y, a = _moe_local(x.to(dev).reshape(b * s, d), p["router"]["w"],
                          p["gate"], p["up"], p["down"], top_k=top_k,
                          n_experts=n_experts,
                          capacity_factor=capacity_factor, e0=e0)
        parts.append(y)
        aux = a if aux is None else aux
        e0 += p["gate"].shape[0]
    y = collectives.all_reduce(parts, rt.mesh.ids,
                               "all-to-all").reshape(b, s, d)
    if "shared" in ps[0]:
        y = y + mlp_apply_sharded([p["shared"] for p in ps], x,
                                  variant="swiglu", rt=rt)
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
