"""Optimizers on the port's param dicts: SGD (+momentum), the paper's
§4.1 training rule, and AdamW, as ``repro.training.optimizer`` defines
them.

API, as in the reference: ``opt = make_optimizer("adamw", lr=1e-3)``;
``state = opt.init(params)``; ``params, state = opt.update(params, grads,
state)``. Params are nested dicts (and lists) of tensors. The update runs
under ``torch.no_grad()`` and writes the params and the moments **in
place** (the reference returns new pytrees): a parameter keeps its
identity and its ``requires_grad``, so a training loop does not rebuild
its leaves each step. The arithmetic is the reference's: each leaf is
updated in f32 and cast back to its own dtype; moments are f32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.nn.layers import tree_leaves, tree_map

__all__ = ["Optimizer", "make_optimizer", "global_norm",
           "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]   # (params, grads, state) ->
                                               # (params, state)


def _zeros_f32(params) -> list:
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in tree_leaves(params)]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """``grads`` scaled by ``min(1, max_norm / (norm + 1e-9))``, each leaf
    in its own dtype, and the norm before clipping."""
    gn = global_norm(grads)
    factor = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda _, g: (g.to(torch.float32) * factor).to(g.dtype),
                    grads), gn


# ---------------------------------------------------------------------------
# SGD (+momentum) — the paper's §4.1 training rule (eta=0.5, plain SGD)
# ---------------------------------------------------------------------------

def _sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {"step": 0}
        return {"step": 0, "mu": _zeros_f32(params)}

    @torch.no_grad()
    def update(params, grads, state):
        ps, gs = tree_leaves(params), tree_leaves(grads)
        if momentum == 0.0:
            for p, g in zip(ps, gs):
                p.copy_((p.to(torch.float32) - lr * g.to(torch.float32))
                        .to(p.dtype))
            return params, {"step": state["step"] + 1}
        for p, g, m in zip(ps, gs, state["mu"]):
            m.copy_(momentum * m + g.to(torch.float32))
            p.copy_((p.to(torch.float32) - lr * m).to(p.dtype))
        return params, {"step": state["step"] + 1, "mu": state["mu"]}

    return Optimizer("sgd", init, update)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"step": 0, "mu": _zeros_f32(params),
                "nu": _zeros_f32(params)}

    @torch.no_grad()
    def update(params, grads, state):
        step = state["step"] + 1
        # the bias corrections in f32, as the reference takes them
        t = np.float32(step)
        c1 = float(np.float32(1.0) - np.float32(b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(b2) ** t)
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              state["mu"], state["nu"]):
            g = g.to(torch.float32)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
        return params, {"step": step, "mu": state["mu"], "nu": state["nu"]}

    return Optimizer("adamw", init, update)


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name == "sgd":
        return _sgd(lr, kw.get("momentum", 0.0))
    if name == "adamw":
        return _adamw(lr, **kw)
    if name == "adamw_q8":
        raise NotImplementedError(
            "adamw_q8 is not ported to repro_torch yet (ROADMAP.md: "
            "Training the LM)")
    raise ValueError(f"unknown optimizer {name!r}")
