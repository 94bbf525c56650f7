"""Optimizers on the port's param dicts: SGD (+momentum), the paper's
§4.1 training rule, AdamW, and AdamW-Q8 (AdamW with SPx-quantized 8-bit
moments), as ``repro.training.optimizer`` defines them.

API, as in the reference: ``opt = make_optimizer("adamw", lr=1e-3)``;
``state = opt.init(params)``; ``params, state = opt.update(params, grads,
state)``. Params are nested dicts (and lists) of tensors. The update runs
under ``torch.no_grad()`` and writes the params and the moments **in
place** (the reference returns new pytrees): a parameter keeps its
identity and its ``requires_grad``, so a training loop does not rebuild
its leaves each step. The arithmetic is the reference's: each leaf is
updated in f32 and cast back to its own dtype. The moments are trees of
the params' structure, as the reference's: f32 leaves, or for AdamW-Q8
{"codes" uint8, "scale" f32 per last-dim channel} dicts; ``step`` is a
Python int.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import spx
from repro_torch.nn.layers import tree_leaves, tree_map

__all__ = ["Optimizer", "make_optimizer", "global_norm",
           "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]   # (params, grads, state) ->
                                               # (params, state)


def _zeros_f32(params):
    """f32 zeros shaped like every param: a tree of the params'
    structure."""
    return tree_map(lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


def _per_leaf(params, states) -> list:
    """The subtree of ``states`` (a tree of the params' structure whose
    leaves may be dicts: gradients, moments) at every param leaf, in the
    params' ``tree_leaves`` order, whatever order ``states``'s dicts keep
    their keys in."""
    if isinstance(params, dict):
        return [s for k in params for s in _per_leaf(params[k], states[k])]
    if isinstance(params, (list, tuple)):
        return [s for p, st in zip(params, states)
                for s in _per_leaf(p, st)]
    return [states]


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
        ps, gs = tree_leaves(params), _per_leaf(params, grads)
        if momentum == 0.0:
            for p, g in zip(ps, gs):
                p.copy_((p.to(torch.float32) - lr * g.to(torch.float32))
                        .to(p.dtype))
            return params, {"step": state["step"] + 1}
        for p, g, m in zip(ps, gs, _per_leaf(params, state["mu"])):
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
        c1, c2 = _bias_corrections(step, b1, b2)
        for p, g, m, v in zip(tree_leaves(params),
                              _per_leaf(params, grads),
                              _per_leaf(params, state["mu"]),
                              _per_leaf(params, state["nu"])):
            g = g.to(torch.float32)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
        return params, {"step": step, "mu": state["mu"], "nu": state["nu"]}

    return Optimizer("adamw", init, update)


def _bias_corrections(step: int, b1: float, b2: float) -> tuple:
    """(1 - b1^t, 1 - b2^t) in f32, as the reference takes them."""
    t = np.float32(step)
    return (float(np.float32(1.0) - np.float32(b1) ** t),
            float(np.float32(1.0) - np.float32(b2) ** t))


# ---------------------------------------------------------------------------
# AdamW-Q8: SPx 8-bit quantized moments
# ---------------------------------------------------------------------------

_MOM_SCHEME = "sp2_8"        # signed, non-uniform: the gradients' shape
_VAR_SCHEME = "uniform8"     # nu >= 0: its non-negative half, on [0, max]

#: a stacked leaf (ndim >= 3, more than one slice) larger than this is
#: updated one leading-axis slice at a time, so its f32 moments exist only
#: per slice (the reference's ``lax.map``)
_SLICE_ABOVE = 2 ** 24


def _q8_state(p) -> dict:
    """uint8 codes of the leaf's shape and one f32 scale per last-dim
    channel (zero: the moments start at 0)."""
    shape = tuple(p.shape)
    scale_shape = shape[:-1] + (1,) if shape else (1,)
    return {"codes": torch.zeros(shape, dtype=torch.uint8, device=p.device),
            "scale": torch.zeros(scale_shape, dtype=torch.float32,
                                 device=p.device)}


def _q8_write(q: dict, x: torch.Tensor, levels: np.ndarray) -> None:
    """Quantize ``x`` into ``q`` in place: scale = max |x| over the last
    dim (at least 1e-20), codes the nearest levels."""
    scale = (torch.amax(torch.abs(x), dim=-1, keepdim=True) if x.ndim
             else torch.abs(x))
    scale = torch.clamp(scale, min=1e-20)
    q["codes"].copy_(spx.quantize_to_codes(x, levels, scale))
    q["scale"].copy_(scale)


def _adamw_q8(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
              weight_decay: float = 0.0) -> Optimizer:
    m_levels = spx.scheme_levels(_MOM_SCHEME)
    v_levels = np.asarray(spx.scheme_levels(_VAR_SCHEME))
    v_levels = v_levels[v_levels >= 0]
    v_levels = v_levels / v_levels.max()
    luts: dict = {}

    def lut(levels, device):
        key = (id(levels), str(device))
        if key not in luts:
            luts[key] = spx.codebook(levels, device=device)
        return luts[key]

    def init(params):
        return {"step": 0,
                "mu": tree_map(lambda _, p: _q8_state(p), params),
                "nu": tree_map(lambda _, p: _q8_state(p), params)}

    def upd_slice(p, g, mq, vq, c1, c2):
        g = g.to(torch.float32)
        m = b1 * spx.dequantize_codes(mq["codes"], lut(m_levels, p.device),
                                      mq["scale"]) + (1 - b1) * g
        v = b2 * spx.dequantize_codes(vq["codes"], lut(v_levels, p.device),
                                      vq["scale"]) + (1 - b2) * g * g
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay:
            u = u + weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
        _q8_write(mq, m, m_levels)
        _q8_write(vq, v, v_levels)

    @torch.no_grad()
    def update(params, grads, state):
        step = state["step"] + 1
        c1, c2 = _bias_corrections(step, b1, b2)
        for p, g, mq, vq in zip(tree_leaves(params),
                                _per_leaf(params, grads),
                                _per_leaf(params, state["mu"]),
                                _per_leaf(params, state["nu"])):
            if p.ndim >= 3 and p.shape[0] > 1 and p.numel() > _SLICE_ABOVE:
                for i in range(p.shape[0]):
                    upd_slice(p[i], g[i], {k: t[i] for k, t in mq.items()},
                              {k: t[i] for k, t in vq.items()}, c1, c2)
            else:
                upd_slice(p, g, mq, vq, c1, c2)
        return params, {"step": step, "mu": state["mu"], "nu": state["nu"]}

    return Optimizer("adamw_q8", init, update)


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name == "sgd":
        return _sgd(lr, kw.get("momentum", 0.0))
    if name == "adamw":
        return _adamw(lr, **kw)
    if name == "adamw_q8":
        return _adamw_q8(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
