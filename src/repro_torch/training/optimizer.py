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
import functools
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import spx
from repro_torch.nn.layers import tree_at, tree_leaves, tree_map

__all__ = ["Optimizer", "make_optimizer", "global_norm",
           "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]   # (params, grads, state) ->
                                               # (params, state)
    #: the update of a tree stored in blocks over devices (the train step's
    #: FSDP and tensor-parallel storage): (params, grads, states, where)
    #: -> (params, states), each a list of one tree per device, ``where(path,
    #: k)`` the slices of device k's block of the state leaf at ``path`` in
    #: the whole leaf and that leaf's shape; ``fold`` (the dry run's, on
    #: ``meta``) may run work that repeats once for all its repeats.
    #: Elementwise optimizers update each device's blocks alone
    update_blocks: Callable | None = None

    def __post_init__(self):
        if self.update_blocks is None:
            def each(params, grads, states, where, fold=None):
                out = [self.update(p, g, s)
                       for p, g, s in zip(params, grads, states)]
                return [o[0] for o in out], [o[1] for o in out]
            object.__setattr__(self, "update_blocks", each)


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

    def moments(p, g, mq, vq, m_scale, v_scale):
        """The new f32 moments of one leaf (or slice) from its 8-bit ones
        (each scale: the rows' (..., 1))."""
        g = g.to(torch.float32)
        m = b1 * spx.dequantize_codes(mq["codes"], lut(m_levels, p.device),
                                      m_scale) + (1 - b1) * g
        v = b2 * spx.dequantize_codes(vq["codes"], lut(v_levels, p.device),
                                      v_scale) + (1 - b2) * g * g
        return m, v

    def step_param(p, m, v, c1, c2):
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay:
            u = u + weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))

    def sliced(p) -> bool:
        return p.ndim >= 3 and p.shape[0] > 1 and p.numel() > _SLICE_ABOVE

    def take(x, i):
        if i is None:
            return x
        if isinstance(x, dict):
            return {key: t[i] for key, t in x.items()}
        return x[i]

    def update_leaf(path, ps, gs, qs, where, c1, c2, fold=None):
        """One leaf over its blocks ``ps`` (one per device)."""
        n, dev0 = len(ps), ps[0].device
        cpath = ("mu",) + path + ("codes",)
        # one block that is the whole leaf: its scale read and written
        # (one device; the dry run's class path may run one block of
        # several)
        alone = n == 1 and all(
            tuple(qs[name][0]["scale"].shape)
            == tuple(where((name,) + path + ("scale",), 0)[1])
            for name in ("mu", "nu"))
        # the scales joined whole: their own layout may cut the rows
        # otherwise than the codes
        old, new = {}, {}
        for name in ("mu", "nu"):
            if alone:
                old[name] = new[name] = qs[name][0]["scale"]
                continue
            spath = (name,) + path + ("scale",)
            whole = torch.empty(where(spath, 0)[1], dtype=torch.float32,
                                device=dev0)
            for k in range(n):
                whole[where(spath, k)[0]] = qs[name][k]["scale"].to(dev0)
            old[name] = whole
            new[name] = torch.zeros_like(whole)

        def parts(k):
            """(index into the block or None, the rows' slices in the
            whole scale) of each part of device k's block."""
            rows = where(cpath, k)[0][:-1]
            tail = (slice(None),)
            if not sliced(ps[k]):
                yield None, rows + tail
                return
            lo = rows[0].start or 0
            for i in range(ps[k].shape[0]):
                yield i, (lo + i,) + rows[1:] + tail

        def each_part(k, work):
            """``work(i, rows)`` over device k's parts; under ``fold`` the
            slices of a sliced block (one program on rows of one shape,
            no flops, no moves, nothing left live) run once for all."""
            todo = list(parts(k))
            if fold is None or len(todo) == 1:
                for i, rows in todo:
                    work(i, rows)
            else:
                fold(len(todo), lambda: work(*todo[0]))

        def moments_at(k, i, rows):
            dev = ps[k].device
            return moments(take(ps[k], i), take(gs[k], i),
                           take(qs["mu"][k], i), take(qs["nu"][k], i),
                           old["mu"][rows].to(dev), old["nu"][rows].to(dev))

        # where a block cuts the last dim, its rows' scales are the max
        # over every block of those rows (the all-reduce max), taken in a
        # first pass that recomputes the moments instead of holding them
        whole_rows = all(x.ndim == 0 or x.shape[-1] == where(cpath, k)[1][-1]
                         for k, x in enumerate(ps))
        def row_max(k, i, rows):
            for name, x in zip(("mu", "nu"), moments_at(k, i, rows)):
                amax = torch.amax(torch.abs(x), dim=-1,
                                  keepdim=True).to(dev0)
                new[name][rows] = torch.maximum(new[name][rows], amax)

        def step(k, i, rows):
            m, v = moments_at(k, i, rows)
            step_param(take(ps[k], i), m, v, c1, c2)
            for name, x, levels in (("mu", m, m_levels),
                                    ("nu", v, v_levels)):
                if whole_rows:
                    scale = torch.clamp(torch.amax(
                        torch.abs(x), dim=-1, keepdim=True), min=1e-20)
                    new[name][rows] = scale.to(dev0)
                else:
                    scale = new[name][rows].to(x.device)
                take(qs[name][k], i)["codes"].copy_(
                    spx.quantize_to_codes(x, levels, scale))

        if not whole_rows:
            for k in range(n):
                each_part(k, functools.partial(row_max, k))
            for name in ("mu", "nu"):
                new[name].clamp_(min=1e-20)
        for k in range(n):
            each_part(k, functools.partial(step, k))
        if alone:
            return
        for name in ("mu", "nu"):
            spath = (name,) + path + ("scale",)
            for k in range(n):
                qs[name][k]["scale"].copy_(new[name][where(spath, k)[0]])

    @torch.no_grad()
    def update_blocks(params, grads, states, where, fold=None):
        """Each scale is the max of |x| over the whole last dim of its
        row, so the codes and scales of blocks are the one-device update's;
        a large stacked block is taken a leading-axis slice at a time, so
        its f32 moments exist only per slice (the reference's
        ``lax.map``; ``fold``: the dry run's, ``update_leaf``)."""
        step = states[0]["step"] + 1
        c1, c2 = _bias_corrections(step, b1, b2)
        paths: list = []
        tree_map(lambda path, _: paths.append(path), params[0])
        for path in paths:
            update_leaf(path, [tree_at(t, path) for t in params],
                        [tree_at(t, path) for t in grads],
                        {name: [tree_at(st[name], path) for st in states]
                         for name in ("mu", "nu")}, where, c1, c2, fold)
        return params, [{"step": step, "mu": st["mu"], "nu": st["nu"]}
                        for st in states]

    def update(params, grads, state):
        """``update_blocks`` over one block: the whole tree."""
        def where(path, _):
            shape = tuple(tree_at(state, path).shape)
            return (slice(None),) * len(shape), shape
        (params,), (state,) = update_blocks([params], [grads], [state],
                                            where)
        return params, state

    return Optimizer("adamw_q8", init, update, update_blocks)


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name == "sgd":
        return _sgd(lr, kw.get("momentum", 0.0))
    if name == "adamw":
        return _adamw(lr, **kw)
    if name == "adamw_q8":
        return _adamw_q8(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
