"""Gradients of a loss over a param dict: the port's ``jax.value_and_grad``.

Training differentiates dense f32 params under autograd, as the reference
differentiates the same model under ``jax.grad``: the projections are
plain ``torch.matmul`` (``nn.layers.dense_apply``), and on the card the
attention runs the flash kernel inside ``FlashAttentionFn``
(``kernels/flash_attention.py``), whose backward recomputes the plain
version's gradients. No other kernel runs in training.
"""
from __future__ import annotations

import torch

from repro_torch.nn.layers import tree_leaves, tree_map

__all__ = ["value_and_grad"]


def value_and_grad(fn, params, *args, has_aux: bool = False, **kwargs):
    """``(fn(params, *args, **kwargs), d fn / d params)``: the loss
    detached, and a gradient tree with the structure of ``params``. With
    ``has_aux`` ``fn`` returns (loss, aux) and the value is (loss, aux),
    each detached. The params themselves are not marked to require
    gradients."""
    live = [leaf.detach().requires_grad_(True)
            for leaf in tree_leaves(params)]
    it = iter(live)
    with torch.enable_grad():
        out = fn(tree_map(lambda _, leaf: next(it), params), *args,
                 **kwargs)
        loss = out[0] if has_aux else out
        grads = iter(torch.autograd.grad(loss, live))
    grad_tree = tree_map(lambda _, leaf: next(grads), params)
    if has_aux:
        return (loss.detach(), tree_map(lambda _, a: a.detach(),
                                        out[1])), grad_tree
    return loss.detach(), grad_tree
