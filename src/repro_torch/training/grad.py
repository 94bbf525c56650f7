"""Gradients of a loss over a param dict: the port's ``jax.value_and_grad``.

Training differentiates dense f32 params through plain tensor ops
(``torch.matmul`` in ``nn.layers.dense_apply``) under autograd, as the
reference differentiates the same model through ``jnp.dot``; no kernel
runs a backward pass.
"""
from __future__ import annotations

import torch

from repro_torch.nn.layers import tree_leaves, tree_map

__all__ = ["value_and_grad"]


def value_and_grad(fn, params, *args, **kwargs):
    """``(fn(params, *args, **kwargs), d fn / d params)``: the loss
    detached, and a gradient tree with the structure of ``params``. The
    params themselves are not marked to require gradients."""
    live = [leaf.detach().requires_grad_(True)
            for leaf in tree_leaves(params)]
    it = iter(live)
    with torch.enable_grad():
        loss = fn(tree_map(lambda _, leaf: next(it), params), *args,
                  **kwargs)
        grads = iter(torch.autograd.grad(loss, live))
    return loss.detach(), tree_map(lambda _, leaf: next(grads), params)
