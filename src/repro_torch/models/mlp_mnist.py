"""The paper's own model (§4.1): a 3-layer MLP, 784-128-10, sigmoid
activations, MSE loss against one-hot targets. The generic ``mlp_net`` is
also the Q-function approximator of the §4.2 RL experiment.

Inference runs through the dense path or the SPx-quantized path
(``quantize_params`` + ``kernels.ops.spx_matmul``): every layer goes
through ``nn.layers.dense_apply``, so a ``QuantizedTensor`` weight reaches
the hand-written kernel on the card. The bias add and the activations stay
plain tensor ops, as in the reference. ``paper_mlp_loss`` is a forward
pass only.
"""
from __future__ import annotations

import torch

from repro_torch.nn.layers import dense_apply, dense_init
from repro_torch.runtime import Runtime, resolve_device

__all__ = ["PAPER_LAYERS", "mlp_net_init", "mlp_net_apply", "paper_mlp_init",
           "paper_mlp_apply", "paper_mlp_loss", "paper_mlp_predict"]

PAPER_LAYERS = (784, 128, 10)


def mlp_net_init(gen: torch.Generator, sizes, *, dtype=torch.float32,
                 device=None) -> dict:
    """Layers ``l0 .. l{n-2}`` of ``sizes``, weights drawn from ``gen`` in
    layer order, zero biases, on ``device`` (``cuda`` unless the caller
    asks for another; ``gen`` must live there)."""
    device = resolve_device(device)
    return {f"l{i}": dense_init(gen, sizes[i], sizes[i + 1], bias=True,
                                dtype=dtype, device=device)
            for i in range(len(sizes) - 1)}


def mlp_net_apply(params: dict, x: torch.Tensor, *, act=torch.sigmoid,
                  final_act=None, rt: Runtime | None = None) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        x = dense_apply(params[f"l{i}"], x, rt)
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def paper_mlp_init(gen: torch.Generator, dtype=torch.float32,
                   device=None) -> dict:
    return mlp_net_init(gen, PAPER_LAYERS, dtype=dtype, device=device)


def paper_mlp_apply(params: dict, x: torch.Tensor,
                    rt: Runtime | None = None) -> torch.Tensor:
    """Eq. 4.2: F(x) = sigmoid(W3 sigmoid(W2 x + b2) + b3). x: (B, 784)."""
    return mlp_net_apply(params, x, act=torch.sigmoid,
                         final_act=torch.sigmoid, rt=rt)


def paper_mlp_loss(params: dict, x: torch.Tensor, y: torch.Tensor,
                   rt: Runtime | None = None) -> torch.Tensor:
    """Eq. 4.5: mean squared error against one-hot labels."""
    out = paper_mlp_apply(params, x, rt)
    onehot = torch.nn.functional.one_hot(y.long(), 10).to(out.dtype)
    return torch.mean(torch.sum((out - onehot) ** 2, dim=-1))


def paper_mlp_predict(params: dict, x: torch.Tensor,
                      rt: Runtime | None = None) -> torch.Tensor:
    """Eq. 4.3: argmax over the 10 output components."""
    return torch.argmax(paper_mlp_apply(params, x, rt), dim=-1)
