"""Feed-forward variants:
  * "mlp"     — plain up/act/down (whisper: gelu; paper MLP: sigmoid)
  * "swiglu"  — gated silu (granite, qwen2.5, kimi/olmoe/jamba experts)
  * "geglu"   — gated gelu (gemma)
  * "relu2"   — squared relu, ungated (minitron/nemotron)
All large projections may be SPx-quantized (QuantizedTensor weights).
``mlp_apply_sharded`` is the tensor-parallel FFN: column-parallel
up/gate, row-parallel down."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.runtime import Runtime

from .layers import dense_apply, dense_init, shard_sum

__all__ = ["mlp_init", "mlp_apply", "mlp_apply_sharded", "ACTIVATIONS"]

#: "gelu" is the tanh approximation, as jax.nn.gelu's default
ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}

_GATED = {"swiglu": "silu", "geglu": "gelu"}


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             variant: str = "swiglu", act: str = "gelu", bias: bool = False,
             dtype=torch.float32, device="cpu") -> dict:
    p = {"up": dense_init(gen, d_model, d_ff, bias=bias, dtype=dtype,
                          device=device),
         "down": dense_init(gen, d_ff, d_model, bias=bias, dtype=dtype,
                            device=device)}
    if variant in _GATED:
        p["gate"] = dense_init(gen, d_model, d_ff, bias=bias, dtype=dtype,
                               device=device)
    return p


def mlp_apply(p: dict, x: torch.Tensor, *, variant: str = "swiglu",
              act: str = "gelu", rt: Runtime | None = None) -> torch.Tensor:
    up = dense_apply(p["up"], x, rt)
    if variant in _GATED:
        g = dense_apply(p["gate"], x, rt)
        h = ACTIVATIONS[_GATED[variant]](g) * up
    else:
        h = ACTIVATIONS[act](up)
    return dense_apply(p["down"], h, rt)


def mlp_apply_sharded(ps: list, x: torch.Tensor, *, variant: str = "swiglu",
                      act: str = "gelu", rt: Runtime) -> torch.Tensor:
    """``mlp_apply`` split over the shards of ``rt.mesh`` by d_ff columns:
    shard s holds its columns of ``up`` (and ``gate``) and the matching
    rows of ``down``, so its output is a partial sum; the partials are
    summed in shard order on the first shard's device (``shard_sum``)."""
    return shard_sum([mlp_apply(p, x.to(dev), variant=variant, act=act,
                                rt=rt) for p, dev in zip(ps, rt.mesh.devices)],
                     rt.mesh)
