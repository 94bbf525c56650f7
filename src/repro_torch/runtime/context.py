"""The frozen execution context threaded through every layer.

  impl       kernel impl: auto | cuda | ref (``runtime.registry``)
  q_chunk    query chunk of the attention paths that have one
  kv_quant   quantized KV cache: uint8 codebook codes + one f32 scale
             per token, in the dense caches and the page pools
  kv_scheme  core/spx scheme of the quantized KV cache
  device     where params, caches and activations live. ``"cuda"`` by
             default; the CPU is taken only when asked for
  mesh       a ``launch.mesh.ServingMesh`` (the shard devices) when the
             serving engine runs tensor-parallel, a ``launch.mesh.HostMesh``
             (a data x model grid) under the serve steps of
             ``launch.steps``, else None
  decode_seq_axis  the mesh axis the dense self-attention caches'
             sequence is cut over (sequence-sharded decode), or None: the
             cut that ``ShardingPolicy.cache_specs`` gave the caches
  data_axes  the batch's axes (a tuple): empty where the batch does not
             divide the data axis and every data group runs all of it;
             ``("data", "model")`` under the train step's ``fsdp``, the
             rows over every device
  attn_cp    context-parallel prefill: every shard holds the whole
             weights; a sequence whose length divides the model axis runs
             with its queries sequence-sharded over it and K/V gathered,
             any other whole on the first shard
  remat      the train-mode stack's rematerialization (``nn.transformer``):
             ``none``; ``full`` checkpoints each period (and each slot of
             a pattern of more than one) and recomputes it in the
             backward; ``dots`` saves the matmul outputs in the period's
             recompute (the reference's ``dots_with_no_batch_dims``)
  live       the mesh devices (indices, a frozenset) whose work runs: the
             dry run's class path (``launch.dryrun``), one symmetric
             class's representative at a time, on ``meta`` only; None:
             every device
The mesh fields are read only under a ``HostMesh``; with ``mesh`` None
they change nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = ["Runtime", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when it would need a card and none is visible —
    an entry point never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Runtime:
    impl: str = "auto"
    q_chunk: int = 1024
    kv_quant: bool = False
    kv_scheme: str = "uniform8"
    device: str = "cuda"
    mesh: Any = None
    decode_seq_axis: Optional[str] = None
    data_axes: tuple = ("data",)
    attn_cp: bool = False
    remat: str = "none"
    live: Optional[frozenset] = None

    def __post_init__(self):
        if not isinstance(self.data_axes, tuple):
            object.__setattr__(self, "data_axes",
                               tuple(self.data_axes or ()))
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"remat {self.remat!r}: none, full or dots")

    def replace(self, **kw) -> "Runtime":
        return dataclasses.replace(self, **kw)
