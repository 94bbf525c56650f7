"""The serving mesh: the devices of one tensor-parallel engine.

The reference builds a ``(data=1, model=N)`` jax ``Mesh`` over an
explicit device slice (``repro.launch.mesh.make_serving_mesh``). Here the
engine runs its shards from one process, so the mesh is a small frozen
record of the shard devices in shard order and the axis sizes.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["ServingMesh", "make_serving_mesh"]


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    devices: tuple          # one torch.device per model shard, in order

    @property
    def shape(self) -> dict:
        return {"data": 1, "model": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_serving_mesh(model: int, devices) -> ServingMesh:
    """``(data=1, model)`` mesh over an explicit device slice (a replica
    router gives each engine its own); raises unless it holds exactly
    ``model`` devices."""
    devs = [torch.device(d) for d in devices]
    if len(devs) != model:
        raise ValueError(
            f"make_serving_mesh(model={model}) needs exactly {model} "
            f"devices, got {len(devs)}")
    return ServingMesh(tuple(devs))
