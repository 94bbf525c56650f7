"""Meshes: the devices of a tensor-parallel engine, and the (data, model)
grid of the serve steps.

The reference builds jax ``Mesh``es (``repro.launch.mesh``): a
``(data=1, model=N)`` mesh over an explicit device slice for a serving
engine (``make_serving_mesh``), and a ``data x model`` mesh over the
host's devices for the step builders (``make_host_mesh``). Here one
process runs every shard, so a mesh is a small frozen record of its
devices and axis sizes.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["ServingMesh", "HostMesh", "make_serving_mesh", "make_host_mesh"]


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    devices: tuple          # one torch.device per model shard, in order

    @property
    def shape(self) -> dict:
        return {"data": 1, "model": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """A ``data x model`` grid: ``grid[d][m]`` is the device of data group
    ``d``, model shard ``m``."""
    grid: tuple             # data rows, each a tuple of model devices

    @property
    def shape(self) -> dict:
        return {"data": len(self.grid), "model": len(self.grid[0])}

    @property
    def devices(self) -> tuple:
        """Every device, row-major."""
        return tuple(d for row in self.grid for d in row)

    def row(self, d: int) -> ServingMesh:
        """Data group ``d``'s model shards: the mesh its tensor-parallel
        forward runs on."""
        return ServingMesh(self.grid[d])


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


def make_host_mesh(data: int, model: int, devices) -> HostMesh:
    """``data x model`` mesh over the first ``data * model`` of ``devices``
    (``launch.hostdev.device_list()``), row-major; raises when there are
    fewer."""
    devs = [torch.device(d) for d in devices]
    if len(devs) < data * model:
        raise ValueError(
            f"make_host_mesh({data}, {model}) needs {data * model} devices, "
            f"got {len(devs)}")
    return HostMesh(tuple(tuple(devs[d * model:(d + 1) * model])
                          for d in range(data)))
