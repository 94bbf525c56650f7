"""Meshes: the devices of a tensor-parallel engine, and the (pod, data,
model) grid of the serve and train steps.

The reference builds jax ``Mesh``es (``repro.launch.mesh``): a
``(data=1, model=N)`` mesh over an explicit device slice for a serving
engine (``make_serving_mesh``), a ``data x model`` mesh over the host's
devices for the step builders (``make_host_mesh``), and the production
meshes, 16 x 16 ``(data, model)`` and 2 x 16 x 16 ``(pod, data, model)``
(``make_production_mesh``). Here one process runs every shard, so a mesh
is a small frozen record of its devices and axis sizes; the production
meshes lie on ``meta`` (the dry run, ``launch.dryrun``).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["ServingMesh", "HostMesh", "make_serving_mesh", "make_host_mesh",
           "make_production_mesh"]


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    devices: tuple          # one torch.device per model shard, in order
    #: the mesh index of shard 0 (a ``HostMesh`` row's first device):
    #: shard m is device ``first + m`` of the mesh, what the collective
    #: counters (``repro_torch.collectives``) count by
    first: int = 0

    @property
    def shape(self) -> dict:
        return {"data": 1, "model": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def ids(self) -> tuple:
        """Each shard's index in the mesh."""
        return tuple(range(self.first, self.first + len(self.devices)))

    def part(self, shards: slice) -> "ServingMesh":
        """The mesh of a run of its shards (``shards``, a slice of
        consecutive shards), keeping their mesh indices."""
        return ServingMesh(self.devices[shards], self.ids[shards][0])


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """A ``(pod,) data x model`` grid: ``grid[r][m]`` is the device of row
    ``r``, model shard ``m``. The rows are the data groups, pod-major when
    the mesh has a ``pod`` axis (``pods`` > 0): row ``r`` is pod ``r //
    shape["data"]``, data group ``r % shape["data"]``. ``shape`` names the
    pod axis only when it is there."""
    grid: tuple             # rows, each a tuple of model devices
    pods: int = 0           # the pod axis' size; 0: no pod axis

    @property
    def shape(self) -> dict:
        m = len(self.grid[0])
        if not self.pods:
            return {"data": len(self.grid), "model": m}
        return {"pod": self.pods, "data": len(self.grid) // self.pods,
                "model": m}

    @property
    def devices(self) -> tuple:
        """Every device, row-major."""
        return tuple(d for row in self.grid for d in row)

    def row(self, d: int) -> ServingMesh:
        """Row ``d``'s model shards: the mesh its tensor-parallel forward
        runs on."""
        return ServingMesh(self.grid[d], d * len(self.grid[d]))

    def coords(self, r: int) -> dict:
        """Row ``r``'s coordinate on each axis but ``model``."""
        n_data = self.shape["data"]
        return {"pod": r // n_data, "data": r % n_data}


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


def make_host_mesh(data: int, model: int, devices, *,
                   pod: int | None = None) -> HostMesh:
    """``(pod x) data x model`` mesh over the first ``pod * data * model``
    of ``devices`` (``launch.hostdev.device_list()``), row-major; raises
    when there are fewer. ``pod`` None: no pod axis."""
    rows = data * (pod or 1)
    devs = [torch.device(d) for d in devices]
    if len(devs) < rows * model:
        raise ValueError(
            f"make_host_mesh({data}, {model}, pod={pod}) needs "
            f"{rows * model} devices, got {len(devs)}")
    return HostMesh(tuple(tuple(devs[r * model:(r + 1) * model])
                          for r in range(rows)), pod or 0)


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> HostMesh:
    """The reference's production meshes over ``device`` (each of the 256
    or 512 mesh devices is that one device): 16 x 16 ``(data, model)``,
    or 2 x 16 x 16 ``(pod, data, model)`` with ``multi_pod``."""
    return make_host_mesh(16, 16, [device] * (512 if multi_pod else 256),
                          pod=2 if multi_pod else None)
