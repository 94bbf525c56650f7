"""The port's moves between mesh devices, counted under the reference's
collective names.

One process runs every device of a mesh, so what the reference's
partitioner turns into collectives is a ``.to(device)``, a ``cat`` or a
sum here. The helpers below do those moves and count each one, per mesh
device, under the name the reference's HLO gives it
(``repro.launch.dryrun.parse_collectives``): ``all-gather`` (the FSDP
gathers, the context-parallel K/V gather, joining head, row or vocabulary
slices), ``all-reduce`` (the row-parallel sums, the sum of copies, the
decode merge, the loss over devices), ``reduce-scatter`` (the backward of
an FSDP gather) and ``all-to-all`` (the expert-parallel MoE's dispatch
and combine).

A device is its index in the mesh (``launch.mesh.ServingMesh.ids``: row
``r``, shard ``m`` of a ``HostMesh`` is ``r * M + m``), never its
``torch.device``: on ``meta``, and on one card standing for several
devices, every device compares equal. A move is counted on every member
of its group (each runs it, as every device runs the reference's
collective), with the bytes of its result as one device holds it; a group
of one device moves nothing and counts nothing. ``reset_counts`` and
``counts`` read them, as ``kernels.ops.op_calls``.

The dry run's class path (``launch.dryrun``, on ``meta`` only) runs the
devices of one symmetric class at a time (``Runtime.live``): a move
whose group holds devices that do not run is counted on the members that
run (``live``), as large as its whole group makes it, and the parts of
the others are stand-ins of their shape (``stand_in``).
"""
from __future__ import annotations

import torch

__all__ = ["KINDS", "reset_counts", "counts", "repeat", "note", "nbytes",
           "all_gather", "all_reduce", "stand_in", "StandInOf", "Gather",
           "MetaJoin", "MetaRead"]

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")

#: {device index: {kind: [ops, bytes]}}
_COUNTS: dict = {}


def reset_counts() -> None:
    _COUNTS.clear()


def counts() -> dict:
    """{device index: {kind: {"ops": n, "bytes": b}}} since the last
    ``reset_counts``, devices that moved nothing left out."""
    return {dev: {kind: {"ops": ops, "bytes": b}
                  for kind, (ops, b) in kinds.items()}
            for dev, kinds in sorted(_COUNTS.items())}


def repeat(before: dict, times: int) -> None:
    """The moves counted since ``before`` (a ``counts()``) counted
    ``times`` times over: work the dry run runs once for ``times``
    identical repeats (``launch.dryrun``'s fold)."""
    for dev, kinds in counts().items():
        for kind, c in kinds.items():
            was = before.get(dev, {}).get(kind, {"ops": 0, "bytes": 0})
            n = _COUNTS[dev][kind]
            n[0] += (times - 1) * (c["ops"] - was["ops"])
            n[1] += (times - 1) * (c["bytes"] - was["bytes"])


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def note(kind: str, members, size: int, group: int | None = None,
         live=None) -> None:
    """Count one ``kind`` move of ``size`` result bytes on each of
    ``members`` (device indices), where its group (``group`` devices, by
    default the members) holds more than one device. ``live``: the
    devices that run (``Runtime.live``); None: every member."""
    members = tuple(members)
    if (len(set(members)) if group is None else group) < 2:
        return
    for dev in members:
        if live is not None and dev not in live:
            continue
        c = _COUNTS.setdefault(dev, {}).setdefault(kind, [0, 0])
        c[0] += 1
        c[1] += size


def all_gather(parts: list, dim: int, device, members,
               live=None) -> torch.Tensor:
    """``parts`` side by side on ``device`` along ``dim``, in order
    (``live``: ``note``'s)."""
    out = torch.cat([t.to(device) for t in parts], dim=dim)
    note("all-gather", members, nbytes(out), len(set(members)), live)
    return out


def all_reduce(parts: list, members, kind: str = "all-reduce",
               live=None) -> torch.Tensor:
    """``parts`` summed in order on the first part's device: the same sum
    on every run, whatever the devices. ``kind``: ``all-to-all`` for the
    expert-parallel MoE's combine (each shard's partial output over its
    experts), counted with its dispatch under that name. ``live``:
    ``note``'s; ``parts`` then holds the live members' parts only."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(total.device)
    note(kind, members, nbytes(total), len(set(members)), live)
    return total


def stand_in(like: torch.Tensor) -> torch.Tensor:
    """A ``meta`` tensor of ``like``'s shape and dtype: the part of a
    device that the class path does not run. Raises off ``meta``: a real
    run computes every part."""
    if like.device.type != "meta":
        raise ValueError("a stand-in part exists only on meta (the dry "
                         "run's class path)")
    return torch.empty(like.shape, dtype=like.dtype, device="meta")


class StandInOf(torch.autograd.Function):
    """On ``meta``: the output of work on ``x`` that another class of the
    dry run's class path runs (``stand_in``'s shape and dtype), keeping
    ``x`` for the backward as that work would, so that a checkpoint's
    recompute re-runs what made ``x`` as in the all-devices run; its
    backward hands ``x`` a stand-in gradient. ``apply(x)``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return stand_in(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return stand_in(x)


class Gather(torch.autograd.Function):
    """One device's FSDP gather (``sharding.GatheredLeaf``): its blocks
    side by side on its device, counted as an ``all-gather`` of the
    result; the backward hands each block its slice of the gradient (the
    sum over the devices that gathered it is autograd's), counted as a
    ``reduce-scatter`` of the device's own block. ``apply(dim, device,
    reader, own_bytes, *blocks)``."""

    @staticmethod
    def forward(ctx, dim, device, reader, own_bytes, *blocks):
        ctx.dim, ctx.reader, ctx.own = dim, reader, own_bytes
        ctx.sizes = [b.shape[dim] for b in blocks]
        ctx.devices = [b.device for b in blocks]
        out = torch.cat([b.to(device) for b in blocks], dim=dim)
        note("all-gather", (reader,), nbytes(out), len(blocks))
        return out

    @staticmethod
    def backward(ctx, grad):
        note("reduce-scatter", (ctx.reader,), ctx.own, len(ctx.sizes))
        parts = torch.split(grad, ctx.sizes, dim=ctx.dim)
        return (None, None, None, None,
                *(g.to(dev) for g, dev in zip(parts, ctx.devices)))


class MetaJoin(torch.autograd.Function):
    """On ``meta``: the blocks of one gather joined once for all the
    devices that read it (``sharding.GatheredLeaf``), with no storage of
    its own (an expanded scalar) and no count; each reader takes its copy
    through ``MetaRead``. Its backward splits the readers' summed
    gradient into the blocks' once. Where every tensor is meta the values
    do not exist, so only the moves' counts, the readers' copies and the
    ops' shapes matter: this keeps a gather over n devices at O(n) ops
    (``Gather`` per reader is O(n) ops each, and the backward's sums are
    per block and reader). ``apply(dim, *blocks)``."""

    @staticmethod
    def forward(ctx, dim, *blocks):
        ctx.dim = dim
        ctx.sizes = [b.shape[dim] for b in blocks]
        shape = list(blocks[0].shape)
        shape[dim] = sum(ctx.sizes)
        return blocks[0].new_empty(()).expand(shape)

    @staticmethod
    def backward(ctx, grad):
        return (None, *torch.split(grad, ctx.sizes, dim=ctx.dim))


class MetaRead(torch.autograd.Function):
    """One device's copy of a ``MetaJoin``: a new tensor of the gathered
    shape on its device, counted as ``Gather`` counts it (an
    ``all-gather`` of the result; in the backward a ``reduce-scatter`` of
    the device's own block). ``apply(joined, device, reader, own_bytes,
    group)``, ``group`` the blocks gathered."""

    @staticmethod
    def forward(ctx, joined, device, reader, own_bytes, group):
        ctx.reader, ctx.own, ctx.group = reader, own_bytes, group
        out = torch.empty(joined.shape, dtype=joined.dtype, device=device)
        note("all-gather", (reader,), nbytes(out), group)
        return out

    @staticmethod
    def backward(ctx, grad):
        note("reduce-scatter", (ctx.reader,), ctx.own, ctx.group)
        return grad, None, None, None, None
