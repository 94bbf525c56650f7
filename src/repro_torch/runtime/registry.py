"""Kernel registry: one dispatch table for every op.

Each op registers two impls:

  * ``"cuda"`` — the hand-written Hopper kernel (``kernels/csrc``), which
    takes CUDA tensors only;
  * ``"ref"``  — the plain PyTorch version, which runs on any device.

``resolve(op, impl, device)`` picks one. ``"auto"`` follows the device of
the op's tensors: a CUDA tensor launches the kernel, a CPU tensor takes the
plain version. ``impl="ref"`` on a CUDA tensor is legal, for comparing a
kernel with its plain version on the card. There is no fallback: a kernel
that fails to build or launch raises, and ``impl="cuda"`` on a CPU tensor
raises.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["KernelUnavailable", "register", "resolve", "registered_ops",
           "available_impls", "IMPLS"]

IMPLS = ("cuda", "ref")

_REGISTRY: dict[tuple[str, str], Callable] = {}


class KernelUnavailable(LookupError):
    pass


def register(op: str, impl: str):
    """Decorator: register ``fn`` as the ``impl`` implementation of
    ``op``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")

    def deco(fn):
        _REGISTRY[(op, impl)] = fn
        return fn
    return deco


def resolve(op: str, impl: str, device: torch.device) -> tuple[str, Callable]:
    """``(impl name, fn)`` for ``op`` on tensors that live on ``device``."""
    device = torch.device(device)
    if impl == "auto":
        impl = "cuda" if device.type == "cuda" else "ref"
    elif impl == "cuda" and device.type != "cuda":
        raise KernelUnavailable(
            f"op {op!r}: impl='cuda' needs CUDA tensors, got {device}")
    fn = _REGISTRY.get((op, impl))
    if fn is None:
        raise KernelUnavailable(
            f"no impl {impl!r} registered for op {op!r}; have "
            f"{sorted(i for (o, i) in _REGISTRY if o == op)}")
    return impl, fn


def available_impls(op: str, device) -> tuple[str, ...]:
    """The impls of ``op`` usable on tensors that live on ``device``,
    sorted: ``"ref"`` on any device, ``"cuda"`` on a CUDA device only.
    Empty for an op with none registered."""
    usable = ("cuda", "ref") if torch.device(device).type == "cuda" \
        else ("ref",)
    return tuple(sorted(i for (o, i) in _REGISTRY
                        if o == op and i in usable))


def registered_ops() -> tuple[str, ...]:
    return tuple(sorted({o for (o, _) in _REGISTRY}))
