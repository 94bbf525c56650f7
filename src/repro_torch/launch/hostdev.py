"""The device list an engine or a replica router spreads over.

By default it is every visible card (``torch.cuda.device_count()``), or
the one device the caller named when that is not a card (``"cpu"``).
``REPRO_FORCE_DEVICE_COUNT=N`` repeats the first device N times, so that
a ``shards=2`` engine runs on the one H100 (two shards on ``cuda:0``), and
on the CPU as ``["cpu", "cpu"]``: the counterpart of the reference's
forced host devices (``XLA_FLAGS=--xla_force_host_platform_device_count``).
The variable is read here and nowhere else, at each call; nothing is set
at import.
"""
from __future__ import annotations

import os

import torch

from repro_torch.runtime import resolve_device

__all__ = ["FORCE_ENV", "device_list"]

FORCE_ENV = "REPRO_FORCE_DEVICE_COUNT"


def device_list(device=None) -> list[torch.device]:
    """The devices a ``device`` runtime spreads over (``cuda`` unless the
    caller asks for another; raises without a card, as
    ``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [dev]
    forced = os.environ.get(FORCE_ENV, "")
    if forced:
        n = int(forced)
        if n < 1:
            raise ValueError(f"{FORCE_ENV} must be >= 1, got {n}")
        devs = [devs[0]] * n
    return devs
