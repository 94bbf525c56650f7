"""Time a forward on the device it runs on, and read the card's power.

On a CUDA device a call is timed with CUDA events around a loop of calls
after a warm-up; on the CPU with the host clock, and every result says
which device it ran on (``device_label``). ``PowerSampler`` polls
``nvidia-smi`` while a timed loop runs, so that energy is time x the power
drawn during that loop.
"""
from __future__ import annotations

import subprocess
import threading
import time

import torch

__all__ = ["device_label", "time_per_call", "PowerSampler", "card_line"]

#: seconds between two ``power.draw`` readings
POLL_S = 0.05
#: untimed calls before a timed loop
WARMUP = 3


def device_label(device: torch.device) -> str:
    """The device a number was taken on: the card's name, or ``cpu``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def time_per_call(fn, device: torch.device, *, iters: int = 30,
                  min_seconds: float = 0.0) -> float:
    """Seconds per ``fn()`` call: at least ``iters`` calls and at least
    ``min_seconds`` of wall time after ``WARMUP`` calls, by CUDA events
    on a CUDA device and by the host clock on the CPU."""
    for _ in range(WARMUP):
        fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    n = 0
    while n < iters or time.perf_counter() - t0 < min_seconds:
        fn()
        n += 1
    if cuda:
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / n
    return (time.perf_counter() - t0) / n


def _smi(query: str, index: int) -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits",
         "-i", str(index)], capture_output=True, text=True, timeout=30)
    if out.returncode != 0:
        return []
    return [v.strip() for v in out.stdout.strip().split(",")]


def card_line(device: torch.device) -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` for the card, or None
    on the CPU or without ``nvidia-smi``."""
    if device.type != "cuda":
        return None
    try:
        vals = _smi("name,power.limit", device.index or 0)
    except (OSError, subprocess.SubprocessError):
        return None
    return f"{vals[0]}, {vals[1]} W" if len(vals) == 2 else None


class PowerSampler:
    """Polls the card's ``power.draw`` (W) from a thread while the ``with``
    block runs. ``watts()`` is the mean of the readings, or None when none
    was had (no card, no ``nvidia-smi``, a block too short for one
    reading); ``limit_watts()`` is the card's power limit, or None."""

    def __init__(self, device: torch.device):
        self.device = device
        self.readings: list[float] = []
        self._stop = threading.Event()
        self._thread = None

    def _read(self, field: str) -> float | None:
        try:
            vals = _smi(field, self.device.index or 0)
            return float(vals[0]) if vals else None
        except (OSError, subprocess.SubprocessError, ValueError):
            return None

    def _poll(self):
        while not self._stop.is_set():
            w = self._read("power.draw")
            if w is not None:
                self.readings.append(w)
            self._stop.wait(POLL_S)

    def __enter__(self):
        if self.device.type == "cuda":
            self._thread = threading.Thread(target=self._poll, daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
        return False

    def watts(self) -> float | None:
        return sum(self.readings) / len(self.readings) \
            if self.readings else None

    def limit_watts(self) -> float | None:
        if self.device.type != "cuda":
            return None
        return self._read("power.limit")
