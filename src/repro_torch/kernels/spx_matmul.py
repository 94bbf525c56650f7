"""Wrapper of the hand-written SPx matmul kernel (``csrc/spx_matmul.cu``),
the Hopper counterpart of ``repro/kernels/spx_matmul.py``.

The wrapper checks what the kernel takes, allocates the output with
``torch.empty``, launches on the current stream, raises on a launch error
and counts the launch, per op and per kernel (``PATH_LAUNCHES``).
The launch is the caller's ``plan`` (a ``planner.SpxLaunchPlan``: the
tuner's), else the one ``REPRO_BLOCKS_MATMUL`` pins, else the analytical
one (``planner.spx_analytical_launch``): the small-layer kernel with its
tile and warps (N <= 128, K <= 1024: the paper's MLP and Q-network), else
decode (M <= 8) or prefill on the tensor cores (M > 8), which add their K
splits inside a thread-block cluster of the library's choosing. The
analytical launch is cached per (M, K, N, packed, LUT size, SMs); the pin
is read at every call. The library refuses a plan it cannot run. It never
falls back to another kernel or to the plain version.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.runtime import planner

from . import cuda_lib

__all__ = ["spx_matmul_cuda", "library_splits", "PATH_IDS"]

#: the C entry point's number of each path of ``planner.SpxLaunchPlan``
PATH_IDS = {"skinny": 0, "mma": 1, "small": 2}


#: the launch count's key of each path
_KERNELS = {path: f"spx_matmul_{path}" for path in PATH_IDS}


@functools.lru_cache(maxsize=None)
def library_splits(m: int, k: int, n: int, sms: int) -> int:
    """The cluster splits the library gives the decode (M <= 8) or prefill
    kernel at this shape; cached."""
    return cuda_lib.library("spx_matmul").spx_matmul_splits(m, k, n, sms)


@functools.lru_cache(maxsize=None)
def _plan(m: int, k: int, n: int, packed: bool, lut_size: int,
          sms: int) -> planner.SpxLaunchPlan:
    """The analytical launch with its splits explicit: the library's on
    the old kernels, 1 on the small path."""
    plan = planner.spx_analytical_launch(m, k, n, packed, lut_size, sms)
    return dataclasses.replace(plan, splits=1 if plan.path == "small"
                               else library_splits(m, k, n, sms))


def _check(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"spx_matmul: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"spx_matmul: {name} is {t.dtype}, the kernel "
                        f"takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"spx_matmul: {name} must be contiguous")


def spx_matmul_cuda(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                    lut: torch.Tensor, *, packed: bool,
                    plan: planner.SpxLaunchPlan | None = None) -> torch.Tensor:
    """x (M, K) f32 @ (lut[codes] * scale) -> (M, N) f32 on the card.
    codes: (K, N/2) uint8 when ``packed`` (low nibble = even column), else
    (K, N); scale: (1, N) or (N,) f32; lut: <= 256 f32 entries. ``plan``:
    the launch (when None the pinned one, else the analytical one; splits
    0 on the old kernels are the library's)."""
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"spx_matmul_cuda needs CUDA tensors, got {device}")
    if x.ndim != 2 or codes.ndim != 2:
        raise ValueError(f"spx_matmul: x {tuple(x.shape)} and codes "
                         f"{tuple(codes.shape)} must be 2-D")
    m, k = x.shape
    n = scale.numel()
    want = (k, n // 2) if packed else (k, n)
    if tuple(codes.shape) != want or (packed and n % 2):
        raise ValueError(f"spx_matmul: codes {tuple(codes.shape)} do not "
                         f"match x {tuple(x.shape)} and scale ({n},) "
                         f"(packed={packed})")
    if lut.numel() > 256:
        raise ValueError(f"spx_matmul: lut has {lut.numel()} > 256 entries")
    _check("x", x, torch.float32, device)
    _check("codes", codes, torch.uint8, device)
    _check("scale", scale, torch.float32, device)
    _check("lut", lut, torch.float32, device)
    lib = cuda_lib.library("spx_matmul")
    sms = cuda_lib.sm_count(device.index or 0)
    if plan is None:
        plan = (planner.pinned_spx_launch(m, k, n, bool(packed), lut.numel())
                or _plan(m, k, n, bool(packed), lut.numel(), sms))
    elif plan.path != "small" and not plan.splits:
        plan = dataclasses.replace(plan,
                                   splits=library_splits(m, k, n, sms))
    out = torch.empty((m, n), dtype=torch.float32, device=device)
    err = lib.spx_matmul_f32(
        x.data_ptr(), codes.data_ptr(), scale.data_ptr(), lut.data_ptr(),
        out.data_ptr(), m, k, n, int(packed), lut.numel(),
        PATH_IDS[plan.path], max(plan.splits, 1), plan.tile_m, plan.tile_n,
        plan.warps, torch.cuda.current_stream(device).cuda_stream)
    cuda_lib.check(lib, err, "spx_matmul launch")
    cuda_lib.LAUNCHES["spx_matmul"] += 1
    cuda_lib.PATH_LAUNCHES[_KERNELS[plan.path]] += 1
    return out
