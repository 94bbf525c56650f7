"""Wrapper of the hand-written SPx matmul kernel (``csrc/spx_matmul.cu``),
the Hopper counterpart of ``repro/kernels/spx_matmul.py``.

The wrapper checks what the kernel takes, allocates the output with
``torch.empty``, launches on the current stream, raises on a launch error
and counts the launch. Both kernels (decode, M <= 8; prefill on the
tensor cores, M > 8) add their K splits inside a thread-block cluster;
the cluster size is cached per (M, K, N, SMs). It never falls back to the
plain version.
"""
from __future__ import annotations

import functools

import torch

from . import cuda_lib

__all__ = ["spx_matmul_cuda"]

@functools.lru_cache(maxsize=None)
def _splits(m: int, k: int, n: int, sms: int) -> int:
    return cuda_lib.library("spx_matmul").spx_matmul_splits(m, k, n, sms)


def _check(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"spx_matmul: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"spx_matmul: {name} is {t.dtype}, the kernel "
                        f"takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"spx_matmul: {name} must be contiguous")


def spx_matmul_cuda(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                    lut: torch.Tensor, *, packed: bool) -> torch.Tensor:
    """x (M, K) f32 @ (lut[codes] * scale) -> (M, N) f32 on the card.
    codes: (K, N/2) uint8 when ``packed`` (low nibble = even column), else
    (K, N); scale: (1, N) or (N,) f32; lut: <= 256 f32 entries."""
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
    splits = _splits(m, k, n, cuda_lib.sm_count(device.index or 0))
    out = torch.empty((m, n), dtype=torch.float32, device=device)
    err = lib.spx_matmul_f32(
        x.data_ptr(), codes.data_ptr(), scale.data_ptr(), lut.data_ptr(),
        out.data_ptr(), m, k, n, int(packed),
        lut.numel(), splits, torch.cuda.current_stream(device).cuda_stream)
    cuda_lib.check(lib, err, "spx_matmul launch")
    cuda_lib.LAUNCHES["spx_matmul"] += 1
    return out
