"""Wrappers of the hand-written paged-decode kernel
(``csrc/paged_decode.cu``), the Hopper counterpart of
``repro/kernels/paged_attention.py``.

``paged_decode_ragged_cuda`` launches the ragged decode-window kernel.
``paged_attention_cuda`` (single-token decode over ``ctx_len`` positions)
launches the same kernel with ``w = 1``, ``ctx = max(ctx_len - 1, 0)`` and
``q_len = (ctx_len > 0)``: row 0 then attends positions ``< ctx_len`` and a
row with ``ctx_len == 0`` comes back zero, which is the single-token
semantics exactly. Each wrapper keeps its own launch count. Neither falls
back to the plain version.
"""
from __future__ import annotations

import torch

from . import cuda_lib

__all__ = ["paged_decode_ragged_cuda", "paged_attention_cuda", "HEAD_DIMS",
           "SMEM_LIMIT"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 128, 256)
#: shared memory one Hopper block may use (bytes)
SMEM_LIMIT = 232448


def _check(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"paged_decode: {name} on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"paged_decode: {name} is {t.dtype}, the kernel "
                        f"takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"paged_decode: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"paged_decode: {name} must be 16-byte aligned")


def _launch(q, k_pages, v_pages, block_table, ctx_len, q_len, w: int):
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"paged_decode needs CUDA tensors, got {device}")
    b, hkv, rows, dh = q.shape
    n_pages, hkv_p, ps, dh_p = k_pages.shape
    if (hkv_p, dh_p) != (hkv, dh) or tuple(v_pages.shape) != tuple(
            k_pages.shape):
        raise ValueError(f"paged_decode: q {tuple(q.shape)} and pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         "disagree")
    if dh not in HEAD_DIMS:
        raise ValueError(f"paged_decode: head_dim {dh} not in {HEAD_DIMS}")
    if w < 1 or rows % w:
        raise ValueError(f"paged_decode: {rows} rows is not rep * w, w={w}")
    if block_table.ndim != 2 or block_table.shape[0] != b \
            or tuple(ctx_len.shape) != (b,) or tuple(q_len.shape) != (b,):
        raise ValueError("paged_decode: block_table (B, max_pages), ctx_len "
                         "(B,) and q_len (B,) must match q's batch")
    for name, t, dt in (("q", q, torch.float32),
                        ("k_pages", k_pages, torch.float32),
                        ("v_pages", v_pages, torch.float32),
                        ("block_table", block_table, torch.int32),
                        ("ctx_len", ctx_len, torch.int32),
                        ("q_len", q_len, torch.int32)):
        _check(name, t, dt, device)
    lib = cuda_lib.library("paged_decode")
    smem = lib.paged_decode_smem_bytes(rows, dh, ps)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged_decode: {rows} rows x head_dim {dh} with "
                         f"{ps}-token pages need {smem} bytes of shared "
                         f"memory, more than {SMEM_LIMIT}")
    out = torch.empty_like(q)
    err = lib.paged_decode_ragged_f32(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), ctx_len.data_ptr(), q_len.data_ptr(),
        out.data_ptr(), b, hkv, rows, dh, w, ps, block_table.shape[1],
        dh ** -0.5, torch.cuda.current_stream(device).cuda_stream)
    cuda_lib.check(lib, err, "paged_decode launch")
    return out


def paged_decode_ragged_cuda(q, k_pages, v_pages, block_table, ctx_len,
                             q_len, *, w: int) -> torch.Tensor:
    """q (B, Hkv, rep * w, dh) rep-major rows; pools (n_pages, Hkv,
    page_size, dh) f32; block_table (B, max_pages), ctx_len (B,), q_len
    (B,) int32. Returns (B, Hkv, rep * w, dh)."""
    out = _launch(q, k_pages, v_pages, block_table, ctx_len, q_len, w)
    cuda_lib.LAUNCHES["paged_decode_ragged"] += 1
    return out


def paged_attention_cuda(q, k_pages, v_pages, block_table,
                         ctx_len) -> torch.Tensor:
    """q (B, Hkv, rep, dh); positions < ctx_len attended, ctx_len == 0
    gives zeros. Returns (B, Hkv, rep, dh)."""
    ctx = torch.clamp(ctx_len - 1, min=0).to(torch.int32)
    qn = (ctx_len > 0).to(torch.int32)
    out = _launch(q, k_pages, v_pages, block_table, ctx, qn, 1)
    cuda_lib.LAUNCHES["paged_attention"] += 1
    return out
