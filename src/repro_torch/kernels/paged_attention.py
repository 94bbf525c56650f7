"""Wrappers of the hand-written paged-decode kernel
(``csrc/paged_decode.cu``), the Hopper counterpart of
``repro/kernels/paged_attention.py``, over f32 pools and over SPx-quantized
(uint8 codes + f32 per-token scale) pools.

``paged_decode_ragged_cuda`` and ``paged_decode_ragged_quant_cuda`` launch
the ragged decode-window kernel. ``paged_attention_cuda`` and
``paged_attention_quant_cuda`` (single-token decode over ``ctx_len``
positions) launch the same kernel with ``w = 1``,
``ctx = max(ctx_len - 1, 0)`` and ``q_len = (ctx_len > 0)``: row 0 then
attends positions ``< ctx_len`` and a row with ``ctx_len == 0`` comes back
zero, which is the single-token semantics exactly. Each wrapper keeps its
own launch count. None falls back to the plain version.
"""
from __future__ import annotations

import torch

from . import cuda_lib

__all__ = ["paged_decode_ragged_cuda", "paged_attention_cuda",
           "paged_decode_ragged_quant_cuda", "paged_attention_quant_cuda",
           "HEAD_DIMS", "SMEM_LIMIT"]

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


def _launch(q, k_pages, v_pages, block_table, ctx_len, q_len, w: int,
            quant=None):
    """``quant``: None for f32 pools, else (k_scale, v_scale, lut) with
    ``k_pages``/``v_pages`` the uint8 code pools."""
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
    pool_dtype = torch.float32 if quant is None else torch.uint8
    tensors = [("q", q, torch.float32), ("k_pages", k_pages, pool_dtype),
               ("v_pages", v_pages, pool_dtype),
               ("block_table", block_table, torch.int32),
               ("ctx_len", ctx_len, torch.int32),
               ("q_len", q_len, torch.int32)]
    if quant is not None:
        k_scale, v_scale, lut = quant
        scale_shape = (n_pages, hkv, ps, 1)
        if tuple(k_scale.shape) != scale_shape \
                or tuple(v_scale.shape) != scale_shape:
            raise ValueError(f"paged_decode: scales {tuple(k_scale.shape)}/"
                             f"{tuple(v_scale.shape)}, expected "
                             f"{scale_shape}")
        if lut.ndim != 1 or not 1 <= lut.numel() <= 256:
            raise ValueError(f"paged_decode: lut of {lut.numel()} entries, "
                             "the kernel takes 1 to 256")
        tensors += [("k_scale", k_scale, torch.float32),
                    ("v_scale", v_scale, torch.float32),
                    ("lut", lut, torch.float32)]
    for name, t, dt in tensors:
        _check(name, t, dt, device)
    lib = cuda_lib.library("paged_decode")
    smem = lib.paged_decode_smem_bytes(rows, dh, ps, int(quant is not None))
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged_decode: {rows} rows x head_dim {dh} with "
                         f"{ps}-token pages need {smem} bytes of shared "
                         f"memory, more than {SMEM_LIMIT}")
    out = torch.empty_like(q)
    tail = (out.data_ptr(), b, hkv, rows, dh, w, ps, block_table.shape[1],
            dh ** -0.5, torch.cuda.current_stream(device).cuda_stream)
    if quant is None:
        err = lib.paged_decode_ragged_f32(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), ctx_len.data_ptr(), q_len.data_ptr(),
            *tail)
    else:
        err = lib.paged_decode_ragged_quant_f32(
            q.data_ptr(), k_pages.data_ptr(), k_scale.data_ptr(),
            v_pages.data_ptr(), v_scale.data_ptr(), lut.data_ptr(),
            lut.numel(), block_table.data_ptr(), ctx_len.data_ptr(),
            q_len.data_ptr(), *tail)
    cuda_lib.check(lib, err, "paged_decode launch")
    return out


def _single_token(ctx_len):
    """The w = 1 mapping of single-token decode onto the ragged kernel."""
    ctx = torch.clamp(ctx_len - 1, min=0).to(torch.int32)
    return ctx, (ctx_len > 0).to(torch.int32)


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
    ctx, qn = _single_token(ctx_len)
    out = _launch(q, k_pages, v_pages, block_table, ctx, qn, 1)
    cuda_lib.LAUNCHES["paged_attention"] += 1
    return out


def paged_decode_ragged_quant_cuda(q, k_codes, k_scale, v_codes, v_scale,
                                   block_table, ctx_len, q_len, lut, *,
                                   w: int) -> torch.Tensor:
    """``paged_decode_ragged_cuda`` over quantized pools: k/v codes
    (n_pages, Hkv, page_size, dh) uint8, k/v scales (n_pages, Hkv,
    page_size, 1) f32, lut (<= 256,) f32 codebook."""
    out = _launch(q, k_codes, v_codes, block_table, ctx_len, q_len, w,
                  quant=(k_scale, v_scale, lut))
    cuda_lib.LAUNCHES["paged_decode_ragged_quant"] += 1
    return out


def paged_attention_quant_cuda(q, k_codes, k_scale, v_codes, v_scale,
                               block_table, ctx_len, lut) -> torch.Tensor:
    """``paged_attention_cuda`` over quantized pools (arguments as
    ``paged_decode_ragged_quant_cuda``)."""
    ctx, qn = _single_token(ctx_len)
    out = _launch(q, k_codes, v_codes, block_table, ctx, qn, 1,
                  quant=(k_scale, v_scale, lut))
    cuda_lib.LAUNCHES["paged_attention_quant"] += 1
    return out
