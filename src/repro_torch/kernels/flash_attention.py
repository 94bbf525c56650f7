"""Wrapper of the hand-written flash-attention kernel
(``csrc/flash_attention.cu``), the Hopper counterpart of
``repro/kernels/flash_attention.py``.

The kernel takes the GQA layout as it is: q (B, Hq, Sq, dh), k/v
(B, Hkv, Skv, dh); a block packs the rows of all ``rep`` query heads of
one KV head and loads each K/V tile once for them, so the wrapper repeats
nothing. Every Sq and Skv runs: the kernel masks the tail tiles. The
tile is ``planner.plan_attention``'s: 64 packed rows and 32 keys, or the
built tile ``REPRO_BLOCKS_ATTN`` pins. The wrapper checks what the kernel
takes, allocates the output, launches on the current stream, raises on a
launch error and counts the launch. It never falls back to the plain
version.

The kernel's output has no ``grad_fn``: it is written through ``ctypes``.
``FlashAttentionFn`` makes it differentiable for training: its forward is
the kernel, its backward recomputes the attention through the plain
version (``ref.flash_attention_ref``) under autograd and returns that
recompute's gradients. The TPU kernel is forward-only too, and the
reference differentiates the same chunked attention; no backward kernel
is owed.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.runtime import planner

from . import cuda_lib, ref

__all__ = ["flash_attention_cuda", "flash_attention_autograd",
           "FlashAttentionFn", "FUNCTION_CALLS", "HEAD_DIMS"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 80, 128, 256)

#: ``FlashAttentionFn`` calls: "forward" (each one forward launch of the
#: kernel on the card) and "backward" (each one plain recompute)
FUNCTION_CALLS: collections.Counter = collections.Counter()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, Sq, dh), k/v (B, Hkv, Skv, dh) f32, Hq % Hkv == 0; query
    row i at position ``q_offset + i`` under the causal mask. Returns
    (B, Hq, Sq, dh) f32."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_attention needs CUDA tensors, got {device}")
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, sq, dh = q.shape
    bk, hkv, skv, dhk = k.shape
    if bk != b or dhk != dh or hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} disagree")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh} not in "
                         f"{HEAD_DIMS}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, the "
                            "kernel takes torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    tile = planner.plan_attention(sq, skv, dh)
    lib = cuda_lib.library("flash_attention")
    out = torch.empty_like(q)
    err = lib.flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
        hq // hkv, sq, skv, dh, int(causal), int(q_offset), tile.bq,
        tile.bkv, dh ** -0.5, torch.cuda.current_stream(device).cuda_stream)
    cuda_lib.check(lib, err, "flash_attention launch")
    cuda_lib.LAUNCHES["flash_attention"] += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention: ``forward(q, k, v, causal=...)`` in
    the forward (the kernel on the card), the plain version's gradients in
    the backward. ``apply(q, k, v, causal, q_chunk, forward)``: q_chunk is
    the plain version's query chunk; ``forward`` any callable with the
    kernel's contract (the tests pass the plain version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_chunk: int, forward):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.q_chunk = causal, q_chunk
        FUNCTION_CALLS["forward"] += 1
        return forward(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        FUNCTION_CALLS["backward"] += 1
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ref.flash_attention_ref(*inputs, causal=ctx.causal,
                                          q_chunk=ctx.q_chunk)
            grads = torch.autograd.grad(out, inputs, grad_out)
        return (*grads, None, None, None)


def flash_attention_autograd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool, q_chunk: int,
                             forward=flash_attention_cuda) -> torch.Tensor:
    """``flash_attention_cuda`` (or ``forward``) with a backward: what the
    op runs on the card when an input requires grad."""
    return FlashAttentionFn.apply(q, k, v, causal, q_chunk, forward)
