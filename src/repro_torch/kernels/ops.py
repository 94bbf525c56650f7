"""Public quantized-matmul and attention ops, dispatched through
``runtime.registry``: a CUDA tensor launches the hand-written kernel, a CPU
tensor takes the plain PyTorch version (``kernels/ref.py``).

Shapes and layouts are those of ``repro.kernels.ops``. Eager PyTorch has
no trace, so ``op_calls()`` counts kernel **launches** (not call sites, as
in the JAX package); ``ref_calls()`` counts calls of the plain versions.

Under ``REPRO_AUTOTUNE=1`` ``spx_matmul`` and the paged ops take their
launch from ``autotune`` on CUDA tensors (measured once per shape key);
the tuner's timed launches count as launches. On CPU tensors no knob is
read.
"""
from __future__ import annotations

import collections
import functools

import torch

from repro_torch.core import spx
from repro_torch.core.quantized import QuantizedTensor
from repro_torch.runtime import planner, registry

from . import autotune, cuda_lib, ref
from .flash_attention import flash_attention_autograd, flash_attention_cuda
from .paged_attention import (paged_attention_cuda,
                              paged_attention_quant_cuda,
                              paged_decode_ragged_cuda,
                              paged_decode_ragged_quant_cuda)
from .spx_matmul import spx_matmul_cuda

__all__ = ["spx_matmul", "flash_attention", "paged_attention",
           "paged_attention_quant", "paged_decode_ragged", "op_calls",
           "path_calls", "ref_calls", "reset_op_calls"]

_REF_CALLS: collections.Counter = collections.Counter()


def op_calls() -> dict[str, int]:
    """Kernel launches per op since the last ``reset_op_calls()``."""
    return dict(cuda_lib.LAUNCHES)


def ref_calls() -> dict[str, int]:
    """Plain-version calls per op since the last ``reset_op_calls()``."""
    return dict(_REF_CALLS)


def path_calls() -> dict[str, int]:
    """Kernel launches per kernel of an op with several (``spx_matmul``'s
    ``spx_matmul_skinny``, ``spx_matmul_mma``, ``spx_matmul_small``) since
    the last ``reset_op_calls()``."""
    return dict(cuda_lib.PATH_LAUNCHES)


def reset_op_calls() -> None:
    cuda_lib.LAUNCHES.clear()
    cuda_lib.PATH_LAUNCHES.clear()
    _REF_CALLS.clear()


@functools.lru_cache(maxsize=None)
def _lut(scheme: str, device: str) -> torch.Tensor:
    return spx.codebook(spx.scheme_levels(scheme), device=device)


# -- spx_matmul ---------------------------------------------------------------

@registry.register("spx_matmul", "ref")
def _spx_matmul_ref(x2, codes, scale, lut, *, packed):
    _REF_CALLS["spx_matmul"] += 1
    return ref.spx_matmul_ref(x2, codes, scale, lut, packed=packed)


registry.register("spx_matmul", "cuda")(spx_matmul_cuda)


def spx_matmul(x: torch.Tensor, qt: QuantizedTensor, *,
               impl: str = "auto") -> torch.Tensor:
    """x: (..., K) @ dequant(qt: (K, N)) -> (..., N)."""
    k_dim, n_dim = qt.logical_shape
    name, fn = registry.resolve("spx_matmul", impl, x.device)
    scale = qt.scale.reshape(1, n_dim).to(torch.float32)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k_dim).contiguous()
    lut = _lut(qt.scheme, str(x.device))
    if name == "cuda" and planner.autotune_enabled():
        out = fn(x2, qt.codes, scale, lut, packed=qt.packed,
                 plan=autotune.spx_plan(fn, x2, qt.codes, scale, lut,
                                        packed=qt.packed))
    else:
        out = fn(x2, qt.codes, scale, lut, packed=qt.packed)
    return out.reshape(*lead, n_dim)


def _paged_plan(name: str, fn, args: tuple, kw: dict, pool, block_table,
                *, w: int, kv_scheme) -> dict:
    """A paged op's keywords: ``kw``, and the tuner's ``plan`` under
    autotune on the card (``fn`` the kernel's wrapper, ``args`` its
    arguments, q first; ``pool`` the K pool or its codes)."""
    if name != "cuda" or not planner.autotune_enabled():
        return kw
    q4 = args[0]
    return {**kw, "plan": autotune.paged_plan(
        lambda plan: fn(*args, plan=plan, **kw), q4, pool, block_table,
        rep=q4.shape[2] // w, w=w, kv_scheme=kv_scheme)}


# -- flash_attention: the dense prefill ---------------------------------------

@registry.register("flash_attention", "ref")
def _flash_attention_ref(q, k, v, *, causal, q_chunk, q_offset=0):
    """The plain version; where autograd records, each query chunk
    checkpointed as the reference's (``ref.flash_attention_ref``'s
    ``remat``)."""
    _REF_CALLS["flash_attention"] += 1
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    return ref.flash_attention_ref(q, k, v, causal=causal, q_chunk=q_chunk,
                                   q_offset=q_offset, remat=remat)


@registry.register("flash_attention", "cuda")
def _flash_attention_cuda(q, k, v, *, causal, q_chunk, q_offset=0):
    """The kernel; inside ``FlashAttentionFn`` when autograd records (an
    input requires grad), so training differentiates it. ``q_chunk`` is
    the plain recompute's in the backward: the kernel tiles queries
    itself."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q_offset:
            raise NotImplementedError(
                "flash_attention: no gradient with a query offset")
        return flash_attention_autograd(q, k, v, causal=causal,
                                        q_chunk=q_chunk)
    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 1024,
                    impl: str = "auto", q_offset: int = 0) -> torch.Tensor:
    """GQA attention. q: (B, Hq, Sq, dh); k, v: (B, Hkv, Skv, dh);
    Hq % Hkv == 0. Returns (B, Hq, Sq, dh). Every length runs through the
    kernel on the card; ``q_chunk`` is the plain version's query chunk.
    ``q_offset``: query row i sits at position ``q_offset + i`` under the
    causal mask (a context-parallel shard's rows)."""
    hq, hkv = q.shape[1], k.shape[1]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} KV heads")
    _, fn = registry.resolve("flash_attention", impl, q.device)
    return fn(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
              q_chunk=q_chunk, q_offset=int(q_offset))


# -- paged_attention: single-token decode over the paged KV cache -------------

@registry.register("paged_attention", "ref")
def _paged_attention_ref(q4, k_pages, v_pages, block_table, ctx_len):
    _REF_CALLS["paged_attention"] += 1
    return ref.paged_attention_ref(q4, k_pages, v_pages, block_table, ctx_len)


registry.register("paged_attention", "cuda")(paged_attention_cuda)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    ctx_len: torch.Tensor, *, impl: str = "auto"):
    """Decode attention of one query token per sequence against its paged
    KV context. q: (B, Hq, dh); pools (n_pages, Hkv, page_size, dh);
    block_table (B, max_pages); ctx_len (B,) — positions < ctx_len are
    attended, 0 = inactive row (zeros). Returns (B, Hq, dh)."""
    b, hq, dh = q.shape
    hkv = k_pages.shape[1]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} KV heads")
    name, fn = registry.resolve("paged_attention", impl, q.device)
    q4 = q.reshape(b, hkv, hq // hkv, dh).contiguous()
    args = (q4, k_pages, v_pages, block_table.to(torch.int32),
            ctx_len.to(torch.int32))
    out = fn(*args, **_paged_plan(name, fn, args, {}, k_pages, args[3],
                                  w=1, kv_scheme=None))
    return out.reshape(b, hq, dh)


# -- paged_attention_quant: single-token decode over code + scale pools -------

@registry.register("paged_attention_quant", "ref")
def _paged_attention_quant_ref(q4, k_codes, k_scale, v_codes, v_scale,
                               block_table, ctx_len, lut):
    _REF_CALLS["paged_attention_quant"] += 1
    return ref.paged_attention_quant_ref(q4, k_codes, k_scale, v_codes,
                                         v_scale, block_table, ctx_len, lut)


registry.register("paged_attention_quant", "cuda")(paged_attention_quant_cuda)


def paged_attention_quant(q: torch.Tensor, k_pages: dict, v_pages: dict,
                          block_table: torch.Tensor, ctx_len: torch.Tensor,
                          *, kv_scheme: str = "uniform8",
                          impl: str = "auto") -> torch.Tensor:
    """``paged_attention`` over quantized pools with the codebook
    dequantization inside the kernel. k_pages/v_pages: {"codes":
    (n_pages, Hkv, page_size, dh) uint8, "scale": (n_pages, Hkv,
    page_size, 1) f32}; ``kv_scheme`` names the codebook. Returns
    (B, Hq, dh)."""
    b, hq, dh = q.shape
    hkv = k_pages["codes"].shape[1]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} KV heads")
    name, fn = registry.resolve("paged_attention_quant", impl, q.device)
    q4 = q.reshape(b, hkv, hq // hkv, dh).contiguous()
    bt = block_table.to(torch.int32)
    args = (q4, k_pages["codes"], k_pages["scale"], v_pages["codes"],
            v_pages["scale"], bt, ctx_len.to(torch.int32),
            _lut(kv_scheme, str(q.device)))
    out = fn(*args, **_paged_plan(name, fn, args, {}, k_pages["codes"], bt,
                                  w=1, kv_scheme=kv_scheme))
    return out.reshape(b, hq, dh)


# -- paged_decode_ragged: one launch per layer per decode tick ----------------

@registry.register("paged_decode_ragged", "ref")
def _paged_decode_ragged_ref(q4, k_pages, v_pages, block_table, ctx_len,
                             q_len, *, w):
    _REF_CALLS["paged_decode_ragged"] += 1
    return ref.paged_decode_ragged_ref(q4, k_pages, v_pages, block_table,
                                       ctx_len, q_len, w=w)


registry.register("paged_decode_ragged", "cuda")(paged_decode_ragged_cuda)


@registry.register("paged_decode_ragged_quant", "ref")
def _paged_decode_ragged_quant_ref(q4, k_codes, k_scale, v_codes, v_scale,
                                   block_table, ctx_len, q_len, lut, *, w):
    _REF_CALLS["paged_decode_ragged_quant"] += 1
    return ref.paged_decode_ragged_quant_ref(
        q4, k_codes, k_scale, v_codes, v_scale, block_table, ctx_len, q_len,
        lut, w=w)


registry.register("paged_decode_ragged_quant", "cuda")(
    paged_decode_ragged_quant_cuda)


def paged_decode_ragged(q: torch.Tensor, k_pages, v_pages,
                        block_table: torch.Tensor, ctx_len: torch.Tensor,
                        q_len: torch.Tensor, *, kv_scheme: str | None = None,
                        impl: str = "auto") -> torch.Tensor:
    """Ragged decode-window attention, one launch for the whole batch.

    q: (B, W, Hq, dh) — W window positions per slot; q_len: (B,) valid
    window rows per slot (rows at positions >= q_len return exact zeros);
    ctx_len: (B,) tokens already in the pages before the window (window
    position i attends positions <= ctx_len + i). Pools: the dense
    (n_pages, Hkv, page_size, dh) arrays, or the quantized {"codes",
    "scale"} dicts of ``nn.attention.paged_kv_write``, which route to the
    quantized kernel and need ``kv_scheme`` for its codebook. Returns
    (B, W, Hq, dh)."""
    quant = isinstance(k_pages, dict)
    b, w, hq, dh = q.shape
    hkv = (k_pages["codes"] if quant else k_pages).shape[1]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} KV heads")
    rep = hq // hkv
    # (B, W, Hq, dh) -> (B, Hkv, rep * w, dh), rep-major: row r * w + i is
    # window position i of query head r under this KV head
    q4 = q.reshape(b, w, hkv, rep, dh).permute(0, 2, 3, 1, 4) \
          .reshape(b, hkv, rep * w, dh).contiguous()
    tables = (block_table.to(torch.int32), ctx_len.to(torch.int32),
              q_len.to(torch.int32))
    if quant:
        if kv_scheme is None:
            raise ValueError("quantized KV pools need kv_scheme for the "
                             "in-kernel codebook")
        name, fn = registry.resolve("paged_decode_ragged_quant", impl,
                                    q.device)
        pool = k_pages["codes"]
        args = (q4, pool, k_pages["scale"], v_pages["codes"],
                v_pages["scale"], *tables, _lut(kv_scheme, str(q.device)))
    else:
        name, fn = registry.resolve("paged_decode_ragged", impl, q.device)
        pool, kv_scheme = k_pages, None
        args = (q4, k_pages, v_pages, *tables)
    out = fn(*args, **_paged_plan(name, fn, args, {"w": w}, pool, tables[0],
                                  w=w, kv_scheme=kv_scheme))
    # inverse of the rep-major packing
    return out.reshape(b, hkv, rep, w, dh).permute(0, 3, 1, 2, 4) \
              .reshape(b, w, hq, dh)
