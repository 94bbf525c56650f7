"""Functional module substrate: params are plain dicts of tensors and/or
QuantizedTensors; every module is an init fn plus an apply fn.

Any 2-D+ weight may be a ``QuantizedTensor`` (the paper's SPx codes) in
place of a dense tensor; ``dense_apply`` then routes through the quantized
matmul op (``repro_torch.kernels.ops.spx_matmul``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import collectives
from repro_torch.core.quantized import QuantizedTensor, quantize_weight
from repro_torch.kernels import ops
from repro_torch.runtime import Runtime

__all__ = ["dense_init", "dense_apply", "embedding_init", "embedding_apply",
           "rmsnorm_init", "rmsnorm_apply", "layernorm_init",
           "layernorm_apply", "norm_init", "norm_apply", "quantize_params",
           "tree_map", "tree_at", "tree_index", "shard_sum",
           "sharded_embedding_apply", "sharded_logits"]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.float32, device="cpu",
               scale: float | None = None) -> dict:
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                          device=device) * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense_apply(p: dict, x: torch.Tensor,
                rt: Runtime | None = None) -> torch.Tensor:
    w = p["w"]
    if isinstance(w, QuantizedTensor):
        y = ops.spx_matmul(x, w, impl=rt.impl if rt else "auto")
    else:
        y = torch.matmul(x, w.to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def embedding_init(gen: torch.Generator, vocab: int, d_model: int, *,
                   dtype=torch.float32, device="cpu") -> dict:
    return {"table": torch.randn((vocab, d_model), generator=gen, dtype=dtype,
                                 device=device) * (d_model ** -0.5)}


def embedding_apply(p: dict, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids.long()]


# -- tensor parallelism: the ordered reduction, the lookup and the head ------

def shard_sum(parts: list, mesh) -> torch.Tensor:
    """The shards' partial products (of a row-parallel ``wo`` or ``down``,
    of the vocab-parallel lookup or of a d-cut head) summed in fixed shard
    order on the first shard's device: the same sum on every run,
    whatever the devices (an all-reduce over the shards of ``mesh``, a
    ``launch.mesh.ServingMesh``, counted by ``collectives``). The caller
    hands the result on to each shard."""
    return collectives.all_reduce(parts, mesh.ids)


def sharded_embedding_apply(ps: list, ids: torch.Tensor, mesh,
                            vocab: int) -> torch.Tensor:
    """The lookup over the shards' slices of a (``vocab``, D) table, each
    id's row exact. Vocab-parallel (the rows split): shard s holds rows
    [lo_s, lo_s + V_s) and gathers the ids in its range (exact zeros
    elsewhere), the rows summed in shard order on the first shard's
    device. d-cut (a vocabulary that does not split: every shard holds
    all rows, its slice of the columns): each shard gathers its columns,
    put side by side in shard order there (an all-gather). ``ps[s]`` is
    on shard s of ``mesh``."""
    dev0 = mesh.devices[0]
    if ps[0]["table"].shape[0] == vocab:
        parts = [embedding_apply(p, ids.to(dev)).to(dev0)
                 for p, dev in zip(ps, mesh.devices)]
        return collectives.all_gather(parts, -1, dev0, mesh.ids)
    parts, lo = [], 0
    for p, dev in zip(ps, mesh.devices):
        table = p["table"]
        v = table.shape[0]
        local = ids.to(dev).long() - lo
        hit = (local >= 0) & (local < v)
        rows = table[torch.clamp(local, 0, v - 1)]
        parts.append(torch.where(hit[..., None], rows,
                                 torch.zeros((), dtype=rows.dtype,
                                             device=dev)))
        lo += v
    return shard_sum(parts, mesh)


def sharded_logits(ws: list, h: torch.Tensor, mesh) -> torch.Tensor:
    """Vocabulary logits of h (..., D) over the shards' slices ``ws`` of
    the (D, V) head (the tied table's transpose or the untied head), plain
    products outside any kernel. Column slices (the vocabulary splits):
    each shard's logits over its vocabulary, joined in shard order on the
    first shard's device. Row slices (it does not: the head is cut on d):
    each shard multiplies its columns of h, and the partial logits are
    summed in shard order (``shard_sum``). ``ws[s]`` is on shard s of
    ``mesh``."""
    dev0 = mesh.devices[0]
    if ws[0].shape[0] == h.shape[-1]:
        parts = [torch.matmul(h.to(dev), w.to(h.dtype)).to(dev0)
                 for w, dev in zip(ws, mesh.devices)]
        return collectives.all_gather(parts, -1, dev0, mesh.ids)
    parts, lo = [], 0
    for w, dev in zip(ws, mesh.devices):
        rows = w.shape[0]
        parts.append(torch.matmul(h[..., lo:lo + rows].to(dev),
                                  w.to(h.dtype)))
        lo += rows
    return shard_sum(parts, mesh)


def rmsnorm_init(d: int, dtype=torch.float32, device="cpu") -> dict:
    return {"g": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    d = x.shape[-1]
    ss = torch.sum(x.to(torch.float32) ** 2, dim=-1, keepdim=True)
    scale = torch.rsqrt(ss / d + eps).to(x.dtype)
    return x * scale * p["g"].to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device="cpu") -> dict:
    return {"g": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(p: dict, x: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    d = x.shape[-1]
    x32 = x.to(torch.float32)
    mu = x32.sum(-1, keepdim=True) / d
    var = torch.clamp((x32 * x32).sum(-1, keepdim=True) / d - mu * mu,
                      min=0.0)
    out = (x - mu.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype)
    return out * p["g"].to(x.dtype) + p["b"].to(x.dtype)


def norm_init(kind: str, d: int, dtype=torch.float32, device="cpu") -> dict:
    if kind == "rmsnorm":
        return rmsnorm_init(d, dtype, device)
    return layernorm_init(d, dtype, device)


def norm_apply(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm_apply(p, x) if kind == "rmsnorm" else layernorm_apply(p, x)


# ---------------------------------------------------------------------------
# Whole-tree helpers (params are nested dicts / lists of leaves)
# ---------------------------------------------------------------------------

def tree_map(fn, tree, path: tuple = ()):
    """Apply ``fn(path, leaf)`` to every tensor / QuantizedTensor leaf of a
    nest of dicts and lists; ``path`` is the tuple of keys down to it."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree) -> list:
    """The leaves of a nest of dicts and lists, in ``tree_map`` order."""
    out = []
    tree_map(lambda _, leaf: out.append(leaf), tree)
    return out


def tree_at(tree, path: tuple):
    """The subtree (or leaf) at ``path``, a tuple of keys as ``tree_map``
    gives them."""
    for k in path:
        tree = tree[k]
    return tree


def tree_index(tree, i: int):
    """Slice the leading (period) dim of every leaf: the Python loop over
    periods that replaces the reference's ``lax.scan``."""
    return tree_map(lambda _, leaf: leaf[i], tree)


#: sensitive / non-matmul params kept dense: embeddings, biases, norm gains,
#: router, SSM dynamics (A_log, D, dt, convs), sLSTM recurrence (r), head
_NO_QUANT_KEYS = ("table", "b", "g", "router", "A_log", "dt", "D",
                  "conv_b", "conv_w", "head", "out_norm_g", "r")


def quantize_params(params: Any, scheme: str = "sp2_4", *,
                    min_size: int = 4096, calibration: str = "mse") -> Any:
    """Replace every >=2-D floating weight leaf with >= ``min_size``
    elements and an even last dim by its SPx QuantizedTensor
    (per-output-channel alpha). Norm gains, biases, embedding tables,
    routers, SSM dynamics and small tensors stay dense; QuantizedTensor
    leaves pass through. This is the paper's deployment step."""
    def maybe_q(path, leaf):
        if isinstance(leaf, QuantizedTensor):
            return leaf
        if set(path) & set(_NO_QUANT_KEYS):
            return leaf
        if (leaf.ndim >= 2 and leaf.numel() >= min_size
                and leaf.is_floating_point() and leaf.shape[-1] % 2 == 0):
            return quantize_weight(leaf, scheme, calibration=calibration)
        return leaf

    return tree_map(maybe_q, params)
