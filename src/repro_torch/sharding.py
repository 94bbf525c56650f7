"""Tensor-parallel serving: where each leaf of a param tree and of the
paged pools is cut over the ``model`` axis, and the cutting.

``ShardingPolicy`` holds the reference's tensor-parallel rules
(``repro.sharding``) as far as the port's serving engine runs them:
Megatron alternation (column-parallel q/k/v/up/gate/head, row-parallel
``wo``/``down``), the replicated names, the table and head cut on the
vocabulary or, where it does not divide, on d, the MoE's experts split
over the shards (expert parallelism), and the paged pools head-sharded
where their KV heads divide (``pool_spec``). ``serving_dim`` is the cut
of one param leaf; it departs from the reference's spec where the
port's forward must: GSPMD may split the one 256-wide KV head of
gemma-2b's ``wk`` over two devices, since any placement is correct
there, but a shard of the port's forward attends whole heads, so K/V
projections whose heads do not divide the shards are computed whole on
every shard, as their pools replicate; and a recurrent mixer (whose
projections GSPMD cuts by columns and rows) runs whole on every shard,
since its slabs replicate, as the reference's pool spec keeps them.

``shard_params`` and ``shard_paged_state`` cut a param tree and the
paged pools into one tree per shard, for the port's single-controller
tensor-parallel forward (``models.lm``, ``models.encdec``): each shard
holds the column slices of its heads and FFN columns, the row slices of
``wo`` and ``down``, its experts, and its slice of the table and head. A
quantized weight is cut after quantization: each shard holds exactly the
unsharded codes and scales of its slice.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantized import QuantizedTensor
from repro_torch.nn.layers import tree_map
from repro_torch.runtime.planner import kv_heads_split

__all__ = ["ShardingPolicy", "shard_params", "shard_paged_state",
           "refuse_training_mesh", "SHARDED_REST"]

#: the ROADMAP.md item that ports what sharded serving still lacks
SHARDED_REST = "multi-device and drivers (the rest)"

#: replicated regardless of size
_REPLICATED = {"norm1", "norm2", "norm_x", "final_norm", "enc_norm", "router",
               "conv_w", "conv_b", "A_log", "D", "out_norm_g", "r", "b", "g"}
#: the recurrent mixers, whose leaves every shard holds whole
_RECURRENT = {"mamba", "mlstm", "slstm"}
#: leaf keys of the paged state cache's head-sharded pools
_POOL_KEYS = ("kp", "vp", "xk", "xv")

Spec = tuple


def refuse_training_mesh(rt) -> None:
    """Raise for a training loss under ``rt.mesh``: the port's mesh is a
    serving engine's; training under a mesh is still to be ported."""
    if rt.mesh is not None:
        raise NotImplementedError(
            f"training under a mesh (ROADMAP.md: {SHARDED_REST})")


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _keys(path) -> list[str]:
    return [str(k) for k in path]


class ShardingPolicy:
    """The tensor-parallel cut of a serving engine over ``mesh`` (which
    needs only ``shape``, a dict of axis sizes with ``model``).
    ``kv_sharded``: whether the KV heads split over the shards
    (``planner.kv_heads_split``); else the K/V projections and the pools
    replicate."""

    model_axis = "model"

    def __init__(self, cfg: ArchConfig, mesh):
        self.cfg = cfg
        self.n_model = dict(mesh.shape)["model"]
        self.kv_sharded = kv_heads_split(cfg.n_kv_heads, self.n_model)

    def pool_spec(self, keys: list[str], shape: tuple) -> Spec:
        """Spec of one leaf of the paged state cache: the token K/V pools
        (``kp``/``vp``, ``(P, n_pages, Hkv, page_size, dh)``) and the cross
        entries (``xk``/``xv``) shard their KV-head axis over the model
        axis when it splits, the ``codes``/``scale`` of a quantized pool
        included; every other leaf (recurrent slabs) replicates. The
        reference's ``paged_state_specs`` leaf for leaf."""
        nd = len(shape)
        pool = keys[-1] in _POOL_KEYS or (
            len(keys) >= 2 and keys[-2] in _POOL_KEYS
            and keys[-1] in ("codes", "scale"))
        if pool and nd == 5 and kv_heads_split(shape[2], self.n_model):
            return (None, None, self.model_axis, None, None)
        return (None,) * nd

    def serving_dim(self, keys: list[str], shape: tuple):
        """The dim of a logical (unpacked) param leaf that the port's
        tensor-parallel forward cuts over the model axis, or None for a
        leaf every shard holds whole. The reference's tp rule, held to
        what this forward can cut: q heads split evenly; K/V heads split
        when they divide (``kv_sharded``) and are computed whole on every
        shard otherwise (one KV head only: a shard's query heads must
        share it); ``wo`` and ``down`` split their input rows; the
        vocabulary splits the tied table's rows or the untied head's
        columns, and where it does not divide the table is cut on d (its
        columns) and the head on d (its rows); the MoE's stacked experts
        split on their expert dim and the router replicates; a recurrent
        mixer's leaves (mamba, mLSTM, sLSTM) stay whole on every shard,
        since the mixer runs whole there against replicated slabs. Raises
        NotImplementedError for a leaf this forward cannot cut."""
        cfg, n, nd = self.cfg, self.n_model, len(shape)
        names = set(keys)
        if n == 1:
            return None

        def need(ok: bool, what: str):
            if not ok:
                raise NotImplementedError(
                    f"shards={n}: {what} (ROADMAP.md: {SHARDED_REST})")

        if "table" in names or "head" in names:
            table = "table" in names
            vocab, d = (nd - 2, nd - 1) if table else (nd - 1, nd - 2)
            if _div(shape[vocab], n):
                return vocab
            need(_div(shape[d], n), f"neither vocab {shape[vocab]} nor "
                 f"d_model {shape[d]} splits evenly")
            return d
        if names & _RECURRENT or "router" in names:
            return None
        if "moe" in names and "shared" not in names:
            need(nd >= 3 and shape[nd - 3] == cfg.n_experts
                 and _div(cfg.n_experts, n),
                 f"{cfg.n_experts} experts do not split evenly")
            return nd - 3
        mixer = "attn" if "attn" in names else "xattn"
        if mixer in names:
            proj = keys[keys.index(mixer) + 1]
            need(_div(cfg.n_heads, n),
                 f"{cfg.n_heads} query heads do not split evenly")
            if proj in ("wk", "wv"):
                if self.kv_sharded:
                    return nd - 1
                need(cfg.n_kv_heads == 1,
                     f"{cfg.n_kv_heads} KV heads neither split evenly nor "
                     "sit one per shard's query heads")
                return None
            if proj == "wq":
                return nd - 1
            need(keys[-1] == "w", f"a bias on the row-parallel {proj}")
            return nd - 2
        ffn = "mlp" if "mlp" in names else "shared"
        if ffn in names:
            proj = keys[keys.index(ffn) + 1]
            dim = nd - 2 if proj == "down" else nd - 1
            if proj == "down":
                need(keys[-1] == "w", "a bias on the row-parallel down")
            need(_div(shape[dim], n),
                 f"d_ff {shape[dim]} does not split evenly")
            return dim
        if names & _REPLICATED or nd < 2:
            return None
        need(False, f"no serving cut for {'/'.join(keys)}")


# -- cutting trees into shards ------------------------------------------------

def _copy_to(t: torch.Tensor, device) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    return out.copy_(t)


def _place(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``, contiguous; shared when it already is both
    (params are read-only)."""
    if t.device == torch.device(device) and t.is_contiguous():
        return t
    return _copy_to(t, device)


def _cut(t: torch.Tensor, dim: int, s: int, n: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, s * size, size)


def shard_params(params: Any, policy: ShardingPolicy, mesh) -> list:
    """One param tree per shard of ``mesh`` (on that shard's device), cut
    by ``policy.serving_dim``. A QuantizedTensor's column cut takes its
    packed code bytes and per-column scales of the slice, an expert cut
    its experts' codes and scales, a row cut its code rows and every
    scale: each shard holds exactly the unsharded codes of its slice."""
    n = mesh.size

    def take(s: int, device):
        def leaf(path, x):
            keys = _keys(path)
            if isinstance(x, QuantizedTensor):
                dim = policy.serving_dim(keys, x.logical_shape)
                codes, scale = x.codes, x.scale
                if dim == x.ndim - 1:
                    cols = x.logical_shape[-1] // n
                    if x.packed and cols % 2:
                        raise NotImplementedError(
                            f"shards={n}: {'/'.join(keys)} would cut a "
                            f"packed code byte ({cols} columns per shard)")
                if dim is not None:
                    codes = _cut(codes, dim, s, n)
                    if scale.shape[dim] > 1:
                        # per-column (or per-expert) scales go with their
                        # slice; a row cut keeps every scale
                        scale = _cut(scale, dim, s, n)
                return QuantizedTensor(_place(codes, device),
                                       _place(scale, device), x.scheme,
                                       x.packed)
            dim = policy.serving_dim(keys, tuple(x.shape))
            return _place(x if dim is None else _cut(x, dim, s, n), device)
        return tree_map(leaf, params)
    return [take(s, d) for s, d in enumerate(mesh.devices)]


def shard_paged_state(caches: Any, policy: ShardingPolicy, mesh) -> list:
    """One copy of the paged state cache per shard (on that shard's
    device): the pools' head axis cut where ``pool_spec`` shards it,
    everything else copied whole. Each shard owns its
    tensors."""
    n = mesh.size

    def take(s: int, device):
        def leaf(path, x):
            if policy.pool_spec(_keys(path), tuple(x.shape))[2:3] == \
                    (policy.model_axis,):
                x = _cut(x, 2, s, n)
            return _copy_to(x, device)
        return tree_map(leaf, caches)
    return [take(s, d) for s, d in enumerate(mesh.devices)]
