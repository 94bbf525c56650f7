"""Tensor-parallel serving: where each leaf of a param tree and of the
paged pools is cut over the ``model`` axis, and the cutting.

``ShardingPolicy`` holds the reference's tensor-parallel rules
(``repro.sharding``) as far as the port's serving engine runs them:
Megatron alternation (column-parallel q/k/v/up/gate/head, row-parallel
``wo``/``down``), the replicated names, the table and head cut on the
vocabulary or, where it does not divide, on d, the MoE's experts split
over the shards (expert parallelism), and the paged pools head-sharded
where their KV heads divide (``pool_spec``). ``serving_cut`` is the cut
of one param leaf, uneven where a count does not divide the shards (the
reference's GSPMD pads or replicates there); it departs from the
reference's spec where the port's forward must: GSPMD may split the one
256-wide KV head of
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

The serve steps (``launch.steps``) add the reference's ``replicated``
parallelism (every leaf whole: the context-parallel prefill's weights),
``cache_spec`` (the dense caches' sequence over ``model``, the batch over
``data``) and ``shard_dense_caches`` / ``gather_dense_caches``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantized import QuantizedTensor
from repro_torch.nn.layers import tree_map
from repro_torch.runtime.planner import (kv_heads_split, shard_heads,
                                         split_ranges)

__all__ = ["ShardingPolicy", "kv_seq_axis", "shard_params",
           "shard_paged_state", "shard_dense_caches", "gather_dense_caches",
           "state_cut_dim", "refuse_training_mesh", "SHARDED_REST"]

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


def state_cut_dim(shape: tuple, m: int):
    """The dim of a recurrent state leaf (P, B, ...) that the serve steps
    cut over ``m`` model shards: its largest trailing dim (past P and B)
    that ``m`` divides, the later one of equal sizes; None where none
    does (the reference's ``cache_specs`` rule)."""
    cands = [(s, i) for i, s in enumerate(shape[2:], start=2) if _div(s, m)]
    return max(cands)[1] if cands else None


def _keys(path) -> list[str]:
    return [str(k) for k in path]


class ShardingPolicy:
    """The cut of a serving engine or a serve step over ``mesh`` (which
    needs only ``shape``, a dict of axis sizes with ``model`` and,
    for the serve steps, ``data``). ``parallelism``: ``tp`` (the
    tensor-parallel cut, ``serving_cut``) or ``replicated`` (every leaf
    whole on every shard: the context-parallel prefill's weights, the
    reference's ``replicated`` mode). ``kv_sharded``: whether the KV
    heads split over the shards (``planner.kv_heads_split``); else the K/V
    projections and the pools replicate."""

    model_axis = "model"

    def __init__(self, cfg: ArchConfig, mesh, *, parallelism: str = "tp"):
        if parallelism not in ("tp", "replicated"):
            raise NotImplementedError(
                f"parallelism {parallelism!r}: the port's policy cuts "
                f"serving weights only (ROADMAP.md: {SHARDED_REST})")
        self.cfg = cfg
        self.parallelism = parallelism
        axes = dict(mesh.shape)
        self.mesh_model = axes["model"]
        self.n_data = axes.get("data", 1)
        # replicated (the context-parallel prefill's weights): every shard
        # holds every leaf whole
        self.n_model = self.mesh_model if parallelism == "tp" else 1
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

    def serving_cut(self, keys: list[str], shape: tuple):
        """(dim, ((start, size) of each shard)) of a logical param leaf,
        or None where every shard holds it whole. The reference's tp rule,
        held to what this forward can cut, uneven where a count does not
        divide (``planner.split_ranges``): query heads split into head
        groups (``planner.shard_heads``: 12 over 8 as 2, 2, 2, 2, 1, 1, 1,
        1), the q columns, the ``wo`` rows and the q bias with them; K/V
        heads split when they divide (``kv_sharded``) and are computed
        whole on every shard otherwise, as their pools replicate (each
        shard then reads the KV heads its queries need); the vocabulary
        splits the tied table's rows or the untied head's columns, where it
        does not divide the table is cut on d (its columns) and the head
        on d (its rows), and where neither divides the vocabulary splits
        unevenly; the MoE's stacked experts split on their expert dim
        (unevenly where they do not divide) and the router replicates; the
        dense FFN's columns split on even boundaries (whole packed code
        bytes); a recurrent mixer's leaves stay whole on every shard, since
        the mixer runs whole there against replicated slabs. Raises
        NotImplementedError for a leaf this forward cannot cut: a bias on
        a row-parallel projection, a leaf no rule names."""
        cfg, n, nd = self.cfg, self.n_model, len(shape)
        names = set(keys)
        if n == 1:
            return None

        def need(ok: bool, what: str):
            if not ok:
                raise NotImplementedError(
                    f"shards={n}: {what} (ROADMAP.md: {SHARDED_REST})")

        def even(dim: int, granule: int = 1):
            return dim, split_ranges(shape[dim], n, granule)

        if "table" in names or "head" in names:
            table = "table" in names
            vocab, d = (nd - 2, nd - 1) if table else (nd - 1, nd - 2)
            if _div(shape[vocab], n) or not _div(shape[d], n):
                return even(vocab)
            return even(d)
        if names & _RECURRENT or "router" in names:
            return None
        if "moe" in names and "shared" not in names:
            need(nd >= 3 and shape[nd - 3] == cfg.n_experts,
                 f"no expert dim in {'/'.join(keys)}")
            return even(nd - 3)
        mixer = "attn" if "attn" in names else "xattn"
        if mixer in names:
            proj = keys[keys.index(mixer) + 1]
            dh = cfg.dh
            groups = shard_heads(cfg.n_heads, cfg.n_kv_heads, n)
            if proj in ("wk", "wv"):
                if not self.kv_sharded:
                    return None
                return nd - 1, tuple((g.kv0 * dh, g.nkv * dh)
                                     for g in groups)
            heads = tuple((g.q0 * dh, g.nq * dh) for g in groups)
            if proj == "wq":
                return nd - 1, heads
            need(keys[-1] == "w", f"a bias on the row-parallel {proj}")
            return nd - 2, heads
        ffn = "mlp" if "mlp" in names else "shared"
        if ffn in names:
            proj = keys[keys.index(ffn) + 1]
            dim = nd - 2 if proj == "down" else nd - 1
            if proj == "down":
                need(keys[-1] == "w", "a bias on the row-parallel down")
            return even(dim, 2 if shape[dim] % 2 == 0 else 1)
        if names & _REPLICATED or nd < 2:
            return None
        need(False, f"no serving cut for {'/'.join(keys)}")

    # -- the serve steps' layouts (``launch.steps``) -------------------------

    def _batch_axes(self, b: int):
        """The data axis where it divides the batch, else None (every data
        group runs the whole batch): the reference's largest dividing
        prefix of the data axes, over the port's one data axis."""
        return "data" if _div(b, self.n_data) else None

    def cache_spec(self, keys: list[str], shape: tuple) -> Spec:
        """Spec of one leaf of the dense serving caches
        (``models.lm.init_caches``, ``encdec_init_caches``), the
        reference's ``cache_specs`` leaf: K/V and cross K/V (P, B, Hkv, S,
        dh), codes and scales alike, cut on their sequence over the model
        axis where it divides; recurrent states (P, B, ...) on their
        largest trailing dim that divides; the batch over data where it
        divides."""
        m = self.mesh_model
        kv = keys[-1] in ("k", "v", "xk", "xv") or (
            len(keys) >= 2 and keys[-2] in ("k", "v")
            and keys[-1] in ("codes", "scale"))
        spec = [None] * len(shape)
        spec[1] = self._batch_axes(shape[1])
        if kv:
            if _div(shape[3], m):
                spec[3] = self.model_axis
            return tuple(spec)
        dim = state_cut_dim(shape, m)
        if dim is not None:
            spec[dim] = self.model_axis
        return tuple(spec)

    def cache_specs(self, caches: Any) -> dict:
        """``cache_spec`` of every leaf of ``caches``, by its path (a
        tuple of keys)."""
        out = {}
        tree_map(lambda path, x: out.__setitem__(
            path, self.cache_spec(_keys(path), tuple(x.shape))), caches)
        return out


def kv_seq_axis(specs: dict):
    """The axis ``specs`` (``ShardingPolicy.cache_specs`` of the dense
    caches) cuts the self-attention K/V's sequence over, or None: what
    the forward reads as ``Runtime.decode_seq_axis``."""
    axes = {spec[3] for path, spec in specs.items()
            if str(path[1]) in ("k", "v")}
    return axes.pop() if len(axes) == 1 else None


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


def _cut(t: torch.Tensor, dim: int, start: int, size: int) -> torch.Tensor:
    return t.narrow(dim, start, size)


def shard_params(params: Any, policy: ShardingPolicy, mesh) -> list:
    """One param tree per shard of ``mesh`` (on that shard's device), cut
    by ``policy.serving_cut``. A QuantizedTensor's column cut takes the
    packed code bytes and per-column scales of its slice (the cuts fall on
    even columns), an expert cut its experts' codes and scales, a row cut
    its code rows and every scale: each shard holds exactly the unsharded
    codes of its slice."""

    def take(s: int, device):
        def leaf(path, x):
            keys = _keys(path)
            if isinstance(x, QuantizedTensor):
                cut = policy.serving_cut(keys, x.logical_shape)
                codes, scale = x.codes, x.scale
                if cut is not None:
                    dim, (start, size) = cut[0], cut[1][s]
                    if x.packed and dim == x.ndim - 1:
                        if start % 2 or size % 2:
                            raise ValueError(
                                f"{'/'.join(keys)}: columns [{start}, "
                                f"{start + size}) would cut a packed byte")
                        codes = _cut(codes, dim, start // 2, size // 2)
                    else:
                        codes = _cut(codes, dim, start, size)
                    if scale.shape[dim] > 1:
                        # per-column (or per-expert) scales go with their
                        # slice; a row cut keeps every scale
                        scale = _cut(scale, dim, start, size)
                return QuantizedTensor(_place(codes, device),
                                       _place(scale, device), x.scheme,
                                       x.packed)
            cut = policy.serving_cut(keys, tuple(x.shape))
            if cut is not None:
                x = _cut(x, cut[0], *cut[1][s])
            return _place(x, device)
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
                x = _cut(x, 2, s * x.shape[2] // n, x.shape[2] // n)
            return _copy_to(x, device)
        return tree_map(leaf, caches)
    return [take(s, d) for s, d in enumerate(mesh.devices)]


# -- the serve steps' dense caches -------------------------------------------

def _spec_slice(x: torch.Tensor, spec: Spec, d: int, m: int, mesh):
    """Data group ``d``, model shard ``m``'s block of ``x`` under
    ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = mesh.shape[axis]
            size = x.shape[dim] // n
            x = _cut(x, dim, (d if axis == "data" else m) * size, size)
    return x


def shard_dense_caches(caches: Any, specs: dict, mesh) -> list:
    """The dense serving caches cut over a ``HostMesh`` by ``specs``
    (``ShardingPolicy.cache_specs`` of the whole caches):
    ``grid[d][m]``, a copy of data group ``d``, model shard ``m``'s block
    of every leaf, on its device."""
    return [[tree_map(lambda path, x: _copy_to(
        _spec_slice(x, specs[path], d, m, mesh), dev), caches)
        for m, dev in enumerate(row)] for d, row in enumerate(mesh.grid)]


def gather_dense_caches(grid: list, specs: dict, device="cpu") -> Any:
    """``shard_dense_caches``'s inverse: every leaf reassembled on
    ``device`` from the blocks of ``grid``, joined in group and shard
    order (a replicated axis read from its first group or shard)."""

    def whole(path, _):
        spec = specs[path]

        def block(d, m):
            x = grid[d][m]
            for k in path:
                x = x[k]
            return x.to(device)

        def join(axis, parts):
            if axis not in spec:
                return parts[0]
            return torch.cat(parts, spec.index(axis))
        return join("data", [join("model", [block(d, m)
                                            for m in range(len(row))])
                             for d, row in enumerate(grid)])
    return tree_map(whole, grid[0][0])

