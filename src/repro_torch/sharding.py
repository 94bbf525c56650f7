"""Where each leaf of a param tree, an optimizer state and the caches is
cut over a mesh, and the cutting: tensor-parallel serving over the
``model`` axis, the serve steps and the train step over ``(data,
model)``.

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
``stored_layouts`` (the weights stored as ``make_policy`` cuts the
reference's quantized params: above ``FSDP_ABOVE`` params each codes and
scale leaf also cut over data), ``cache_spec`` (the dense caches'
sequence over ``model``, the batch over the data axes) and
``shard_dense_caches`` / ``gather_dense_caches``. On a mesh with a
``pod`` axis the rows are pod-major (``axis_coords``); the data axes are
``("pod", "data")`` and FSDP spans the pods only for a model above
``POD_FSDP_ABOVE`` params, as the reference's.

The train step (``launch.steps.build_train_step``) adds the reference's
training storage: ``fsdp`` (ZeRO-3: every weight cut over ``("data",
"model")``, the batch over every device) and ``tp`` with FSDP over
``data`` (``make_policy``'s default above ``FSDP_ABOVE`` params),
``param_specs`` and ``opt_specs`` (the reference's leaf for leaf; under
``tp`` the model axis on ``serving_cut``'s dim), each leaf's ``Layout``
(its blocks' ranges), ``place_blocks`` / ``gather_blocks`` (a tree cut
into ``grid[d][m]`` blocks and joined back), ``gathered_view`` (the
weights a device computes with, ``GatheredLeaf``s that gather its blocks
where they are read: per period inside the stack's checkpoints) and
``reduce_copies`` (the gradients of blocks held by several devices summed
in device order).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import collectives
from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantized import QuantizedTensor
from repro_torch.nn.layers import tree_at, tree_map
from repro_torch.runtime.planner import (kv_heads_split, shard_heads,
                                         split_ranges)

__all__ = ["ShardingPolicy", "Layout", "make_policy", "kv_seq_axis",
           "shard_params", "shard_paged_state", "shard_dense_caches",
           "gather_dense_caches", "place_blocks", "gather_blocks",
           "gathered_view", "reduce_copies", "GatheredLeaf",
           "GatheredQuantized", "whole", "state_cut_dim", "spec_layout",
           "axis_coords", "SHARDED_REST", "FSDP_ABOVE", "POD_FSDP_ABOVE"]

#: where ROADMAP.md lists a cut the port cannot make: a leaf that no cut
#: rule names (``ShardingPolicy.serving_cut`` raises)
SHARDED_REST = 'ROADMAP.md Queue 1, "Other knobs that raise"'

#: replicated regardless of size
_REPLICATED = {"norm1", "norm2", "norm_x", "final_norm", "enc_norm", "router",
               "conv_w", "conv_b", "A_log", "D", "out_norm_g", "r", "b", "g"}
#: the reference's Megatron alternation: row-parallel (input dim over
#: model) and column-parallel (output dim over model) projections
_ROW_PARALLEL = {"wo", "down", "down_proj", "out_proj"}
_COL_PARALLEL = {"wq", "wk", "wv", "up", "gate", "in_proj", "w_in", "x_proj",
                 "dt_proj", "w_gates", "head"}
#: optimizer-state keys that ``opt_specs`` strips to find the param
_MOMENTS = ("mu", "nu", "m", "v", "ef")
#: the recurrent mixers, whose leaves every shard holds whole
_RECURRENT = {"mamba", "mlstm", "slstm"}
#: leaf keys of the paged state cache's head-sharded pools
_POOL_KEYS = ("kp", "vp", "xk", "xv")

Spec = tuple


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
    """The cut of a serving engine, a serve step or a train step over
    ``mesh`` (which needs only ``shape``, a dict of axis sizes with
    ``model`` and, for the steps, ``data``). ``parallelism``: ``tp`` (the
    tensor-parallel cut, ``serving_cut``; with ``fsdp`` the train step
    also cuts a second dim of each weight over ``data``), ``fsdp`` (the
    train step's ZeRO-3: the batch over every device, each weight cut over
    ``("data", "model")``, no model axis) or ``replicated`` (every leaf
    whole on every shard: the context-parallel prefill's weights, the
    reference's ``replicated`` mode). ``kv_sharded``: whether the KV
    heads split over the shards (``planner.kv_heads_split``); else the K/V
    projections and the pools replicate."""

    model_axis = "model"

    def __init__(self, cfg: ArchConfig, mesh, *, fsdp: bool = False,
                 parallelism: str = "tp"):
        if parallelism not in ("tp", "fsdp", "replicated"):
            raise ValueError(f"unknown parallelism {parallelism!r}")
        self.cfg = cfg
        self.parallelism = parallelism
        axes = dict(mesh.shape)
        self.axes = axes
        # replicated (the context-parallel prefill's weights) and fsdp:
        # no weight is cut over the model axis
        self.n_model = axes["model"] if parallelism == "tp" else 1
        self.kv_sharded = kv_heads_split(cfg.n_kv_heads, self.n_model)
        # the reference's axes (``repro.sharding.ShardingPolicy``): under
        # fsdp the batch over every axis and the weights over (data,
        # model), so each pod holds a copy; under tp the batch over (pod,
        # data) and the weights' second cut over data, or over (pod, data)
        # for a model above POD_FSDP_ABOVE params
        self.fsdp = (fsdp or parallelism == "fsdp") \
            and parallelism != "replicated"
        present = tuple(a for a in ("pod", "data") if a in axes)
        if parallelism == "fsdp":
            self.data_axes = present + ("model",)
            self.fsdp_axes = ("data", "model")
        elif parallelism == "replicated":
            self.data_axes, self.fsdp_axes = present, ()
        else:
            # the axes FSDP would take (the reference names them also
            # where ``fsdp`` is off; no leaf is then cut over them)
            self.data_axes = present
            giant = cfg.param_count_estimate() > POD_FSDP_ABOVE
            self.fsdp_axes = (present if "pod" in axes and giant
                              else ("data",))
        self.n_data = 1
        for a in self.data_axes:
            self.n_data *= axes[a]
        self.n_fsdp = 1
        for a in self.fsdp_axes:
            self.n_fsdp *= axes[a]

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
        1), the q columns, the ``wo`` rows and the q bias with them; where
        the shards outnumber the query heads, each head is shared by a
        group of shards, each holding the head's q columns whole and its
        own slice of the head's ``wo`` rows (``HeadGroup.out_rows``); K/V
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
                    f"shards={n}: {what}: no cut rule names this leaf, so "
                    f"its cut is not ported ({SHARDED_REST})")

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
            if proj == "wq":
                return nd - 1, tuple((g.q0 * dh, g.nq * dh) for g in groups)
            need(keys[-1] == "w", f"a bias on the row-parallel {proj}")
            return nd - 2, tuple(g.out_rows(dh) for g in groups)
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

    # -- the train step's storage (``launch.steps.build_train_step``) --------

    def _fsdp_entry(self):
        return (self.fsdp_axes if len(self.fsdp_axes) > 1
                else self.fsdp_axes[0])

    def _ref_spec(self, keys: list[str], shape: tuple) -> list:
        """The reference's spec of one param leaf
        (``repro.sharding.ShardingPolicy._weight_spec`` and ``_tp_spec``),
        leaf for leaf: the table on its vocabulary or d over the model
        axis, else over the FSDP axes; the replicated names whole; the
        MoE's expert dim over the model axis and its largest remaining
        dim that divides over the FSDP axes; every other weight
        row-parallel (``wo``, ``down``), column-parallel, or on the larger
        of its last two dims over the model axis, and the larger remaining
        of those two that divides over the FSDP axes."""
        nd, names = len(shape), set(keys)
        model = self.model_axis if self.parallelism == "tp" else None
        spec: list = [None] * nd
        if "table" in names:
            if self.n_model > 1 and _div(shape[-2], self.n_model):
                spec[-2] = model
            elif self.n_model > 1 and _div(shape[-1], self.n_model):
                spec[-1] = model
            elif self.fsdp and _div(shape[-2], self.n_fsdp):
                spec[-2] = self._fsdp_entry()
            elif self.fsdp and _div(shape[-1], self.n_fsdp):
                spec[-1] = self._fsdp_entry()
            return spec
        if "router" in names or (names & _REPLICATED and "moe" not in names) \
                or nd < 2:
            return spec
        if "moe" in names and nd >= 3 and not names & _REPLICATED:
            for i, size in enumerate(shape):
                if size == self.cfg.n_experts and _div(size, self.n_model):
                    spec[i] = model
                    break
            else:
                return self._ref_tp_spec(keys, shape, model)
            if self.fsdp:
                cands = [(size, i) for i, size in enumerate(shape)
                         if spec[i] is None and _div(size, self.n_fsdp)]
                if cands:
                    spec[max(cands)[1]] = self._fsdp_entry()
            return spec
        return self._ref_tp_spec(keys, shape, model)

    def _ref_tp_spec(self, keys: list[str], shape: tuple, model) -> list:
        nd, names = len(shape), set(keys)
        spec: list = [None] * nd
        tp_dim = None
        if names & _ROW_PARALLEL and nd >= 2:
            tp_dim = nd - 2
        elif names & _COL_PARALLEL:
            tp_dim = nd - 1
        if tp_dim is not None and not _div(shape[tp_dim], self.n_model):
            tp_dim = None
        if tp_dim is None:
            cands = [(size, i) for i, size in enumerate(shape[-2:],
                                                        start=nd - 2)
                     if _div(size, self.n_model)]
            if cands:
                tp_dim = max(cands)[1]
        if tp_dim is not None:
            spec[tp_dim] = model
        if self.fsdp and nd >= 2:
            cands = [(size, i) for i, size in enumerate(shape)
                     if spec[i] is None and i >= nd - 2
                     and _div(size, self.n_fsdp)]
            if cands:
                spec[max(cands)[1]] = self._fsdp_entry()
        return spec

    def param_layout(self, keys: list[str], shape: tuple,
                     cut=False) -> "Layout":
        """Where the train step stores one param leaf. ``fsdp``: the
        reference's spec exactly. ``tp``: the model axis on
        ``serving_cut``'s dim and ranges (the forward's cut, with its
        named departures from the reference: K/V whole where the KV heads
        do not split, recurrent mixers whole, q/k/v biases cut with their
        heads, uneven cuts where a count does not divide), the FSDP axis
        on the reference's FSDP dim (a gathered weight is the same
        whatever the cut); a table cut over the model axis is cut over
        nothing else, as the reference's. ``replicated``: whole. ``cut``:
        the model cut of a stored leaf given in place of
        ``serving_cut``'s (a QuantizedTensor's codes or scale,
        ``stored_layouts``)."""
        nd = len(shape)
        if self.parallelism == "replicated":
            return Layout((None,) * nd, (None,) * nd, tuple(shape))
        spec = self._ref_spec(keys, shape)
        ranges: list = [None] * nd
        if self.parallelism == "tp":
            spec = [None if e == self.model_axis else e for e in spec]
            if cut is False:
                cut = self.serving_cut(keys, shape)
            if cut is not None:
                spec[cut[0]] = self.model_axis  # an FSDP cut there gives way
                ranges[cut[0]] = cut[1]
                if "table" in keys:
                    spec = [e if e == self.model_axis else None
                            for e in spec]
        return self._layout(spec, ranges, shape)

    def opt_layout(self, keys: list[str], shape: tuple) -> "Layout":
        """Where the train step stores one optimizer-state leaf (the
        reference's ``opt_specs``): a moment, or the codes of an 8-bit
        one, follows its param (``mu``/``nu``/``m``/``v``/``ef`` and
        ``codes`` stripped from the path); the per-row scale of an 8-bit
        moment, (..., 1), takes the reference's spec of its own shape
        (its rows may be cut otherwise than its codes: the update joins
        the scale whole, ``training.optimizer``); scalars replicate."""
        keys = [k for k in keys if k not in _MOMENTS]
        if keys[-1] == "scale" and self.parallelism != "replicated":
            return self._layout(self._ref_spec(keys, shape),
                                [None] * len(shape), shape)
        return self.param_layout([k for k in keys if k != "codes"], shape)

    def _layout(self, spec: list, ranges: list, shape: tuple) -> "Layout":
        """``spec`` with the even ranges of every cut ``ranges`` leaves
        open."""
        out = []
        for dim, entry in enumerate(spec):
            if entry is None or ranges[dim] is not None:
                out.append(ranges[dim])
                continue
            n = 1
            for a in _axes_of(entry):
                n *= self.axes[a]
            out.append(split_ranges(shape[dim], n))
        return Layout(tuple(spec), tuple(out), tuple(shape))

    def param_specs(self, params: Any) -> dict:
        """{path: spec} of every leaf of a param tree (tensors or meta
        tensors), the reference's ``param_specs`` as ``param_layout``
        stores them."""
        return {path: lay.spec
                for path, lay in self.param_layouts(params).items()}

    def opt_specs(self, opt_state: Any) -> dict:
        """{path: spec} of every leaf of an optimizer state."""
        return {path: lay.spec
                for path, lay in self.opt_layouts(opt_state).items()}

    def param_layouts(self, params: Any) -> dict:
        out = {}
        tree_map(lambda path, x: out.__setitem__(
            path, self.param_layout(_keys(path), tuple(x.shape))), params)
        return out

    def opt_layouts(self, opt_state: Any) -> dict:
        out = {}
        tree_map(lambda path, x: out.__setitem__(
            path, self.opt_layout(_keys(path), tuple(getattr(x, "shape",
                                                              ())))),
                 opt_state)
        return out

    # -- the serve steps' storage (``launch.steps.build_serve_step``) -------

    def stored_layouts(self, params: Any) -> dict:
        """The ``Layout`` of every stored leaf of a serving param tree: a
        tensor's ``param_layout``; a QuantizedTensor's codes and scale
        each its own, keyed ``path + ("codes",)`` and ``path +
        ("scale",)``, as the reference's ``param_specs`` cut its quantized
        params: the model axis on ``serving_cut``'s cut of the logical
        weight (the codes' columns on whole packed bytes, the scales' with
        their columns or experts; a row cut keeps every scale), the FSDP
        axes on the reference's FSDP dim of the stored leaf itself."""
        out = {}

        def leaf(path, x):
            keys = _keys(path)
            if not isinstance(x, QuantizedTensor):
                out[path] = self.param_layout(keys, tuple(x.shape))
                return
            cut = (self.serving_cut(keys, x.logical_shape)
                   if self.parallelism == "tp" else None)
            for name, t in (("codes", x.codes), ("scale", x.scale)):
                shape = tuple(t.shape)
                out[path + (name,)] = self.param_layout(
                    keys, shape, _stored_cut(cut, name, x, keys, shape))
        tree_map(leaf, params)
        return out

    # -- the serve steps' layouts (``launch.steps``) -------------------------

    def _batch_axes(self, b: int):
        """The data axes the batch is cut over: the reference's, each axis
        of ``data_axes`` (pod first) that divides what the axes before it
        left; None where none does (every row runs the whole batch)."""
        out, rem = [], b
        for a in self.data_axes:
            if rem % self.axes[a] == 0:
                out.append(a)
                rem //= self.axes[a]
        if not out:
            return None
        return tuple(out) if len(out) > 1 else out[0]

    def cache_spec(self, keys: list[str], shape: tuple) -> Spec:
        """Spec of one leaf of the dense serving caches
        (``models.lm.init_caches``, ``encdec_init_caches``), the
        reference's ``cache_specs`` leaf: K/V and cross K/V (P, B, Hkv, S,
        dh), codes and scales alike, cut on their sequence over the model
        axis where the policy's model shards (``n_model``) divide it;
        recurrent states (P, B, ...) on their largest trailing dim that
        they divide; the batch over data where it divides. Under
        ``replicated`` (the context-parallel prefill) ``n_model`` is 1, as
        the reference's: every K/V is cut on its sequence and every state
        on its largest trailing dim, unevenly where the model axis does
        not divide them (``spec_layout``; XLA pads the reference's)."""
        m = self.n_model
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


#: above this many params ``make_policy`` turns FSDP on by default
FSDP_ABOVE = 2e9
#: above this many params tp's FSDP also spans the pod axis (the
#: reference's giants, jamba-1.5-large-398b and kimi-k2-1t-a32b)
POD_FSDP_ABOVE = 100e9


def make_policy(cfg: ArchConfig, mesh, **kw) -> ShardingPolicy:
    """The reference's ``make_policy``: under ``tp``, FSDP over ``data``
    by default above ``FSDP_ABOVE`` params (the 8-15B dense configs and
    the giants do not fit otherwise)."""
    if kw.get("parallelism") != "fsdp" and "fsdp" not in kw:
        kw["fsdp"] = cfg.param_count_estimate() > FSDP_ABOVE
    return ShardingPolicy(cfg, mesh, **kw)


def _stored_cut(cut, name: str, x: QuantizedTensor, keys, shape: tuple):
    """``serving_cut``'s cut of a QuantizedTensor's logical weight as the
    cut of its ``codes`` or ``scale`` (of ``shape``): packed columns in
    whole bytes, the scales' where they have that dim, else None."""
    if cut is None:
        return None
    dim, ranges = cut
    if name == "scale":
        return cut if shape[dim] > 1 else None
    if x.packed and dim == x.ndim - 1:
        if any(start % 2 or size % 2 for start, size in ranges):
            raise ValueError(f"{'/'.join(keys)}: a cut {ranges} would cut "
                             "a packed byte")
        return dim, tuple((start // 2, size // 2) for start, size in ranges)
    return cut


def kv_seq_axis(specs: dict):
    """The axis ``specs`` (``ShardingPolicy.cache_specs`` of the dense
    caches) cuts the self-attention K/V's sequence over, or None: what
    the forward reads as ``Runtime.decode_seq_axis``."""
    axes = {spec[3] for path, spec in specs.items()
            if str(path[1]) in ("k", "v")}
    return axes.pop() if len(axes) == 1 else None


# -- the train step's blocks ---------------------------------------------------

def _axes_of(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def axis_coords(d: int, m: int, sizes: dict) -> dict:
    """Device (row ``d``, shard ``m``)'s coordinate on each axis of a mesh
    of axis ``sizes`` (``launch.mesh.HostMesh``: rows pod-major)."""
    return {"pod": d // sizes["data"], "data": d % sizes["data"],
            "model": m}


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a leaf of a step lives on a ``(pod,) data x model`` mesh:
    ``spec`` per dim None, an axis, or a tuple of axes (cut over their
    devices together, the first axis major: ``("data", "model")`` block
    ``d * M + m``); ``ranges`` per cut dim the (start, size) of each
    block, uneven where ``serving_cut`` cuts unevenly (or overlapping,
    where shards share a head); ``shape`` the whole leaf's. A device is
    (row ``d``, shard ``m``), its rows pod-major."""
    spec: Spec
    ranges: tuple
    shape: tuple

    def coord(self, axes: tuple, d: int, m: int, sizes: dict) -> int:
        at = axis_coords(d, m, sizes)
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + at[a]
        return idx

    def index(self, d: int, m: int, sizes: dict) -> tuple:
        """The slices of device (d, m)'s block of the whole leaf."""
        out = []
        for entry, rng in zip(self.spec, self.ranges):
            if entry is None:
                out.append(slice(None))
                continue
            start, size = rng[self.coord(_axes_of(entry), d, m, sizes)]
            out.append(slice(start, start + size))
        return tuple(out)

    def block_shape(self, d: int, m: int, sizes: dict) -> tuple:
        return tuple(len(range(*s.indices(n)))
                     for s, n in zip(self.index(d, m, sizes), self.shape))

    def block_key(self, d: int, m: int, sizes: dict) -> tuple:
        """Equal for the devices that hold the same block (copies)."""
        return tuple((s.start, s.stop) for s in self.index(d, m, sizes))

    def block_bytes(self, d: int, m: int, sizes: dict, itemsize: int) -> int:
        n = itemsize
        for size in self.block_shape(d, m, sizes):
            n *= size
        return n


def spec_layout(spec: Spec, shape: tuple, sizes: dict) -> Layout:
    """``spec`` as a ``Layout``: each cut's blocks even where its devices
    divide the dim, else ``split_ranges``' (the first ones one larger)."""
    ranges = []
    for dim, entry in enumerate(spec):
        if entry is None:
            ranges.append(None)
            continue
        n = 1
        for a in _axes_of(entry):
            n *= sizes[a]
        ranges.append(split_ranges(shape[dim], n))
    return Layout(tuple(spec), tuple(ranges), tuple(shape))


def place_blocks(tree: Any, layouts: dict, mesh, share: bool = False) -> list:
    """``grid[d][m]``: a copy of device (d, m)'s block of every tensor
    leaf of ``tree`` (whole, on any device) on that device, by
    ``layouts`` ({path: Layout}); a QuantizedTensor's codes and scale each
    by its own (``ShardingPolicy.stored_layouts``); other leaves (an
    optimizer's step count) as they are. ``share``: a block that is the
    whole leaf, already contiguous on the device, is that leaf (read-only
    serving weights), not a copy."""
    sizes = mesh.shape

    def block(lay, x, d, m, dev):
        if share and all(e is None for e in lay.spec):
            return _place(x, dev)
        return _copy_to(x[lay.index(d, m, sizes)], dev)

    def take(d, m, dev):
        def leaf(path, x):
            if isinstance(x, QuantizedTensor):
                return QuantizedTensor(
                    block(layouts[path + ("codes",)], x.codes, d, m, dev),
                    block(layouts[path + ("scale",)], x.scale, d, m, dev),
                    x.scheme, x.packed)
            if not isinstance(x, torch.Tensor):
                return x
            return block(layouts[path], x, d, m, dev)
        return tree_map(leaf, tree)
    return [[take(d, m, dev) for m, dev in enumerate(row)]
            for d, row in enumerate(mesh.grid)]


def gather_blocks(grid: list, layouts: dict, mesh, device="cpu") -> Any:
    """``place_blocks``'s inverse: every leaf whole on ``device``, each
    block written where ``layouts`` puts it (a copy over an axis from its
    last device, all copies equal)."""
    sizes = mesh.shape

    def whole(path, first):
        if not isinstance(first, torch.Tensor):
            return first
        lay = layouts[path]
        out = torch.empty(lay.shape, dtype=first.dtype, device=device)
        for d, row in enumerate(grid):
            for m, tree in enumerate(row):
                out[lay.index(d, m, sizes)] = tree_at(tree, path).detach() \
                    .to(device)
        return out
    return tree_map(whole, grid[0][0])


class GatheredLeaf:
    """A stored leaf as device (d, m) (mesh index ``reader``) computes
    with it: its blocks over the FSDP axes joined on that device
    (``collectives.Gather``, differentiably: each block's gradient flows
    back to it, summed over the readers, the reduce-scatter), its own
    block (``blocks[own]``) where the leaf is not cut over them. Indexing
    gathers one period of a stacked leaf (only that period's slices move,
    inside the checkpointed region that reads it); ``whole()`` gathers it
    all. ``periods``: a dict the devices of one step share, in which each
    block's period is sliced once for all its readers (one slice, and in
    the backward one slice's gradient, per block and period, not per
    reader; the readers' gradients meet in it). On ``meta`` a shared
    ``periods`` also joins each gather once for all its readers
    (``collectives.MetaJoin``/``MetaRead``: the same counts and copies,
    O(devices) ops where a gather per reader is O(devices^2))."""

    def __init__(self, blocks: list, dim, device, reader: int = 0,
                 own: int = 0, periods: dict | None = None):
        self.blocks, self.dim, self.device = blocks, dim, device
        self.reader, self.own, self.periods = reader, own, periods

    def _period(self, b: torch.Tensor, i: int) -> torch.Tensor:
        if self.periods is None:
            return b[i]
        key = (id(b), i)
        if key not in self.periods:
            self.periods[key] = (b, b[i])   # b kept: its id stays its own
        return self.periods[key][1]

    def _join(self, blocks: list, dim: int) -> torch.Tensor:
        own = collectives.nbytes(blocks[self.own])
        if self.periods is None or blocks[0].device.type != "meta":
            return collectives.Gather.apply(dim, self.device, self.reader,
                                            own, *blocks)
        key = ("join", dim, *map(id, blocks))
        if key not in self.periods:
            self.periods[key] = (blocks, collectives.MetaJoin.apply(
                dim, *blocks))
        return collectives.MetaRead.apply(self.periods[key][1], self.device,
                                          self.reader, own, len(blocks))

    def whole(self) -> torch.Tensor:
        if self.dim is None:
            return self.blocks[0].to(self.device)
        return self._join(self.blocks, self.dim)

    def __getitem__(self, i: int) -> torch.Tensor:
        if self.dim is None:
            return self._period(self.blocks[0], i).to(self.device)
        if self.dim == 0:
            for k, b in enumerate(self.blocks):
                if i < b.shape[0]:
                    piece = b[i]
                    if k != self.own:
                        collectives.note("all-gather", (self.reader,),
                                         collectives.nbytes(piece), 2)
                    return piece.to(self.device)
                i -= b.shape[0]
            raise IndexError(i)
        return self._join([self._period(b, i) for b in self.blocks],
                          self.dim - 1)


class GatheredQuantized:
    """A stored QuantizedTensor as one device computes with it: its codes
    and scale each a ``GatheredLeaf``; indexing and ``whole()`` give
    QuantizedTensors."""

    def __init__(self, codes: GatheredLeaf, scale: GatheredLeaf, scheme: str,
                 packed: bool):
        self.codes, self.scale = codes, scale
        self.scheme, self.packed = scheme, packed

    def whole(self) -> QuantizedTensor:
        return QuantizedTensor(self.codes.whole(), self.scale.whole(),
                               self.scheme, self.packed)

    def __getitem__(self, i: int) -> QuantizedTensor:
        return QuantizedTensor(self.codes[i], self.scale[i], self.scheme,
                               self.packed)


def whole(tree: Any) -> Any:
    """``tree`` (a leaf or a nest) with every ``GatheredLeaf`` (and
    ``GatheredQuantized``) gathered whole; tensors as they are."""
    return tree_map(lambda _, x: x.whole()
                    if isinstance(x, (GatheredLeaf, GatheredQuantized))
                    else x, tree)


def gathered_view(grid: list, layouts: dict, policy: ShardingPolicy, d: int,
                  m: int, device, periods: dict | None = None) -> Any:
    """The tree device (d, m) computes with, of ``GatheredLeaf``s over
    the blocks of ``grid`` (the train step's live params, or the serve
    steps' stored ones, whose QuantizedTensors give
    ``GatheredQuantized``s): under ``fsdp`` every leaf whole, under
    ``tp`` its model shard whole over the FSDP axes, under
    ``replicated`` its own block. ``periods``: the step's shared period
    slices (``GatheredLeaf``)."""
    sizes = policy.axes
    fsdp = set(policy.fsdp_axes)
    cols = sizes["model"]
    at = axis_coords(d, m, sizes)
    others = [(dd, mm) for dd in range(len(grid)) for mm in range(cols)]

    def gathered(lay, take):
        dim = next((i for i, e in enumerate(lay.spec)
                    if e is not None and fsdp & set(_axes_of(e))), None)
        if dim is None:
            return GatheredLeaf([take(d, m)], None, device, d * cols + m,
                                periods=periods)
        axes = _axes_of(lay.spec[dim])
        readers = [c for c in others
                   if all(a in axes or axis_coords(*c, sizes)[a] == at[a]
                          for a in at if a in sizes)]
        readers.sort(key=lambda c: lay.coord(axes, *c, sizes))
        return GatheredLeaf([take(*c) for c in readers], dim, device,
                            d * cols + m, readers.index((d, m)), periods)

    def leaf(path, x):
        if isinstance(x, QuantizedTensor):
            return GatheredQuantized(*(
                gathered(layouts[path + (name,)], lambda dd, mm, name=name:
                         getattr(tree_at(grid[dd][mm], path), name))
                for name in ("codes", "scale")), x.scheme, x.packed)
        return gathered(layouts[path],
                        lambda dd, mm: tree_at(grid[dd][mm], path))
    return tree_map(leaf, grid[0][0])


def reduce_copies(grads: list, layouts: dict, mesh, live=None) -> list:
    """The gradients of every device's blocks (``grads[d][m]``, trees with
    None where a block was not read) made equal over the devices holding
    the same block: summed in device order (row-major) and handed to each
    of them (the all-reduce of a replicated leaf, a copy over an axis:
    across pods, the cross-pod all-reduce). Returns the grid of gradient
    trees. ``live`` (``Runtime.live``): only those devices' gradients
    exist (None elsewhere in ``grads`` and in the result), each sum takes
    theirs and is counted on them, as large as its whole group."""
    sizes = mesh.shape
    cols = sizes["model"]
    devs = [(d, m, dev) for d, row in enumerate(mesh.grid)
            for m, dev in enumerate(row)
            if live is None or d * cols + m in live]
    out = [[None] * len(row) for row in mesh.grid]
    paths: list = []
    tree_map(lambda path, _: paths.append(path), grads[devs[0][0]][devs[0][1]])
    sums: dict = {}
    for path in paths:
        lay = layouts[path]
        groups: dict = {}
        for d, row in enumerate(mesh.grid):
            for m in range(len(row)):
                groups.setdefault(lay.block_key(d, m, sizes), []).append(
                    (d, m))
        for members in groups.values():
            ids = [d * cols + m for d, m in members]
            mine = [(d, m) for d, m in members
                    if live is None or d * cols + m in live]
            if not mine:
                continue
            parts = [g for g in (tree_at(grads[d][m], path)
                                 for d, m in mine) if g is not None]
            total = (collectives.all_reduce(parts, ids, live=live) if parts
                     else None)
            for d, m in mine:
                sums[d, m, path] = total
    for d, m, dev in devs:
        def leaf(path, x, d=d, m=m, dev=dev):
            g = sums[d, m, path]
            return None if g is None else g.to(dev)
        out[d][m] = tree_map(leaf, grads[d][m])
    return out


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

def shard_dense_caches(caches: Any, specs: dict, mesh) -> list:
    """The dense serving caches cut over a ``HostMesh`` by ``specs``
    (``ShardingPolicy.cache_specs`` of the whole caches):
    ``grid[d][m]``, a copy of row ``d``, model shard ``m``'s block of
    every leaf, on its device."""
    sizes = mesh.shape
    return [[tree_map(lambda path, x: _copy_to(x[spec_layout(
        specs[path], tuple(x.shape), sizes).index(d, m, sizes)], dev),
        caches)
        for m, dev in enumerate(row)] for d, row in enumerate(mesh.grid)]


def gather_dense_caches(grid: list, specs: dict, device="cpu",
                        sizes: dict | None = None) -> Any:
    """``shard_dense_caches``'s inverse: every leaf reassembled on
    ``device`` from the blocks of ``grid`` (a mesh of axis ``sizes``, by
    default ``data`` x ``model`` of the grid's rows and shards), each
    block written where its spec puts it (a copy from its last device,
    all copies equal)."""
    sizes = sizes or {"data": len(grid), "model": len(grid[0])}

    def whole(path, first):
        spec = specs[path]
        shape = list(first.shape)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            # the blocks along the cut, one per coordinate on its axes
            # (uneven where the devices do not divide the dim)
            along = {}
            for d, row in enumerate(grid):
                for m, tree in enumerate(row):
                    at = axis_coords(d, m, sizes)
                    along[tuple(at[a] for a in _axes_of(entry))] = \
                        tree_at(tree, path).shape[dim]
            shape[dim] = sum(along.values())
        lay = spec_layout(spec, tuple(shape), sizes)
        out = torch.empty(shape, dtype=first.dtype, device=device)
        for d, row in enumerate(grid):
            for m, tree in enumerate(row):
                out[lay.index(d, m, sizes)] = tree_at(tree, path).to(device)
        return out
    return tree_map(whole, grid[0][0])

