"""The dry run: every (architecture x input-shape) cell's step built and
run on ``meta`` tensors over the production meshes (16 x 16 ``(data,
model)``; 2 x 16 x 16 ``(pod, data, model)``), and a report per cell of
what each device would hold, compute and move. Nothing is placed and no
card is needed.

The reference (``repro.launch.dryrun``) lowers and compiles each cell's
step and reads XLA's analyses. The port runs ``launch.steps.build_step``'s
step on meta tensors, where every op computes shapes only, and reads its
counterparts (``dry_report``'s fields):

- ``memory``: per device (the largest, with its coordinates) the bytes
  of its blocks of params, optimizer state, caches and batch rows, from
  the step's ``Layout``s and specs (``argument_bytes``), what the step
  returns (``output_bytes``) and updates in place (``alias_bytes``); the
  peak of live meta storage over the whole step, every device together
  (``mesh_peak_bytes``: each storage once); ``temp_bytes`` the mean per
  device of that peak over the arguments (one process runs every device
  in turn, so a transient belongs to no one device: ``temp_is_mean``;
  ``temp_over`` says over which devices); ``peak_per_device_bytes`` the
  reference's argument + temp + output - alias.
- ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the
  step, per device (the total over the device count) and in total.
- ``collectives``: ``repro_torch.collectives``' counts, by kind, of the
  busiest device and the mean over the mesh.
- ``departures``: the stored leaves whose bytes on the largest device
  differ from the reference's spec (padded where a cut does not divide),
  and ``uneven``: the leaves whose blocks differ in size.

Every device runs in one process, so the all-devices run's cost grows
with the devices; the reference's XLA analyses one SPMD program. The
class path (``dry_report(classes=True)``, what ``run_cell`` and the CLI
run) puts the devices in symmetric classes (``device_classes``: the same
program on blocks of the same shapes) and runs each class's
representative alone (``Runtime.live``), folding the repeats of a train
step's microbatches and of its 8-bit optimizer's stacked slices; each
member takes its representative's counts and flops (under fsdp, where
all devices share each checkpointed region, also the recompute flops a
region's early stop skips for its last device only). Its report equals
the all-devices run's in every field but ``temp_bytes`` (then a
representative's, ``temp_over: "representative"``) and
``mesh_peak_bytes`` (None); ``classes`` lists what ran.

The registry resolves ``impl="auto"`` to the plain versions on meta, as
the reference's dry run builds its steps with ``impl="ref"``: no CUDA
kernel is on this path.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
      --shape decode_32k [--multi-pod | --both-meshes] [--all-devices]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
Artifacts: ``build/dryrun/dryrun_<arch>_<shape>_<single|multi>.json``.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import resource
import time
import traceback
import types
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.checkpoint import set_checkpoint_early_stop
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch import collectives
from repro_torch.configs import assigned_archs, get_config
from repro_torch.configs.base import LM_SHAPES, ArchConfig, ShapeConfig
from repro_torch.core.quantized import QuantizedTensor
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import SERVE_SCHEME, build_step
from repro_torch.models import encdec as ed
from repro_torch.models import lm as lm_mod
from repro_torch.nn.layers import quantize_params, tree_leaves, tree_map
from repro_torch.sharding import axis_coords, spec_layout
from repro_torch.training import make_optimizer

__all__ = ["dry_report", "run_cell", "main", "device_classes",
           "cell_classes", "ARTIFACT_DIR", "LiveBytes", "ShapeCache"]

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun")


class LiveBytes(TorchDispatchMode):
    """The bytes of live storage while it is active: every storage an op
    returns (and those ``track``ed before) counted once, until it is
    freed (a finalizer on the storage). ``peak``: the most at once.
    ``shapes``: a ``ShapeCache`` that answers the ops it can (entered
    above the flop counter, so an op it answers reaches no mode below:
    it answers none that counts flops)."""

    def __init__(self, shapes: "ShapeCache | None" = None):
        super().__init__()
        self.live = self.peak = 0
        self._seen: set = set()
        self.shapes = shapes

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def track(self, t) -> None:
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def track_tree(self, tree) -> None:
        for leaf in tree_leaves(tree):
            if isinstance(leaf, QuantizedTensor):
                self.track(leaf.codes)
                self.track(leaf.scale)
            else:
                self.track(leaf)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = (func(*args, **kwargs) if self.shapes is None
               else self.shapes(func, args, kwargs))
        for t in ((out,) if isinstance(out, torch.Tensor) else
                  _pytree_leaves(out)):
            self.track(t)
        return out


class _Uncached(Exception):
    pass


#: the non-tensor arguments ``ShapeCache`` keys an op by
_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)


def _meta_key(args) -> tuple:
    """What an op's outputs on ``meta`` follow from, of its arguments (a
    sequence): each tensor's shape, strides, dtype and offset, each
    scalar's type and value; raises ``_Uncached`` for anything else (a
    real tensor)."""
    key = []
    for x in args:
        if isinstance(x, torch.Tensor):
            if not x.is_meta:
                raise _Uncached
            key.append((x.shape, x.stride(), x.dtype, x.storage_offset()))
        elif isinstance(x, _SCALARS):
            key.append((type(x), x))
        elif isinstance(x, (list, tuple)):
            key.append((type(x), _meta_key(x)))
        else:
            raise _Uncached
    return tuple(key)


class ShapeCache:
    """The ops that count no flops (none of
    ``torch.utils.flop_counter.flop_registry``'s, none that decomposes
    into them) run below every dispatch mode, where the flop counter
    would count nothing. Of those, on ``meta``, one that returns new
    tensors (no output aliases an input, no argument is mutated) gives
    outputs whose shapes, strides, dtypes and storage sizes follow from
    its arguments' alone: seen again with the same ones, it gets new meta
    tensors of those without its meta kernel (Python for many ops: most
    of the dry run's time, the recurrent mixers' per-token loops above
    all). Called as ``cache(func, args, kwargs)`` in place of
    ``func(*args, **kwargs)`` by ``LiveBytes`` above the flop counter;
    ``hits`` / ``misses`` count the ops it answered and the ones it ran
    and kept."""

    def __init__(self):
        self.cache: dict = {}
        self.kinds: dict = {}
        self.hits = self.misses = 0

    def _kind(self, func) -> tuple:
        """(counts no flops, also returns only new tensors) of an op."""
        kind = self.kinds.get(func)
        if kind is None:
            schema = func._schema
            plain = (func._overloadpacket not in flop_registry
                     and not torch._C._dispatch_has_kernel_for_dispatch_key(
                         func.name(), "CompositeImplicitAutograd"))
            kind = self.kinds[func] = (plain, plain and (
                not schema.is_mutable and bool(schema.returns)
                and all(r.alias_info is None and str(r.type) == "Tensor"
                        for r in schema.returns)))
        return kind

    def __call__(self, func, args, kwargs):
        plain, pure = self._kind(func)
        if not plain:
            return func(*args, **kwargs)
        key = None
        if pure:
            try:
                key = (func, _meta_key(args), _meta_key(
                    kwargs.items()) if kwargs else ())
            except _Uncached:
                key = None
        one = len(func._schema.returns) == 1
        spec = self.cache.get(key) if key is not None else None
        with torch._C._DisableTorchDispatch():
            if spec is not None:
                self.hits += 1
                outs = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                                 device="meta")
                             for shape, stride, dtype in spec)
                return outs[0] if one else outs
            out = func(*args, **kwargs)
        if key is None:
            return out
        spec = []
        for o in ((out,) if one else out):
            # a real tensor, or an output that is not a whole new storage,
            # is not kept
            if o.device.type != "meta" or o.storage_offset():
                return out
            with torch._C._DisableTorchDispatch():
                probe = torch.empty_strided(o.shape, o.stride(),
                                            dtype=o.dtype, device="meta")
            if probe.untyped_storage().nbytes() != \
                    o.untyped_storage().nbytes():
                return out
            spec.append((tuple(o.shape), o.stride(), o.dtype))
        self.misses += 1
        self.cache[key] = tuple(spec)
        return out


# -- the step's inputs on meta --------------------------------------------------

def _init(cfg: ArchConfig, dtype):
    init = ed.encdec_init if cfg.enc_dec else lm_mod.lm_init
    return init(torch.Generator(), cfg, dtype=dtype, device="meta")


def _batch(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The reference's train batch (``_batch_sds``) on meta."""
    b, s = shape.global_batch, shape.seq_len
    out = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
           for k in ("tokens", "labels")}
    if cfg.mrope_sections is not None:
        out["positions"] = torch.empty((b, 3, s), dtype=torch.int32,
                                       device="meta")
    if cfg.enc_dec:
        out["frames"] = torch.empty((b, cfg.enc_seq_len, cfg.d_model),
                                    dtype=torch.bfloat16, device="meta")
    return out


def _serve_inputs(cfg: ArchConfig, shape: ShapeConfig, dtype) -> tuple:
    """The serve step's inputs after the weights, on meta, as the
    reference's: (frames,) tokens for a prefill, (token, pos) for a
    decode; the frames in ``dtype`` (the step's: bf16 as the
    reference's)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return (torch.empty((b,), dtype=torch.int32, device="meta"),
                torch.empty((), dtype=torch.int32, device="meta"))
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    if cfg.enc_dec:
        return (torch.empty((b, cfg.enc_seq_len, cfg.d_model),
                            dtype=dtype, device="meta"), tokens)
    return (tokens,)


# -- per-device bytes from the layouts ----------------------------------------

def _leaf_bytes(layouts: dict, tree, sizes: dict, rows: int) -> list:
    """[[bytes of device (d, m)'s blocks of ``tree``'s leaves]]: each
    leaf by its ``Layout`` in ``layouts`` (a QuantizedTensor's codes and
    scale by their own)."""
    cols = sizes["model"]
    out = [[0] * cols for _ in range(rows)]

    def add(lay, t):
        for d in range(rows):
            for m in range(cols):
                out[d][m] += lay.block_bytes(d, m, sizes, t.element_size())

    def leaf(path, x):
        if isinstance(x, QuantizedTensor):
            add(layouts[path + ("codes",)], x.codes)
            add(layouts[path + ("scale",)], x.scale)
        elif isinstance(x, torch.Tensor):
            add(layouts[path], x)
    tree_map(leaf, tree)
    return out


def _batch_layouts(tree, policy, sizes: dict) -> dict:
    """{path: Layout} of the batch leaves: dim 0 cut over the batch axes
    the policy gives them (the reference's ``batch_spec``)."""
    out = {}
    tree_map(lambda path, x: out.__setitem__(path, spec_layout(
        (policy._batch_axes(x.shape[0]),) + (None,) * (x.dim() - 1)
        if x.dim() else (), tuple(x.shape), sizes)), tree)
    return out


def _plus(*grids) -> list:
    return [[sum(v) for v in zip(*rows)] for rows in zip(*grids)]


def _reference_bytes(policy, keys: list, shape: tuple, itemsize: int,
                     sizes: dict) -> int:
    """One device's bytes of a stored leaf under the reference's spec
    (``_ref_spec``), each cut padded up where it does not divide (XLA's
    padding)."""
    n = itemsize
    for size, entry in zip(shape, policy._ref_spec(keys, shape)):
        k = 1
        for a in (entry if isinstance(entry, tuple) else
                  (entry,) if entry is not None else ()):
            k *= sizes[a]
        n *= -(-size // k)
    return n


def _stored_leaves(policy, layouts: dict, tree, sizes: dict, d: int,
                   m: int, strip=None) -> tuple:
    """({leaf: its bytes on device (d, m)}, the leaves whose bytes there
    differ from the reference's spec, the leaves whose blocks differ in
    size over the mesh). ``strip``: the key names the reference's rule
    ignores (an optimizer state's moments); None: no reference spec (the
    caches, whose ``cache_spec`` is the reference's)."""
    rows = sizes.get("pod", 1) * sizes["data"]
    by_leaf, differ, uneven = {}, [], []

    def one(path, t):
        lay = layouts[path]
        got = lay.block_bytes(d, m, sizes, t.element_size())
        name = "/".join(map(str, path))
        by_leaf[name] = got
        if strip is None:
            return
        # no rule of the reference's reads "codes", "scale" or a moment's
        # name: the stored leaf's spec is its param's rule on its shape
        keys = [str(k) for k in path if str(k) not in strip]
        want = _reference_bytes(policy, keys, tuple(t.shape),
                                t.element_size(), sizes)
        if got != want:
            differ.append({"leaf": name, "bytes": got,
                           "reference_bytes": want})
        shapes = {lay.block_shape(dd, mm, sizes) for dd in range(rows)
                  for mm in range(sizes["model"])}
        if len(shapes) > 1:
            uneven.append(name)

    def leaf(path, x):
        if isinstance(x, QuantizedTensor):
            one(path + ("codes",), x.codes)
            one(path + ("scale",), x.scale)
        elif isinstance(x, torch.Tensor):
            one(path, x)
    tree_map(leaf, tree)
    return by_leaf, differ, uneven


# -- the report ----------------------------------------------------------------

def _collective_summary(counts: dict, n_devices: int) -> dict:
    """The busiest device's counts by kind (the most bytes), with its
    index, and the mean over the mesh's devices, from ``counts``
    (``collectives.counts()``'s form)."""
    total = {}
    for kinds in counts.values():
        for kind, c in kinds.items():
            t = total.setdefault(kind, {"ops": 0, "bytes": 0})
            t["ops"] += c["ops"]
            t["bytes"] += c["bytes"]
    busiest = max(counts, default=None, key=lambda dev: sum(
        c["bytes"] for c in counts[dev].values()))
    return {"busiest_device": busiest,
            "busiest": counts.get(busiest, {}),
            "mean": {kind: {"ops": t["ops"] / n_devices,
                            "bytes": t["bytes"] / n_devices}
                     for kind, t in sorted(total.items())},
            "by_device": counts}


def device_classes(bundle, cfg: ArchConfig, mesh, layouts: list,
                   batch_rows: int) -> list:
    """The mesh's devices in symmetric classes: a list of classes, each a
    list of units (tuples of mesh device indices, their places aligned),
    the first the class's representative, in the order of their first
    device. A unit is one device under the train step's fsdp (every
    device runs its own rows), else one row (its model shards run
    tensor-parallel together). Two units share a class when, place by
    place, their devices hold blocks of equal shapes of every leaf of
    ``layouts`` (a list of {path: Layout}: params, optimizer state or
    stored weights, caches, the batch's rows), each block held by as many
    devices, and the rules keyed on a coordinate give them the same work:
    the rows of a ``batch_rows``-row (micro)batch each device runs
    (``lm.loss_rows``: under tp none on a row outside the first group
    where the rows do not split over the groups; under fsdp all on the
    first device where they do not split over the devices), and under
    fsdp whether the device runs the rows' MoE (the first device,
    ``stack_apply_rows``). Within a row the shards keep their places, so
    a row's head groups, uneven cuts and experts, and the
    context-parallel prefill's first-shard rule, are the representative
    row's. Raises where a device is in no class or in two."""
    sizes, cols = mesh.shape, mesh.shape["model"]
    coords = [(d, m) for d in range(len(mesh.grid)) for m in range(cols)]
    keys: list = [[] for _ in coords]
    for lays in layouts:
        for lay in lays.values():
            held = [lay.block_key(d, m, sizes) for d, m in coords]
            copies = Counter(held)
            for k, (d, m) in enumerate(coords):
                keys[k].append((lay.block_shape(d, m, sizes),
                                copies[held[k]]))
    meta = bundle.meta
    if meta["kind"] == "train":
        rows = lm_mod.loss_rows(mesh, bundle.rt.data_axes, batch_rows)
        moe = meta["parallelism"] == "fsdp" and any(
            "moe" in slot.split("+") for slot in cfg.pattern)
        for k in range(len(coords)):
            sl = rows.get(k)
            keys[k].append(("rows", 0 if sl is None else sl.stop - sl.start,
                            "moe", moe and k == 0))
    if meta["kind"] == "train" and meta["parallelism"] == "fsdp":
        units = [(k,) for k in range(len(coords))]
    else:
        units = [tuple(range(d * cols, (d + 1) * cols))
                 for d in range(len(mesh.grid))]
    groups: dict = {}
    for unit in units:
        key = tuple(tuple(keys[k]) for k in unit)
        groups.setdefault(key, []).append(unit)
    classes = sorted(groups.values(), key=lambda us: us[0][0])
    placed = sorted(k for us in classes for u in us for k in u)
    if placed != list(range(len(coords))):
        raise RuntimeError(f"the classes hold devices {placed}, not each of "
                           f"the mesh's {len(coords)} once")
    return classes


def _fold(live: LiveBytes, total_flops, folded: list, times: int,
          body) -> None:
    """The train step's ``fold``: ``body`` (a microbatch, or a stacked
    slice of the 8-bit optimizer's update) run once for ``times`` repeats
    of the same program on blocks of the same shapes. Its flops (into
    ``folded[0]``) and moves (``collectives.repeat``) count ``times``
    times; what it leaves live (a microbatch's loss and metrics) is left
    ``times`` times, and each repeat's peak of live storage stands on
    what the repeats before it left: the last one's is the run's."""
    f0, c0, l0, p0 = total_flops(), collectives.counts(), live.live, \
        live.peak
    live.peak = live.live
    body()
    folded[0] += (times - 1) * (total_flops() - f0)
    collectives.repeat(c0, times)
    left = live.live - l0
    live.peak = max(p0, live.peak + (times - 1) * max(left, 0))
    live.live += (times - 1) * left


def _measure(bundle, args, live, fold: bool, early_stop: bool = True):
    """One run of ``bundle.fn`` on ``args`` (``live``: the class path's
    representative, its train step folded where ``fold``): (its output,
    its flops, its ``LiveBytes``, the live bytes of the arguments),
    the collective counters read by the caller."""
    mode = LiveBytes(ShapeCache())
    mode.track_tree(args)
    start = mode.live
    collectives.reset_counts()
    step_kw: dict = {}
    folded = [0]
    if live is not None:
        step_kw["live"] = live
        if fold and bundle.meta["kind"] == "train":
            step_kw["fold"] = functools.partial(
                _fold, mode, lambda: flops.get_total_flops(), folded)
    with set_checkpoint_early_stop(early_stop), \
            FlopCounterMode(display=False) as flops, mode:
        out = bundle.fn(*args, **step_kw)
        total = flops.get_total_flops() + folded[0]
    return out, total, mode, start


def _expand(counts: dict, classes: list) -> dict:
    """Each class representative's collective counts (``counts``, one
    dict per class) given to every member of its class, place by place:
    {device: {kind: {"ops", "bytes"}}} over the whole mesh, devices that
    moved nothing left out. Raises where a run counted a move on a
    device that is not its representative's."""
    out = {}
    for got, units in zip(counts, classes):
        rep = units[0]
        stray = sorted(set(got) - set(rep))
        if stray:
            raise RuntimeError(f"moves counted on devices {stray} outside "
                               f"the representative {list(rep)}")
        for unit in units:
            for r, k in zip(rep, unit):
                if r in got:
                    out[k] = {kind: dict(c) for kind, c in got[r].items()}
    return dict(sorted(out.items()))


def _prepare(cfg: ArchConfig, shape: ShapeConfig, mesh, params, batch,
             param_dtype, kw: dict) -> types.SimpleNamespace:
    """A cell's step built over ``mesh`` and its inputs placed: ``bundle``,
    ``policy``, ``args`` (what ``bundle.fn`` takes), ``parts`` (each
    device's bytes of params, optimizer state or caches, and batch),
    ``stored`` ((layouts, whole tree, the keys the reference's rule
    strips) of every stored tree, for ``_stored_leaves``), ``held`` (the
    layouts of every leaf a device holds, for ``device_classes``) and
    ``batch_rows`` (the rows of one microbatch)."""
    sizes, rows = mesh.shape, len(mesh.grid)
    bundle = build_step(cfg, shape, mesh, **kw)
    policy = bundle.policy
    dtype = torch.float32 if kw.get("dtype") == torch.float32 \
        else torch.bfloat16
    if params is None:
        params = _init(cfg, param_dtype or (
            dtype if shape.kind == "train" else torch.bfloat16))
    parts: dict = {}
    if shape.kind == "train":
        batch = _batch(cfg, shape) if batch is None else batch
        grid, ostate = bundle.place(params)
        whole_opt = _opt_meta(bundle, params)
        batch_lays = _batch_layouts(batch, policy, sizes)
        parts["params"] = _leaf_bytes(bundle.specs["params"], params,
                                      sizes, rows)
        parts["opt_state"] = _leaf_bytes(bundle.specs["opt"], whole_opt,
                                         sizes, rows)
        parts["batch"] = _leaf_bytes(batch_lays, batch, sizes, rows)
        return types.SimpleNamespace(
            bundle=bundle, policy=policy, args=(grid, ostate, batch),
            parts=parts,
            stored=[(bundle.specs["params"], params, ()),
                    (bundle.specs["opt"], whole_opt, ("mu", "nu", "m", "v",
                                                      "ef"))],
            held=[bundle.specs["params"], bundle.specs["opt"], batch_lays],
            batch_rows=shape.global_batch // bundle.meta["accum_steps"])
    inputs = _serve_inputs(cfg, shape, dtype)
    qparams = (quantize_params(params, SERVE_SCHEME)
               if bundle.meta["quantized"] else params)
    placed = bundle.place(qparams, *inputs)
    whole_c = (ed.encdec_init_caches if cfg.enc_dec
               else lm_mod.init_caches)(
        cfg, shape.global_batch, shape.seq_len,
        dtype=kw.get("dtype", torch.bfloat16),
        kv_quant=kw.get("kv_quant", False), device="meta")
    cache_lays = {}
    tree_map(lambda path, x: cache_lays.__setitem__(
        path, spec_layout(bundle.specs[path], tuple(x.shape), sizes)),
        whole_c)
    named = {str(i): t for i, t in enumerate(inputs)}
    batch_lays = _batch_layouts(named, policy, sizes)
    parts["params"] = _leaf_bytes(bundle.layouts, qparams, sizes, rows)
    parts["caches"] = _leaf_bytes(cache_lays, whole_c, sizes, rows)
    parts["batch"] = _leaf_bytes(batch_lays, named, sizes, rows)
    return types.SimpleNamespace(
        bundle=bundle, policy=policy,
        args=(*placed, bundle.init_caches("meta")), parts=parts,
        stored=[(bundle.layouts, qparams, ()), (cache_lays, whole_c, None)],
        held=[bundle.layouts, cache_lays, batch_lays],
        batch_rows=shape.global_batch)


def cell_classes(cfg: ArchConfig, shape: ShapeConfig, mesh, **kw) -> tuple:
    """(``device_classes`` of the cell's step over ``mesh`` with
    ``build_step``'s knobs ``kw``, the layouts they were keyed on)."""
    cell = _prepare(cfg, shape, mesh, None, None, None, kw)
    return (device_classes(cell.bundle, cfg, mesh, cell.held,
                           cell.batch_rows), cell.held)


def dry_report(cfg: ArchConfig, shape: ShapeConfig, mesh, *, params=None,
               batch=None, param_dtype=None, classes: bool = False,
               fold: bool = True, **kw) -> dict:
    """Build ``cfg``'s step at ``shape`` over ``mesh`` (a ``HostMesh`` on
    ``meta``: ``launch.mesh.make_production_mesh``, or any small one) with
    ``build_step``'s knobs ``kw``, run it once on meta inputs, and report
    (the module docstring has the fields; ``argument_by_device`` gives
    every device's params, state, caches and batch bytes). The weights
    are made in ``param_dtype`` (by default the train step's ``dtype``, or
    bf16 for a serve step, as the reference's). A train step on a mesh of
    real devices takes real ``params`` and ``batch`` instead, and reports
    its ``metrics`` too.

    ``classes`` (``meta`` only; raises otherwise): the class path. The
    devices fall into symmetric classes (``device_classes``) and the step
    runs once per class on its representative alone (``Runtime.live``):
    each member of a class is given its representative's collective
    counts, and ``cost`` sums each class's flops times its units. Every
    field equals the all-devices run's but the memory of the run:
    ``temp_bytes`` is then the largest, over the classes, of the peak of
    live storage over the arguments while a representative runs alone,
    per device of the representative (``temp_over: "representative"``),
    and ``mesh_peak_bytes`` is None (not measured). ``fold`` (the class
    path's train step): the microbatches after the first, and the 8-bit
    optimizer's stacked slices, run once for all their repeats
    (``_fold``), every number of the report unchanged."""
    sizes, rows = mesh.shape, len(mesh.grid)
    n_dev = len(mesh.devices)
    if classes and any(torch.device(d).type != "meta"
                       for d in mesh.devices):
        raise ValueError("the class path runs on meta only: a mesh of "
                         "real devices runs every device")
    t0 = time.monotonic()
    cell = _prepare(cfg, shape, mesh, params, batch, param_dtype, kw)
    bundle, policy, args, parts = cell.bundle, cell.policy, cell.args, \
        cell.parts
    # the all-devices run is one class, every device its one unit
    groups = (device_classes(bundle, cfg, mesh, cell.held, cell.batch_rows)
              if classes else [[tuple(range(n_dev))]])
    build_s = time.monotonic() - t0

    t0 = time.monotonic()
    # under fsdp every device's rows share each checkpointed region, whose
    # recompute (early stop, as the step runs on the card) skips the ops
    # after its last saved tensor: the last device's alone. A class run
    # alone skips its own, so it runs again with early stop off, and each
    # device but the last takes back its skipped flops
    regions = classes and bundle.meta.get("parallelism") == "fsdp"
    last = max(lm_mod.loss_rows(mesh, bundle.rt.data_axes,
                                cell.batch_rows)) if regions else None
    flop_total, counts, runs, out = 0, [], [], None
    for units in groups:
        t1 = time.monotonic()
        got, flop_class, live, start = _measure(bundle, args, units[0]
                                                if classes else None, fold)
        counts.append(collectives.counts())
        flop_total += flop_class * len(units)
        if regions:
            skipped = _measure(bundle, args, units[0], fold,
                               early_stop=False)[1] - flop_class
            flop_total += skipped * (len(units)
                                     - any(last in u for u in units))
        # the outputs of the first class (device 0's, which runs rows)
        out = got if out is None else out
        del got
        runs.append({"representative": list(units[0]),
                     "units": len(units),
                     "devices": len(units) * len(units[0]),
                     "flops": flop_class, "peak_bytes": live.peak,
                     "temp_bytes": (live.peak - start) / len(units[0]),
                     "run_s": time.monotonic() - t1})
    run_s = time.monotonic() - t0
    by_device = _expand(counts, groups) if classes else counts[0]
    coll = _collective_summary(by_device, n_dev)
    mesh_peak = None if classes else runs[0]["peak_bytes"]

    argument = _plus(*parts.values())
    d, m = max(((d, m) for d in range(rows) for m in range(sizes["model"])),
               key=lambda c: argument[c[0]][c[1]])
    real = {}
    if shape.kind == "train":
        metrics = out[2]
        out_b = sum(collectives.nbytes(t) for t in metrics.values())
        if not any(t.is_meta for t in metrics.values()):
            real["metrics"] = {k: float(t) for k, t in metrics.items()}
        alias = parts["params"][d][m] + parts["opt_state"][d][m]
        output = alias + out_b
    else:
        logits = out[0]
        n_rows = 1
        ax = policy._batch_axes(shape.global_batch)
        for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
            n_rows *= sizes[a]
        alias = parts["caches"][d][m]
        output = alias + collectives.nbytes(logits) // n_rows
    del out
    temp = max(r["temp_bytes"] for r in runs)
    leaves, departures, uneven = {}, [], []
    for lays, tree, strip in cell.stored:
        a, b, c = _stored_leaves(policy, lays, tree, sizes, d, m, strip)
        leaves.update(a)
        departures += b
        uneven += c
    where = axis_coords(d, m, sizes)
    return {
        "meta": bundle.meta,
        "mesh_shape": dict(sizes),
        "n_devices": n_dev,
        "memory": {
            "device": {a: where[a] for a in sizes},
            "argument_bytes": argument[d][m],
            "argument_parts": {k: v[d][m] for k, v in parts.items()},
            "output_bytes": output,
            "alias_bytes": alias,
            "temp_bytes": temp,
            "temp_is_mean": True,
            "temp_over": "representative" if classes else "mesh",
            "mesh_peak_bytes": mesh_peak,
            "mesh_argument_bytes": start,
            "peak_per_device_bytes": argument[d][m] + temp + output - alias,
        },
        "argument_by_device": {k: v for k, v in parts.items()},
        "argument_leaves": leaves,
        "cost": {"flops": flop_total / n_dev, "flops_total": flop_total,
                 "bytes": None, "transcendentals": None},
        "collectives": coll,
        "departures": departures,
        "uneven": sorted(set(uneven)),
        "classes": runs if classes else None,
        "model_flops_dense": 6 * cfg.param_count_estimate()
        * shape.global_batch * shape.seq_len,
        "model_flops_active": 6 * cfg.active_param_count_estimate()
        * shape.global_batch * shape.seq_len,
        "param_count": cfg.param_count_estimate(),
        "active_param_count": cfg.active_param_count_estimate(),
        "build_s": build_s,
        "run_s": run_s,
        **real,
    }


def _opt_meta(bundle, params):
    """The whole optimizer state of ``params`` (its leaves' shapes and
    dtypes, which ``specs["opt"]`` lays out)."""
    return make_optimizer(bundle.meta["optimizer"], lr=1e-4).init(params)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             artifact_dir: str, verbose: bool = True,
             extra_kw: dict | None = None, classes: bool = True) -> dict:
    """One (arch, shape) cell on a production mesh (``multi_pod``: 2 x 16
    x 16), by the class path (``classes``; False: every device runs):
    its report written to ``artifact_dir`` as
    ``dryrun_<arch>_<shape>_<single|multi>.json``; a shape the arch skips
    returns its status (``skipped(full-attention)``)."""
    cfg = get_config(arch)
    shape = next(s for s in LM_SHAPES if s.name == shape_name)
    skip = None
    for s, why in cfg.shapes():
        if s.name == shape_name:
            skip = why
    if skip:
        return {"arch": arch, "shape": shape_name, "status": skip}
    mesh = make_production_mesh(multi_pod=multi_pod)
    report = dry_report(cfg, shape, mesh, classes=classes,
                        **(extra_kw or {}))
    n_chips = len(mesh.devices)
    result = {"arch": arch, "shape": shape_name,
              "mesh": "x".join(str(v) for v in mesh.shape.values()),
              "n_chips": n_chips, "status": "ok", **report,
              "host_max_rss_bytes": resource.getrusage(
                  resource.RUSAGE_SELF).ru_maxrss * 1024}
    if verbose:
        mem = result["memory"]
        n_rep = (n_chips if report["classes"] is None else
                 sum(len(c["representative"]) for c in report["classes"]))
        print(f"[{arch} x {shape_name} x {result['mesh']}] "
              f"run={report['run_s']:.0f}s devices_run={n_rep} "
              f"peak/device={mem['peak_per_device_bytes'] / 1e9:.2f}GB "
              f"args/device={mem['argument_bytes'] / 1e9:.2f}GB "
              f"flops={report['cost']['flops']:.3e} coll_ops="
              f"{sum(c['ops'] for c in report['collectives']['busiest'].values())}",
              flush=True)
    fname = f"dryrun_{arch.replace('.', '_')}_{shape_name}" \
            f"_{'multi' if multi_pod else 'single'}.json"
    os.makedirs(artifact_dir, exist_ok=True)
    with open(os.path.join(artifact_dir, fname), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all-devices", action="store_true",
                    help="run every mesh device, not one per symmetric "
                         "class")
    ap.add_argument("--artifact-dir", default=os.path.abspath(ARTIFACT_DIR))
    args = ap.parse_args(argv)

    cells = []
    archs = assigned_archs() if (args.all or not args.arch) else [args.arch]
    for a in archs:
        for s, _ in get_config(a).shapes():
            if args.shape and s.name != args.shape:
                continue
            cells.append((a, s.name))
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for multi in meshes:
        for a, sname in cells:
            try:
                res = run_cell(a, sname, multi_pod=multi,
                               artifact_dir=args.artifact_dir,
                               classes=not args.all_devices)
                if res["status"] != "ok":
                    print(f"[{a} x {sname}] {res['status']}", flush=True)
            except Exception as e:
                traceback.print_exc()
                failures.append((a, sname, multi, str(e)[:200]))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"\nall {len(cells) * len(meshes)} cells ran OK")


if __name__ == "__main__":
    main()
