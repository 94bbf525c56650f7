"""The dry run: every (architecture x input-shape) cell's step built and
run on ``meta`` tensors over the production meshes (16 x 16 ``(data,
model)``; 2 x 16 x 16 ``(pod, data, model)``), and a report per cell of
what each device would hold, compute and move. Nothing is placed and no
card is needed.

The reference (``repro.launch.dryrun``) lowers and compiles each cell's
step and reads XLA's analyses. The port runs ``launch.steps.build_step``'s
step once on meta tensors, where every op computes shapes only, and
reads its counterparts (``dry_report``'s fields):

- ``memory``: per device (the largest, with its coordinates) the bytes
  of its blocks of params, optimizer state, caches and batch rows, from
  the step's ``Layout``s and specs (``argument_bytes``), what the step
  returns (``output_bytes``) and updates in place (``alias_bytes``); the
  peak of live meta storage over the whole step, every device together
  (``mesh_peak_bytes``: each storage once); ``temp_bytes`` the mean per
  device of that peak over the arguments (one process runs every device
  in turn, so a transient belongs to no one device: ``temp_is_mean``);
  ``peak_per_device_bytes`` the reference's argument + temp + output -
  alias.
- ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the
  step, per device (the total over the device count) and in total.
- ``collectives``: ``repro_torch.collectives``' counts, by kind, of the
  busiest device and the mean over the mesh.
- ``departures``: the stored leaves whose bytes on the largest device
  differ from the reference's spec (padded where a cut does not divide),
  and ``uneven``: the leaves whose blocks differ in size.

The registry resolves ``impl="auto"`` to the plain versions on meta, as
the reference's dry run builds its steps with ``impl="ref"``: no CUDA
kernel is on this path.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
      --shape decode_32k [--multi-pod | --both-meshes]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
Artifacts: ``build/dryrun/dryrun_<arch>_<shape>_<single|multi>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

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

__all__ = ["dry_report", "run_cell", "main", "ARTIFACT_DIR", "LiveBytes"]

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun")


class LiveBytes(TorchDispatchMode):
    """The bytes of live storage while it is active: every storage an op
    returns (and those ``track``ed before) counted once, until it is
    freed (a finalizer on the storage). ``peak``: the most at once."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen: set = set()

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
        out = func(*args, **(kwargs or {}))
        for t in _pytree_leaves(out):
            self.track(t)
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


def _spec_bytes(specs: dict, tree, sizes: dict, rows: int) -> list:
    """``_leaf_bytes`` of a tree laid out by specs ({path: spec})."""
    lays = {}
    tree_map(lambda path, x: lays.__setitem__(
        path, spec_layout(specs[path], tuple(x.shape), sizes)), tree)
    return _leaf_bytes(lays, tree, sizes, rows)


def _batch_bytes(tree, policy, sizes: dict, rows: int) -> list:
    """Each device's rows of the batch leaves (dim 0 cut over the batch
    axes the policy gives them, the reference's ``batch_spec``)."""
    specs = {}
    tree_map(lambda path, x: specs.__setitem__(
        path, (policy._batch_axes(x.shape[0]),) + (None,) * (x.dim() - 1)
        if x.dim() else ()), tree)
    return _spec_bytes(specs, tree, sizes, rows)


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

def _collective_summary(n_devices: int) -> dict:
    """The busiest device's counts by kind (the most bytes), with its
    index, and the mean over the mesh's devices."""
    counts = collectives.counts()
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


def dry_report(cfg: ArchConfig, shape: ShapeConfig, mesh, *, params=None,
               batch=None, param_dtype=None, **kw) -> dict:
    """Build ``cfg``'s step at ``shape`` over ``mesh`` (a ``HostMesh`` on
    ``meta``: ``launch.mesh.make_production_mesh``, or any small one) with
    ``build_step``'s knobs ``kw``, run it once on meta inputs, and report
    (the module docstring has the fields; ``argument_by_device`` gives
    every device's params, state, caches and batch bytes). The weights
    are made in ``param_dtype`` (by default the train step's ``dtype``, or
    bf16 for a serve step, as the reference's). A train step on a mesh of
    real devices takes real ``params`` and ``batch`` instead, and reports
    its ``metrics`` too."""
    sizes, rows = mesh.shape, len(mesh.grid)
    n_dev = len(mesh.devices)
    t0 = time.monotonic()
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
        args = (grid, ostate, batch)
        whole_opt = _opt_meta(bundle, params)
        parts["params"] = _leaf_bytes(bundle.specs["params"], params,
                                      sizes, rows)
        parts["opt_state"] = _leaf_bytes(bundle.specs["opt"], whole_opt,
                                         sizes, rows)
        parts["batch"] = _batch_bytes(batch, policy, sizes, rows)
        stored = [(bundle.specs["params"], params, ()),
                  (bundle.specs["opt"], whole_opt, ("mu", "nu", "m", "v",
                                                    "ef"))]
        cache_lays = None
    else:
        inputs = _serve_inputs(cfg, shape, dtype)
        qparams = (quantize_params(params, SERVE_SCHEME)
                   if bundle.meta["quantized"] else params)
        placed = bundle.place(qparams, *inputs)
        caches = bundle.init_caches("meta")
        args = (*placed, caches)
        parts["params"] = _leaf_bytes(bundle.layouts, qparams, sizes, rows)
        whole_c = (ed.encdec_init_caches if cfg.enc_dec
                   else lm_mod.init_caches)(
            cfg, shape.global_batch, shape.seq_len,
            dtype=kw.get("dtype", torch.bfloat16),
            kv_quant=kw.get("kv_quant", False), device="meta")
        parts["caches"] = _spec_bytes(bundle.specs, whole_c, sizes, rows)
        cache_lays = ({}, whole_c)
        tree_map(lambda path, x: cache_lays[0].__setitem__(
            path, spec_layout(bundle.specs[path], tuple(x.shape), sizes)),
            whole_c)
        parts["batch"] = _batch_bytes(
            {str(i): t for i, t in enumerate(inputs)}, policy, sizes, rows)
        stored = [(bundle.layouts, qparams, ())]
    build_s = time.monotonic() - t0

    live = LiveBytes()
    live.track_tree(args)
    start = live.live
    collectives.reset_counts()
    t0 = time.monotonic()
    with FlopCounterMode(display=False) as flops, live:
        out = bundle.fn(*args)
        flop_total = flops.get_total_flops()
    run_s = time.monotonic() - t0
    coll = _collective_summary(n_dev)
    mesh_peak = live.peak

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
    temp = (mesh_peak - start) / n_dev
    leaves, departures, uneven = {}, [], []
    if cache_lays is not None:
        stored.append((*cache_lays, None))
    for lays, tree, strip in stored:
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
             extra_kw: dict | None = None) -> dict:
    """One (arch, shape) cell on a production mesh (``multi_pod``: 2 x 16
    x 16): its report written to ``artifact_dir`` as
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
    report = dry_report(cfg, shape, mesh, **(extra_kw or {}))
    n_chips = len(mesh.devices)
    result = {"arch": arch, "shape": shape_name,
              "mesh": "x".join(str(v) for v in mesh.shape.values()),
              "n_chips": n_chips, "status": "ok", **report,
              "host_max_rss_bytes": resource.getrusage(
                  resource.RUSAGE_SELF).ru_maxrss * 1024}
    if verbose:
        mem = result["memory"]
        print(f"[{arch} x {shape_name} x {result['mesh']}] "
              f"run={report['run_s']:.0f}s "
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
                               artifact_dir=args.artifact_dir)
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
