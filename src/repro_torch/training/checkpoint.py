"""Checkpointing with atomic commits, on the reference's on-disk layout
(``repro.training.checkpoint``), so a tree written by either package
restores in the other.

Layout: <dir>/step_<N>/
  manifest.json          step, leaf index (path -> file, shape, dtype), extra
  leaf_<i>.npy           one file per leaf
  _COMMITTED             written last; then the directory is renamed into
                         place from a temporary one

Leaves are ordered and named as JAX flattens a pytree: dict keys sorted,
list and tuple items by index, the path's keys joined by "/" (a
``(params, opt_state, ef)`` tuple gives "0/embed/table", "1/step", ...).
bf16 leaves are stored as f32 (numpy has no bf16) and cast back to the
template's dtype on restore; a Python int leaf (the optimizers' step) is
stored as an int32 scalar. numpy only.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_checkpoints"]

_COMMIT = "_COMMITTED"


def _flatten_with_paths(tree, prefix: tuple = ()) -> list:
    """[(path string, leaf)] in JAX's flattening order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten_with_paths(v, prefix + (i,))]
    return [("/".join(str(k) for k in prefix), tree)]


def _rebuild(template, values: dict, prefix: tuple = ()):
    """``template``'s structure with each leaf replaced by
    ``values[path]``."""
    if isinstance(template, dict):
        return {k: _rebuild(v, values, prefix + (k,))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, values, prefix + (i,))
                              for i, v in enumerate(template))
    return values["/".join(str(k) for k in prefix)]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name of the leaf)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if t.is_floating_point() and t.dtype not in (
                torch.float16, torch.float32, torch.float64):
            t = t.to(torch.float32)         # bf16, fp8: no numpy dtype
        return t.numpy(), name
    arr = np.asarray(leaf)
    if arr.dtype.kind in "iu" and arr.dtype.itemsize > 4:
        arr = arr.astype(np.int32)
    return arr, str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    extra: dict | None = None, keep: int = 3) -> str:
    """Write atomically; prune to the newest ``keep`` checkpoints."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step_{step}_")
    index = []
    try:
        for i, (path, leaf) in enumerate(_flatten_with_paths(tree)):
            arr, dtype = _to_numpy(leaf)
            fname = f"leaf_{i}.npy"
            np.save(os.path.join(tmp, fname), arr)
            index.append({"path": path, "file": fname,
                          "shape": list(arr.shape), "dtype": dtype})
        manifest = {"step": step, "index": index, "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, _COMMIT), "w") as f:
            f.write("ok")
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int):
    steps = list_checkpoints(ckpt_dir)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def list_checkpoints(ckpt_dir: str) -> list[int]:
    """Steps of the committed checkpoints in ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, _COMMIT)):
            out.append(int(name.split("_", 1)[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, template: Any, *,
                       step: int | None = None):
    """Restore into the structure of ``template``: each tensor leaf in its
    template's dtype and on its device, each int leaf an int. Raises on a
    missing or extra path and on a shape mismatch. Returns (tree, step,
    extra)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _flatten_with_paths(template)
    by_path = {e["path"]: e for e in manifest["index"]}
    paths = {p for p, _ in leaves}
    if paths != set(by_path):
        raise ValueError(
            f"checkpoint/template mismatch: missing="
            f"{sorted(paths - set(by_path))[:4]} "
            f"extra={sorted(set(by_path) - paths)[:4]}")
    values = {}
    for path, tmpl in leaves:
        arr = np.load(os.path.join(d, by_path[path]["file"]))
        if isinstance(tmpl, torch.Tensor):
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"shape mismatch at {path}: ckpt "
                                 f"{arr.shape} vs template "
                                 f"{tuple(tmpl.shape)}")
            values[path] = torch.from_numpy(np.array(arr)).to(
                device=tmpl.device, dtype=tmpl.dtype)
        elif arr.shape != ():
            raise ValueError(f"shape mismatch at {path}: ckpt {arr.shape} "
                             "vs a scalar template")
        else:
            values[path] = type(tmpl)(arr)
    return (_rebuild(template, values), manifest["step"],
            manifest.get("extra", {}))
