"""Carry a ``repro`` param pytree into the port's params.

The reference builds its weights with ``jax.random``, which torch cannot
reproduce, so the tests hand both packages the same weights by converting
the reference's pytree here. Everything crosses through numpy
(``np.asarray`` of each leaf), so this module imports neither JAX nor
``repro``: a reference ``QuantizedTensor`` is recognised by its fields.

* Nested dicts and lists keep their structure, so layer params keep their
  per-period stacking (leading P dim).
* Quantized leaves keep their ``uint8`` codes, f32 scale, ``scheme`` and
  ``packed`` flag bit for bit, so both engines serve identical quantized
  weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantized import QuantizedTensor

__all__ = ["params_from_reference"]

_QT_FIELDS = ("codes", "scale", "scheme", "packed")


def _tensor(a, dtype=None, device="cpu") -> torch.Tensor:
    arr = np.array(a, dtype=dtype)             # a writable host copy
    return torch.from_numpy(arr).to(device)


def params_from_reference(tree, device="cpu"):
    """The port's params for a reference param pytree (dicts, lists,
    arrays and QuantizedTensors), on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_reference(v, device) for v in tree]
    if all(hasattr(tree, f) for f in _QT_FIELDS):
        return QuantizedTensor(_tensor(tree.codes, np.uint8, device),
                               _tensor(tree.scale, np.float32, device),
                               str(tree.scheme), bool(tree.packed))
    return _tensor(tree, device=device)
