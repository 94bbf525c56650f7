"""The serve steps under a ``(data, model)`` mesh: the reference's
``repro.launch.steps`` for prefill and decode.

``build_serve_step`` wraps ``lm_prefill``/``lm_decode_step`` (or the
encoder-decoder's ``encdec_prefill``/``encdec_decode_step``) for a
``launch.mesh.HostMesh``. Where the reference hands jit ``in_shardings``
and ``out_shardings``, the port places real tensors: ``StepBundle.place``
quantizes the weights (``quantized``: the paper's sp2_4) and cuts them
per device (``ShardingPolicy.serving_cut`` per data group, or every leaf
whole under the ``replicated`` policy of the context-parallel prefill),
and ``init_caches`` lays the dense caches out by
``ShardingPolicy.cache_spec`` (sequence over ``model``, batch over
``data``). ``fn`` runs the step on those tensors: each data group takes
its rows of the batch, its model shards run the forward tensor-parallel,
or context-parallel (``prefill_cp``: queries sequence-sharded, K/V
gathered, the flash kernel's causal offset), and decode attends the
sequence-sharded cache shard by shard with one merge. The logits come
back as one (B, V) tensor on the mesh's first device.

Training under a mesh (``build_train_step``) is still to be ported
(ROADMAP.md, Queue 1 item 3).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import encdec as ed
from repro_torch.models import lm as lm_mod
from repro_torch.nn.layers import quantize_params
from repro_torch.runtime import Runtime
from repro_torch.sharding import (ShardingPolicy, gather_dense_caches,
                                  kv_seq_axis, shard_dense_caches,
                                  shard_params)

__all__ = ["StepBundle", "build_serve_step", "make_runtime", "SERVE_SCHEME"]

SERVE_SCHEME = "sp2_4"      # the paper's 4-bit SP2 for weight-only serving
#: the reference's ceiling for the context-parallel prefill's default
CP_MAX_PARAMS = 30e9


@dataclasses.dataclass
class StepBundle:
    """One serve step on a mesh. ``fn(*args)`` takes the placed arguments
    (``place``'s output; caches from ``init_caches`` or an earlier step)
    and returns (logits (B, V) on the mesh's first device, the caches,
    written in place). ``cache_specs``: the caches' layout, {path: spec}
    (``ShardingPolicy.cache_specs``); ``gather_caches`` reassembles their
    blocks into whole trees."""
    fn: Callable
    cache_specs: dict
    meta: dict
    rt: Runtime
    place: Callable
    init_caches: Callable
    gather_caches: Callable


def make_runtime(cfg: ArchConfig, mesh, shape: ShapeConfig | None, *,
                 impl: str = "auto", cache_specs: dict | None = None
                 ) -> Runtime:
    """The reference's ``make_runtime`` for a ``HostMesh``: the batch over
    data where it divides, and the dense caches' sequence cut where
    ``cache_specs`` (``ShardingPolicy.cache_specs`` of the caches the step
    runs against) cuts it (``decode_seq_axis``; without them the caches
    are whole on every shard, the reference's local decode)."""
    data_axes: tuple = ()
    if mesh is not None:
        data_axes = ("data",)
        if shape is not None and shape.global_batch % mesh.shape["data"]:
            data_axes = ()
    device = "cuda" if mesh is None else str(mesh.devices[0])
    return Runtime(impl=impl, q_chunk=1024, mesh=mesh, device=device,
                   decode_seq_axis=kv_seq_axis(cache_specs or {}),
                   data_axes=data_axes)


def _place_params(params, policy: ShardingPolicy, mesh, quantized: bool):
    """``grid[d][m]``: the param tree of every device, quantized first and
    then cut per data group (whole on every device under the
    ``replicated`` policy); rows over the same devices share one
    placement."""
    if quantized:
        params = quantize_params(params, SERVE_SCHEME)
    rows: dict = {}
    grid = []
    for d in range(mesh.shape["data"]):
        row = mesh.row(d)
        if row.devices not in rows:
            rows[row.devices] = shard_params(params, policy, row)
        grid.append(rows[row.devices])
    return grid


def build_serve_step(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
                     impl: str = "auto", quantized: bool = True,
                     kv_quant: bool = False, prefill_cp: bool | None = None,
                     dtype=torch.bfloat16) -> StepBundle:
    """A prefill or decode step (``shape.kind``) of ``cfg`` over ``mesh``
    (a ``HostMesh``) at ``shape.global_batch`` rows and a
    ``shape.seq_len``-token cache. ``prefill_cp`` None takes the
    reference's default: context-parallel for a prefill of at most
    CP_MAX_PARAMS params whose batch and length are multiples of 16,
    never for an encoder-decoder model; it runs only where the length
    divides the model axis (else the tensor-parallel prefill). ``dtype``:
    the dense caches' (bf16 as the reference's); ``kv_quant`` codes them
    (``Runtime.kv_scheme``'s default codebook)."""
    if shape.kind == "train":
        raise NotImplementedError(
            "build_train_step: training under a mesh (ROADMAP.md, Queue 1 "
            "item 3)")
    b, s = shape.global_batch, shape.seq_len
    m = mesh.shape["model"]
    if prefill_cp is None:
        prefill_cp = (shape.kind == "prefill"
                      and cfg.param_count_estimate() <= CP_MAX_PARAMS
                      and s % 16 == 0 and b % 16 == 0 and not cfg.enc_dec)
    cp = shape.kind == "prefill" and prefill_cp and s % m == 0
    policy = ShardingPolicy(cfg, mesh,
                            parallelism="replicated" if cp else "tp")
    init = ed.encdec_init_caches if cfg.enc_dec else lm_mod.init_caches
    c_specs = policy.cache_specs(init(cfg, b, s, dtype=dtype,
                                      kv_quant=kv_quant, device="meta"))
    rt = make_runtime(cfg, mesh, shape, impl=impl,
                      cache_specs=c_specs).replace(kv_quant=kv_quant,
                                                   attn_cp=cp)
    dev0 = mesh.devices[0]

    def place(params, *inputs):
        return (_place_params(params, policy, mesh, quantized),
                *(torch.as_tensor(t).to(dev0) for t in inputs))

    def init_caches():
        return shard_dense_caches(init(cfg, b, s, dtype=dtype,
                                       kv_quant=kv_quant, device="cpu"),
                                  c_specs, mesh)

    def gather_caches(grid, device="cpu"):
        return gather_dense_caches(grid, c_specs, device)

    meta = {"kind": shape.kind, "quantized": quantized,
            "kv_quant": kv_quant, "prefill_cp": prefill_cp,
            "context_parallel": cp, "parallelism": policy.parallelism,
            "decode_seq_axis": rt.decode_seq_axis,
            "data_axes": rt.data_axes}
    if shape.kind == "prefill":
        if cfg.enc_dec:
            def step(params, frames, tokens, caches):
                return ed.encdec_prefill(params, frames, tokens, caches,
                                         cfg, rt)
        else:
            def step(params, tokens, caches):
                return lm_mod.lm_prefill(params, tokens, caches, cfg, rt)
    else:
        mod = ed.encdec_decode_step if cfg.enc_dec else lm_mod.lm_decode_step

        def step(params, token, pos, caches):
            return mod(params, token, pos, caches, cfg, rt)

    return StepBundle(
        fn=torch.no_grad()(step), cache_specs=c_specs, meta=meta, rt=rt,
        place=place, init_caches=init_caches, gather_caches=gather_caches)
