"""The train and serve steps under a ``(data, model)`` mesh: the
reference's ``repro.launch.steps`` (``build_step`` dispatches on
``shape.kind``).

``build_serve_step`` wraps ``lm_prefill``/``lm_decode_step`` (or the
encoder-decoder's ``encdec_prefill``/``encdec_decode_step``) for a
``launch.mesh.HostMesh``. Where the reference hands jit ``in_shardings``
and ``out_shardings``, the port places real tensors: ``StepBundle.place``
quantizes the weights (``quantized``: the paper's sp2_4) and stores them
per device by the reference's ``make_policy`` (``ShardingPolicy.
stored_layouts``: the model axis on ``serving_cut``, above
``sharding.FSDP_ABOVE`` params each stored leaf also cut over the data
axes; every leaf whole under the ``replicated`` policy of the
context-parallel prefill), and ``init_caches`` lays the dense caches out
by ``ShardingPolicy.cache_spec`` (sequence over ``model``, batch over the
data axes). ``fn`` runs the step on those tensors: each device reads its
weights through ``sharding.gathered_view`` (a gather over the data axes
per period, where they are used), each data group takes its rows of the
batch, its model shards run the forward tensor-parallel, or
context-parallel (``prefill_cp``: queries sequence-sharded, K/V
gathered, the flash kernel's causal offset; a sequence whose length the
model axis does not divide whole on the first shard), and decode attends
the sequence-sharded cache shard by shard with one merge. The logits come
back as one (B, V) tensor on the mesh's first device.

``build_train_step`` is the reference's train step: FSDP or
tensor-parallel storage of the params and the optimizer state
(``sharding.param_specs``/``opt_specs``), each device computing with its
gathered weights, the sharded AdamW or AdamW-Q8 update, microbatches, and
the stack's remat (its docstring has the step).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import collectives
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import encdec as ed
from repro_torch.models import lm as lm_mod
from repro_torch.nn.layers import (quantize_params, tree_at, tree_leaves,
                                   tree_map)
from repro_torch.runtime import Runtime
from repro_torch.sharding import (ShardingPolicy, gather_blocks,
                                  gather_dense_caches, gathered_view,
                                  kv_seq_axis, make_policy, place_blocks,
                                  reduce_copies, shard_dense_caches)
from repro_torch.training.optimizer import make_optimizer

__all__ = ["StepBundle", "build_step", "build_train_step",
           "build_serve_step", "make_runtime", "SERVE_SCHEME",
           "GIANT_PARAMS"]

GIANT_PARAMS = 30e9    # above this: 8-bit AdamW moments, 8 microbatches

SERVE_SCHEME = "sp2_4"      # the paper's 4-bit SP2 for weight-only serving
#: the reference's ceiling for the context-parallel prefill's default
CP_MAX_PARAMS = 30e9


@dataclasses.dataclass
class StepBundle:
    """One step on a mesh. ``place`` cuts whole trees into the
    ``grid[d][m]`` blocks ``fn`` takes, by ``specs``; ``gather`` joins
    blocks back into whole trees. A serve step: ``fn(*args)`` takes
    ``place``'s output and the caches (``init_caches`` or an earlier
    step's) and returns (logits (B, V) on the mesh's first device, the
    caches, written in place); ``specs`` is the caches' layout, {path:
    spec} (``ShardingPolicy.cache_specs``), ``layouts`` the stored
    weights', ``gather(grid)`` the whole caches. A train step: see
    ``build_train_step``. ``policy``: the ``ShardingPolicy`` it cuts
    by. On ``meta`` ``fn`` also takes ``live=`` (the dry run's class
    path: only those mesh devices run, ``Runtime.live``; a train step
    also ``fold=``)."""
    fn: Callable
    specs: dict
    meta: dict
    rt: Runtime
    place: Callable
    gather: Callable
    init_caches: Callable | None = None
    #: a serve step's stored weights, {path: Layout}
    #: (``ShardingPolicy.stored_layouts``), filled by ``place``
    layouts: dict | None = None
    policy: ShardingPolicy | None = None


def make_runtime(cfg: ArchConfig, mesh, shape: ShapeConfig | None, *,
                 impl: str = "auto", cache_specs: dict | None = None
                 ) -> Runtime:
    """The reference's ``make_runtime`` for a ``HostMesh``: the batch over
    ``("pod", "data")`` (those the mesh has), or, where their devices do
    not divide it, over each of them that does (none at ``long_500k``'s
    one row); and the dense caches' sequence cut where ``cache_specs``
    (``ShardingPolicy.cache_specs`` of the caches the step runs against)
    cuts it (``decode_seq_axis``; without them the caches are whole on
    every shard, the reference's local decode)."""
    data_axes: tuple = ()
    if mesh is not None:
        axes = mesh.shape
        data_axes = tuple(a for a in ("pod", "data") if a in axes)
        if shape is not None:
            n = 1
            for a in data_axes:
                n *= axes[a]
            if shape.global_batch % n:
                data_axes = tuple(a for a in data_axes
                                  if shape.global_batch % axes[a] == 0)
    device = "cuda" if mesh is None else str(mesh.devices[0])
    return Runtime(impl=impl, q_chunk=1024, mesh=mesh, device=device,
                   decode_seq_axis=kv_seq_axis(cache_specs or {}),
                   data_axes=data_axes)


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------

def _zero_blocks(meta_state, layouts: dict, mesh) -> list:
    """``grid[d][m]``: every device's zero block of each tensor leaf of an
    optimizer state made on ``meta`` (every optimizer starts at zero)."""
    sizes = mesh.shape

    def take(d, m, dev):
        def leaf(path, x):
            if not isinstance(x, torch.Tensor):
                return x
            return torch.zeros(layouts[path].block_shape(d, m, sizes),
                               dtype=x.dtype, device=dev)
        return tree_map(leaf, meta_state)
    return [[take(d, m, dev) for m, dev in enumerate(row)]
            for d, row in enumerate(mesh.grid)]


def _clip_blocks(grads: list, layouts: dict, mesh, max_norm: float,
                 live=None):
    """``clip_by_global_norm`` over blocks: the norm sums every leaf's
    distinct blocks (a copy counted once, from its first device) in device
    order, leaf after leaf (an all-reduce of each leaf's sum); each block
    is scaled by the one factor. Returns (grads, the norm before clipping)
    on the first device. ``live`` (``Runtime.live``): only those devices'
    blocks exist (None elsewhere), and the sums take theirs."""
    sizes, dev0, cols = mesh.shape, mesh.devices[0], mesh.shape["model"]
    ids = [d * cols + m for d, row in enumerate(mesh.grid)
           for m in range(len(row))]
    coords = [(k // cols, k % cols) for k in ids
              if live is None or k in live]
    total = torch.zeros((), dtype=torch.float32, device=dev0)

    def square(path, _):
        nonlocal total
        seen, parts = set(), []
        for d, m in coords:
            key = layouts[path].block_key(d, m, sizes)
            if key in seen:
                continue
            seen.add(key)
            g = tree_at(grads[d][m], path)
            parts.append(torch.sum(torch.square(g.to(torch.float32)))
                         .to(dev0))
        total = total + collectives.all_reduce(parts, ids, live=live)
    tree_map(square, grads[coords[0][0]][coords[0][1]])
    gnorm = torch.sqrt(total)
    factor = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return [[None if t is None else
             tree_map(lambda _, g: (g.to(torch.float32)
                                    * factor.to(g.device)).to(g.dtype), t)
             for t in row] for row in grads], gnorm


def _or_zeros(g, block):
    return torch.zeros_like(block) if g is None else g


def _meta_only(devices) -> None:
    """The class path (``live``) runs on ``meta`` only: raises for a
    mesh of real devices, which run every device."""
    if any(torch.device(d).type != "meta" for d in devices):
        raise ValueError("live devices (the dry run's class path) run on "
                         "meta only")


def build_train_step(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
                     impl: str = "auto", remat: str = "full",
                     optimizer: str | None = None,
                     accum_steps: int | None = None, unroll: bool = False,
                     dtype=torch.bfloat16) -> StepBundle:
    """The train step of ``cfg`` over ``mesh`` (a ``HostMesh``) at
    ``shape.global_batch`` rows of ``shape.seq_len`` tokens, with the
    reference's choices: above ``GIANT_PARAMS`` (read at call time)
    ``adamw_q8``, 8 microbatches and bf16 gradient accumulators, else
    ``adamw``, one batch and f32 (``optimizer`` and ``accum_steps``
    override); ``fsdp`` where the model is not giant and the batch
    divides the devices, else ``tp`` (FSDP over ``data`` by
    ``make_policy``'s default); ``remat`` (``none | full | dots``) of the
    stack. ``unroll``: the reference's cost variant, one microbatch and
    remat ``none`` (the port's loops are always unrolled). ``dtype``: the
    params'.

    ``place(params, opt_state=None)`` cuts a whole param tree (cast to
    ``dtype``) and optimizer state (zeros when None) into ``grid[d][m]``
    blocks by ``specs`` ({"params": {path: Layout}, "opt": {path:
    Layout}}: ``ShardingPolicy.param_layouts``/``opt_layouts``, each
    ``Layout.spec`` the reference's ``param_specs``/``opt_specs``), the
    layouts the step itself reads; ``fn(params, opt_state,
    batch)`` takes one step on them, in place, and returns (params,
    opt_state, metrics: ``ce``, ``aux`` for a decoder-only model, ``z``,
    ``loss``, ``gnorm``); ``gather(params, opt_state=None, device)``
    joins the blocks back into whole trees.

    The step: each microbatch's loss (``lm_loss`` / ``encdec_loss`` under
    the mesh: each device computes with ``sharding.gathered_view``s of
    the blocks, the batch's rows over every device under fsdp, over the
    data groups under tp) and its gradient by autograd, which sums each
    block's gradient over the devices that gathered it (the
    reduce-scatter); the gradients of copies summed in device order
    (``reduce_copies``: the all-reduce); accumulated in f32, or bf16 for a
    giant, and divided by ``accum_steps``; clipped to global norm 1.0
    (``_clip_blocks``); then each device's blocks updated
    (``Optimizer.update_blocks``)."""
    giant = cfg.param_count_estimate() > GIANT_PARAMS
    opt_name = optimizer or ("adamw_q8" if giant else "adamw")
    if accum_steps is None:
        accum_steps = 8 if giant else 1
    acc_dtype = torch.bfloat16 if giant else torch.float32
    if unroll:
        accum_steps, remat = 1, "none"
    opt = make_optimizer(opt_name, lr=1e-4, weight_decay=0.01)
    n_dev = len(mesh.devices)
    parallelism = ("fsdp" if not giant and shape.global_batch % n_dev == 0
                   else "tp")
    policy = make_policy(cfg, mesh, parallelism=parallelism)
    rt = make_runtime(cfg, mesh, shape, impl=impl).replace(
        data_axes=policy.data_axes, remat=remat)
    loss_fn = ed.encdec_loss if cfg.enc_dec else lm_mod.lm_loss
    init = ed.encdec_init if cfg.enc_dec else lm_mod.lm_init
    meta_params = init(torch.Generator(), cfg, dtype=dtype, device="meta")
    meta_opt = opt.init(meta_params)
    p_lay = policy.param_layouts(meta_params)
    o_lay = policy.opt_layouts(meta_opt)
    sizes, cols = mesh.shape, mesh.shape["model"]
    devs = mesh.devices

    def where(path, k):
        lay = o_lay[path]
        return lay.index(k // cols, k % cols, sizes), lay.shape

    def place(params, opt_state=None):
        params = tree_map(lambda _, x: torch.as_tensor(x).to(dtype)
                          if torch.as_tensor(x).is_floating_point()
                          else torch.as_tensor(x), params)
        grid = place_blocks(params, p_lay, mesh)
        if opt_state is None:
            return grid, _zero_blocks(meta_opt, o_lay, mesh)
        return grid, place_blocks(opt_state, o_lay, mesh)

    def gather(params, opt_state=None, device="cpu"):
        whole = gather_blocks(params, p_lay, mesh, device)
        if opt_state is None:
            return whole
        return whole, gather_blocks(opt_state, o_lay, mesh, device)

    def grads_of(params, batch, rt, runs):
        """(loss, metrics, the reduced gradient grid) of one batch, on
        the devices ``runs`` ((d, m) each; None in the grid elsewhere)."""
        live = [[tree_map(lambda _, x: x.detach().requires_grad_(True), t)
                 if (d, m) in runs else None for m, t in enumerate(row)]
                for d, row in enumerate(params)]
        # fsdp: every device's rows run in one checkpointed region per
        # period, so a shared period slice takes its readers' gradients
        # at once; under tp the data groups run (and recompute) apart, and
        # a shared slice would hold its partial gradient until the last
        # group's backward reached it
        periods = {} if parallelism == "fsdp" else None
        # the blocks of the devices that do not run are read as they are
        src = [[t if g is None else g for t, g in zip(p_row, l_row)]
               for p_row, l_row in zip(params, live)]
        views = [[gathered_view(src, p_lay, policy, d, m, dev, periods)
                  if (d, m) in runs else None
                  for m, dev in enumerate(row)]
                 for d, row in enumerate(mesh.grid)]
        leaves = [leaf for d, m in runs for leaf in tree_leaves(live[d][m])]
        with torch.enable_grad():
            loss, metrics = loss_fn(views, batch, cfg, rt)
            gs = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        # a block no device read takes zeros (none on the bundled
        # configs), before the copies are summed: every copy takes part
        grads = [[None if t is None else
                  tree_map(lambda _, x: _or_zeros(next(gs), x), t)
                  for t in row] for row in live]
        grads = reduce_copies(grads, p_lay, mesh, rt.live)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def train_step(params, opt_state, batch, live=None, fold=None):
        """One step. ``live`` (the dry run's class path, ``meta`` only):
        the devices that run (``Runtime.live``), whole rows under tp.
        ``fold`` (with ``live``): the dry run's ``fold(times, body)``, which
        runs ``body`` once and counts its work ``times`` times: the
        microbatches after the first run the same program on rows of the
        same shapes, so the second runs for all of them (and the
        optimizer's repeated slices, ``Optimizer.update_blocks``)."""
        batch = {k: torch.as_tensor(v).to(devs[0]) for k, v in batch.items()}
        rt_s = rt
        if live is not None:
            _meta_only(devs)
            rt_s = rt.replace(live=frozenset(live))
        elif fold is not None:
            raise ValueError("fold runs with live (the dry run's class path)")
        runs = [(d, m) for d, row in enumerate(mesh.grid)
                for m in range(len(row))
                if live is None or d * cols + m in rt_s.live]
        if accum_steps == 1:
            loss, metrics, grads = grads_of(params, batch, rt_s, runs)
        else:
            mb = batch["tokens"].shape[0] // accum_steps
            acc, losses, ms = None, [], []

            def micro(i):
                nonlocal acc
                loss_i, m_i, g = grads_of(
                    params, {k: v[i * mb:(i + 1) * mb]
                             for k, v in batch.items()}, rt_s, runs)
                if acc is None:
                    acc = [[None if t is None else tree_map(
                        lambda _, x: torch.zeros(
                            x.shape, dtype=acc_dtype, device=x.device), t)
                        for t in row] for row in g]
                for d, m in runs:
                    tree_map(lambda path, a, t=g[d][m]: a.add_(
                        tree_at(t, path).to(acc_dtype)), acc[d][m])
                del g
                losses.append(loss_i)
                ms.append(m_i)
            micro(0)
            if fold is None:
                for i in range(1, accum_steps):
                    micro(i)
            else:
                fold(accum_steps - 1, lambda: micro(1))
                losses += losses[-1:] * (accum_steps - 2)
                ms += ms[-1:] * (accum_steps - 2)
            grads = [[None if t is None else
                      tree_map(lambda _, a: a.div_(accum_steps), t)
                      for t in row] for row in acc]
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        grads, gnorm = _clip_blocks(grads, p_lay, mesh, 1.0, rt_s.live)
        flat = [d * cols + m for d, m in runs]
        new_p, new_o = opt.update_blocks(
            [params[d][m] for d, m in runs], [grads[d][m] for d, m in runs],
            [opt_state[d][m] for d, m in runs],
            lambda path, k: where(path, flat[k]), fold=fold)
        params = [list(row) for row in params]
        opt_state = [list(row) for row in opt_state]
        for (d, m), p, o in zip(runs, new_p, new_o):
            params[d][m], opt_state[d][m] = p, o
        return params, opt_state, dict(metrics, loss=loss, gnorm=gnorm)

    meta = {"kind": "train", "optimizer": opt_name, "fsdp": policy.fsdp,
            "parallelism": parallelism, "remat": remat,
            "accum_steps": accum_steps,
            "accum_dtype": str(acc_dtype).replace("torch.", "")}
    return StepBundle(
        fn=train_step, specs={"params": p_lay, "opt": o_lay}, meta=meta,
        rt=rt, place=place, gather=gather, policy=policy)


def build_serve_step(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
                     impl: str = "auto", quantized: bool = True,
                     kv_quant: bool = False, prefill_cp: bool | None = None,
                     unroll: bool = False,
                     dtype=torch.bfloat16) -> StepBundle:
    """A prefill or decode step (``shape.kind``) of ``cfg`` over ``mesh``
    (a ``HostMesh``) at ``shape.global_batch`` rows and a
    ``shape.seq_len``-token cache. ``prefill_cp`` None takes the
    reference's default: context-parallel for a prefill of at most
    CP_MAX_PARAMS params whose batch and length are multiples of 16,
    never for an encoder-decoder model by default. Under the
    context-parallel prefill the weights are stored ``replicated`` and
    each sequence (an LM's prompt; an encoder-decoder's frames and its
    decoder prompt apart) runs context-parallel where its length divides
    the model axis, else whole on each data group's first shard, the
    reference's per-attention rule (``meta["cp_sequences"]``); otherwise
    they are stored by ``make_policy`` (FSDP above
    ``sharding.FSDP_ABOVE`` params). ``dtype``: the dense caches' (bf16 as the
    reference's); ``kv_quant`` codes them (``Runtime.kv_scheme``'s
    default codebook). ``unroll`` (the reference's cost variant) changes
    nothing here: the port's loops are always unrolled.

    On ``meta`` (the dry run, ``launch.dryrun``) ``place`` takes meta
    params and quantizes them to meta codes and scales, and
    ``init_caches(device)`` makes the caches there."""
    if shape.kind == "train":
        raise ValueError("a train step: build_train_step (or build_step)")
    b, s = shape.global_batch, shape.seq_len
    m = mesh.shape["model"]
    if prefill_cp is None:
        prefill_cp = (shape.kind == "prefill"
                      and cfg.param_count_estimate() <= CP_MAX_PARAMS
                      and s % 16 == 0 and b % 16 == 0 and not cfg.enc_dec)
    cp = shape.kind == "prefill" and bool(prefill_cp)
    # the sequences that run context-parallel: those whose length divides
    # the model axis (the reference's ``attention_core`` rule)
    lengths = {"decoder": s}
    if cfg.enc_dec:
        lengths["encoder"] = cfg.enc_seq_len
    cp_seqs = {k: cp and n % m == 0 for k, n in sorted(lengths.items())}
    policy = (ShardingPolicy(cfg, mesh, parallelism="replicated") if cp
              else make_policy(cfg, mesh))
    init = ed.encdec_init_caches if cfg.enc_dec else lm_mod.init_caches
    c_specs = policy.cache_specs(init(cfg, b, s, dtype=dtype,
                                      kv_quant=kv_quant, device="meta"))
    rt = make_runtime(cfg, mesh, shape, impl=impl,
                      cache_specs=c_specs).replace(kv_quant=kv_quant,
                                                   attn_cp=cp)
    dev0 = mesh.devices[0]
    layouts: dict = {}

    def place(params, *inputs):
        """(the stored weights, ``grid[d][m]``, then ``inputs`` on the
        mesh's first device)."""
        if quantized:
            params = quantize_params(params, SERVE_SCHEME)
        layouts.clear()
        layouts.update(policy.stored_layouts(params))
        return (place_blocks(params, layouts, mesh, share=True),
                *(torch.as_tensor(t).to(dev0) for t in inputs))

    def init_caches(device="cpu"):
        return shard_dense_caches(init(cfg, b, s, dtype=dtype,
                                       kv_quant=kv_quant, device=device),
                                  c_specs, mesh)

    def gather_caches(grid, device="cpu"):
        return gather_dense_caches(grid, c_specs, device, mesh.shape)

    meta = {"kind": shape.kind, "quantized": quantized,
            "kv_quant": kv_quant, "prefill_cp": prefill_cp,
            "context_parallel": any(cp_seqs.values()),
            "cp_sequences": cp_seqs, "parallelism": policy.parallelism,
            "fsdp": policy.fsdp, "fsdp_axes": policy.fsdp_axes,
            "decode_seq_axis": rt.decode_seq_axis,
            "data_axes": rt.data_axes}
    if shape.kind == "prefill":
        if cfg.enc_dec:
            def step(params, frames, tokens, caches, rt):
                return ed.encdec_prefill(params, frames, tokens, caches,
                                         cfg, rt)
        else:
            def step(params, tokens, caches, rt):
                return lm_mod.lm_prefill(params, tokens, caches, cfg, rt)
    else:
        mod = ed.encdec_decode_step if cfg.enc_dec else lm_mod.lm_decode_step

        def step(params, token, pos, caches, rt):
            return mod(params, token, pos, caches, cfg, rt)

    @torch.no_grad()
    def run(grid, *args, live=None):
        """The step; ``live`` (the dry run's class path, ``meta`` only):
        the devices that run (``Runtime.live``), whole rows."""
        step_rt = rt
        if live is not None:
            _meta_only(mesh.devices)
            step_rt = rt.replace(live=frozenset(live))
        cols = len(mesh.grid[0])
        periods: dict = {}
        views = [[gathered_view(grid, layouts, policy, d, k, dev, periods)
                  if live is None or d * cols + k in step_rt.live else None
                  for k, dev in enumerate(row)]
                 for d, row in enumerate(mesh.grid)]
        return step(views, *args, step_rt)

    return StepBundle(
        fn=run, specs=c_specs, meta=meta, rt=rt, place=place,
        gather=gather_caches, init_caches=init_caches, layouts=layouts,
        policy=policy)


def build_step(cfg: ArchConfig, shape: ShapeConfig, mesh, **kw) -> StepBundle:
    """``build_train_step`` for ``shape.kind == "train"``, else
    ``build_serve_step``."""
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, **kw)
    return build_serve_step(cfg, shape, mesh, **kw)
