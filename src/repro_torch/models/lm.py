"""Decoder-only language model: init, the training loss (``lm_loss``
over ``chunked_ce``), the full-sequence forward (``lm_logits``), the dense
serving path (``lm_prefill`` of a whole prompt into per-slot caches,
``lm_decode_step``), the paged prefill/decode step, the speculative verify
window, the fused decode tick, and the page, slab and cross-entry writes
the serving engine's copy-on-write, preemption and admission use. Dense,
MoE, recurrent (xLSTM), hybrid (Jamba) and M-RoPE (Qwen2-VL) patterns; the
encoder-decoder family is assembled in ``models/encdec.py`` from the same
pieces.

Caches and page pools (bf16 by default as in the reference, f32 when asked
for, or SPx codes + f32 scales when quantized; recurrent states f32) are
updated in place; the step functions still return ``(logits, caches)`` so
callers read like the reference.

Under ``Runtime.mesh`` (a tensor-parallel serving engine) the paged step
functions take one param tree and one state cache per shard
(``sharding.shard_params``, ``shard_paged_state``): the embedding lookup
runs over the shards' slices of the table (``sharded_embedding_apply``),
``stack_paged`` runs the shards' layers, and the head over the shards'
slices of it (``sharded_logits``), all joined or summed in shard order
on the first shard's device. Under a ``HostMesh`` (the serve steps of
``launch.steps``) ``lm_prefill`` and ``lm_decode_step`` take
``grid[d][m]`` trees and run each data group's rows over its model
shards the same way (``mesh_apply``). ``lm_loss`` runs tensor-parallel
under a ``ServingMesh`` and is the train step's loss under a ``HostMesh``
(``mesh_loss``: each device's rows under fsdp, each data group's
tensor-parallel under tp).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import collectives
from repro_torch.configs.base import ArchConfig
from repro_torch.nn.layers import (dense_init, embedding_apply,
                                   embedding_init, norm_apply, norm_init,
                                   sharded_embedding_apply, sharded_logits,
                                   tree_leaves, tree_map)
from repro_torch.nn.transformer import (cp_blocks, slot_init_cache,
                                        slot_init_paged_cache, stack_apply,
                                        stack_apply_rows, stack_decode,
                                        stack_init, stack_paged,
                                        stack_prefill, stack_prefill_cp)
from repro_torch.runtime import Runtime, resolve_device
from repro_torch.sharding import whole

__all__ = ["lm_init", "lm_loss", "lm_logits", "chunked_ce", "init_caches",
           "lm_prefill", "lm_decode_step", "paged_init_caches",
           "lm_paged_step", "lm_paged_verify", "lm_paged_fused_step",
           "paged_copy_page", "paged_gather_pages", "paged_scatter_pages",
           "paged_gather_slabs", "paged_scatter_slabs", "paged_reset_slabs",
           "paged_fill_cross", "LOSS_CHUNK", "AUX_WEIGHT", "Z_WEIGHT"]

LOSS_CHUNK = 256
AUX_WEIGHT = 0.01
Z_WEIGHT = 1e-4

#: leaf keys of a slot's state-cache regions: the token pages, the
#: read-only cross entries (xdec slots); every other leaf is slab state
_PAGE_KEYS = ("kp", "vp")
_CROSS_KEYS = ("xk", "xv")


def lm_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
            device=None) -> dict:
    """Random params drawn from ``gen``, on ``device`` (``cuda`` unless
    the caller asks for another; raises without a card). ``gen`` must
    live on that device."""
    device = resolve_device(device)
    p = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                dtype=dtype, device=device),
        "stack": stack_init(gen, cfg, dtype=dtype, device=device),
        "final_norm": norm_init(cfg.norm, cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype=dtype,
                               device=device)
    return p


def _head_w(params: dict, cfg: ArchConfig) -> torch.Tensor:
    """The (D, V) vocabulary projection: the tied table's transpose or the
    untied head."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["head"]["w"]


def _view_head_w(params: dict, cfg: ArchConfig) -> torch.Tensor:
    """``_head_w`` of a tree whose leaves may be ``GatheredLeaf``s."""
    if cfg.tie_embeddings:
        return whole(params["embed"]["table"]).T
    return whole(params["head"]["w"])


def _head(params: dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Vocabulary logits: the tied ``h @ table.T`` (or the untied head) —
    a plain product outside any kernel."""
    if cfg.tie_embeddings:
        return torch.matmul(h, params["embed"]["table"].to(h.dtype).T)
    return torch.matmul(h, params["head"]["w"].to(h.dtype))


def _default_positions(cfg: ArchConfig, b: int, s: int,
                       device) -> torch.Tensor:
    """(B, S) token positions; for M-RoPE the three streams of text
    tokens, each the token index: (B, 3, S)."""
    pos = torch.arange(s, device=device).expand(b, s)
    if cfg.mrope_sections is not None:
        return pos[:, None, :].expand(b, 3, s)
    return pos


def _ce_chunk(h_i, w16, y_i):
    """(sum of lse - true logit, sum of lse^2) of one chunk: bf16 operands,
    f32 products and sums (the reference's ``preferred_element_type``)."""
    logits = torch.matmul(h_i.to(torch.bfloat16).to(torch.float32),
                          w16.to(torch.float32))
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, y_i.long()[..., None])[..., 0]
    return torch.sum(lse - true), torch.sum(lse * lse)


def chunked_ce(h: torch.Tensor, w_head: torch.Tensor, labels: torch.Tensor,
               *, chunk: int = LOSS_CHUNK):
    """Mean token cross-entropy and z-loss (mean log^2 Z) of h (B, S, D)
    against labels (B, S) under the head w_head (D, V), over sequence
    chunks: the (B, chunk, V) logits block is the only vocab-sized live
    tensor, and each chunk is recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``)
    instead of being saved. One chunk when S is not a multiple."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s
    w16 = w_head.to(torch.bfloat16)
    ce = z = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, chunk):
        args = (h[:, i:i + chunk], w16, labels[:, i:i + chunk])
        if torch.is_grad_enabled():
            c, zz = torch.utils.checkpoint.checkpoint(
                _ce_chunk, *args, use_reentrant=False)
        else:
            c, zz = _ce_chunk(*args)
        ce, z = ce + c, z + zz
    return ce / (b * s), z / (b * s)


def _backbone(params, cfg: ArchConfig, tokens, positions, rt: Runtime):
    x = embedding_apply(params["embed"], tokens)
    h, aux = stack_apply(params["stack"], x, positions, cfg, rt)
    return norm_apply(cfg.norm, params["final_norm"], h), aux


def _tp_backbone(ps: list, cfg: ArchConfig, tokens, positions, rt: Runtime):
    """``_backbone`` tensor-parallel over the shards of ``rt.mesh``: the
    lookup over the shards' slices of the table, the sharded stack, the
    final norm from shard 0, on the first shard's device."""
    devs = rt.mesh.devices
    x = sharded_embedding_apply([whole(p["embed"]) for p in ps],
                                tokens.to(devs[0]), rt.mesh, cfg.vocab_size)
    h, aux = stack_apply([p["stack"] for p in ps], x,
                         positions.to(devs[0]), cfg, rt)
    return norm_apply(cfg.norm, whole(ps[0]["final_norm"]), h), aux


def mesh_head_w(ws: list, mesh, d_model: int) -> torch.Tensor:
    """The whole (D, V) head on the first shard's device of ``mesh`` from
    the shards' slices ``ws`` (each (D, V_s) where the vocabulary splits,
    (D_s, V) where the head is cut on d: its rows fewer than
    ``d_model``), joined in shard order (an all-gather over the shards):
    the loss head of a tensor-parallel loss, whose ``chunked_ce`` takes
    the whole vocabulary's logits."""
    vocab_split = all(w.shape[0] == d_model for w in ws)
    return collectives.all_gather(ws, -1 if vocab_split else 0,
                                  mesh.devices[0], mesh.ids)


def lm_loss(params, batch: dict, cfg: ArchConfig, rt: Runtime):
    """batch: {"tokens": (B, S), "labels": (B, S), optional "positions"}.
    Returns (scalar loss, {"ce", "aux", "z"}): cross-entropy plus
    ``AUX_WEIGHT`` x the MoE load-balance loss plus ``Z_WEIGHT`` x the
    z-loss. Differentiable: on the card the attention runs the flash
    kernel inside its ``autograd.Function``. Under ``rt.mesh``: a
    ``ServingMesh`` runs it tensor-parallel over its shards (``params``
    one tree per shard, as ``sharding.serving_cut`` cuts them; the loss
    head whole on the first shard's device); a ``HostMesh`` is the train
    step's (``launch.steps.build_train_step``, ``mesh_loss``)."""
    if rt.mesh is not None and hasattr(rt.mesh, "grid"):
        return mesh_loss(params, batch, cfg, rt, rows=_lm_rows,
                         group_loss=lm_loss)
    tokens = batch["tokens"]
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(cfg, *tokens.shape, tokens.device)
    if rt.mesh is None:
        h, aux = _backbone(params, cfg, tokens, positions, rt)
        w = _head_w(params, cfg)
    else:
        h, aux = _tp_backbone(params, cfg, tokens, positions, rt)
        w = mesh_head_w([_view_head_w(p, cfg) for p in params], rt.mesh,
                        cfg.d_model)
    ce, z = chunked_ce(h, w, batch["labels"].to(h.device))
    loss = ce + AUX_WEIGHT * aux + Z_WEIGHT * z
    return loss, {"ce": ce, "aux": aux, "z": z}


def _lm_rows(views: list, batches: list, cfg: ArchConfig, rt: Runtime,
             members=None):
    """The LM's rows over several devices (``mesh_loss``'s fsdp): each
    device's (ce, z) means over its rows, and the aux loss (``members``:
    ``stack_apply_rows``')."""
    xs, pos = [], []
    for v, b in zip(views, batches):
        xs.append(embedding_apply(whole(v["embed"]), b["tokens"]))
        p = b.get("positions")
        pos.append(p if p is not None else _default_positions(
            cfg, *b["tokens"].shape, b["tokens"].device))
    hs, aux = stack_apply_rows([v["stack"] for v in views], xs, pos, cfg, rt,
                               members=members)
    out = []
    for v, h, b in zip(views, hs, batches):
        h = norm_apply(cfg.norm, whole(v["final_norm"]), h)
        out.append(chunked_ce(h, _view_head_w(v, cfg), b["labels"]))
    return out, aux


def _row_groups(mesh, data_axes: tuple, b: int) -> list:
    """(row, its slice of the batch) of every mesh row that runs rows of
    ``b`` split over ``data_axes`` (pod-major), the first row of each
    group: b / n rows each where the n groups divide b, else the first
    row runs all b and the others none (they would compute the same rows,
    so the gradient is taken once)."""
    sizes, n = mesh.shape, 1
    for a in data_axes:
        n *= sizes[a]
    if n <= 1 or b % n:
        return [(0, slice(0, b))]
    per, seen, out = b // n, set(), []
    for r in range(len(mesh.grid)):
        g = _group(mesh, r, data_axes)
        if g not in seen:
            seen.add(g)
            out.append((r, slice(g * per, (g + 1) * per)))
    return out


def loss_rows(mesh, data_axes: tuple, b: int) -> dict:
    """{mesh device index: its slice of the batch's ``b`` rows} of every
    device that runs rows in ``mesh_loss``: under fsdp (``"model"`` in
    ``data_axes``) b / n on each of the n devices where they divide b,
    else all b on the first; under tp each running row's slice
    (``_row_groups``) on every device of the row."""
    if "model" in data_axes:
        n = len(mesh.devices)
        per = b // n if n > 1 and b % n == 0 else b
        return {k: slice(k * per, (k + 1) * per) for k in range(b // per)}
    cols = mesh.shape["model"]
    return {r * cols + m: sl for r, sl in _row_groups(mesh, data_axes, b)
            for m in range(cols)}


def _row_live(row, live) -> bool:
    """Whether a row (a ``ServingMesh``) runs under ``Runtime.live``: all
    of its devices or none (a row's shards run together); raises for a
    row cut in two."""
    if live is None:
        return True
    ids = set(row.ids)
    if ids & live and not ids <= live:
        raise ValueError(f"live devices {sorted(ids & live)} cut row "
                         f"{sorted(ids)}: a row runs whole or not at all")
    return ids <= live


def _group(mesh, r: int, data_axes: tuple) -> int:
    """Row ``r``'s index among the groups of ``data_axes``."""
    sizes, at, g = mesh.shape, mesh.coords(r), 0
    for a in data_axes:
        g = g * sizes[a] + at[a]
    return g


def mesh_loss(params, batch: dict, cfg: ArchConfig, rt: Runtime, *, rows,
              group_loss):
    """The train step's loss under ``rt.mesh`` (a ``HostMesh``; the
    reference's loss under its mesh): ``params`` is ``grid[d][m]``, the
    tree each device computes with (``sharding.gathered_view``: whole
    under fsdp, its model shard under tp). ``"model"`` in
    ``rt.data_axes`` (fsdp): every device runs its rows of the batch
    (``rows(views, batches, cfg, rt, members)`` -> each device's (ce, z)
    means and the aux loss or None); else each data group runs its rows
    (over ``rt.data_axes``, where the batch divides) tensor-parallel over
    its model shards (``group_loss`` under the group's ``ServingMesh``). ce
    and z are means over the global batch. A MoE's aux loss under tp is
    the reference's: each group routes its own tokens, the value reported
    is group 0's (the reference's ``P()`` output, read from device 0) and
    its gradient is the mean over the groups'. Under ``rt.live`` only the
    live devices run their rows (``params`` holds None elsewhere); where
    none of them runs rows the loss is a stand-in that reaches no
    weight."""
    mesh, live = rt.mesh, rt.live
    b = batch["tokens"].shape[0]
    ces, zs, members = [], [], []
    aux = None

    def weigh(part, sl):
        return part * ((sl.stop - sl.start) / b)

    if "model" in rt.data_axes:
        devs = mesh.devices
        slices = loss_rows(mesh, rt.data_axes, b)
        cols = mesh.shape["model"]
        members = list(slices)
        ids = [k for k in members if live is None or k in live]
        views = [params[k // cols][k % cols] for k in ids]
        batches = [{key: t[slices[k]].to(devs[k]) for key, t in batch.items()}
                   for k in ids]
        parts, aux = (rows(views, batches, cfg, rt.replace(mesh=None),
                           members) if ids else ([], None))
        for (c, zz), k in zip(parts, ids):
            ces.append(weigh(c, slices[k]))
            zs.append(weigh(zz, slices[k]))
    else:
        auxes = []
        for r, sl in _row_groups(mesh, rt.data_axes, b):
            row = mesh.row(r)
            members.append(row.first)
            if not _row_live(row, live):
                continue
            _, m = group_loss(params[r], {key: t[sl].to(row.devices[0])
                                          for key, t in batch.items()},
                              cfg, rt.replace(mesh=row))
            ces.append(weigh(m["ce"], sl))
            zs.append(weigh(m["z"], sl))
            if "aux" in m:
                auxes.append(m["aux"].to(ces[0].device))
        if auxes:
            mean = sum(auxes) / len(auxes)
            aux = auxes[0].detach() + (mean - mean.detach())
    if not ces:
        # a class of the dry run whose devices run no rows
        loss = torch.zeros((), device="meta", requires_grad=True)
        return loss, {"ce": loss.detach(), "z": loss.detach()}
    # the loss over the devices that ran rows: an all-reduce of each term
    ce = collectives.all_reduce(ces, members, live=live)
    z = collectives.all_reduce(zs, members, live=live)
    loss = ce + Z_WEIGHT * z
    metrics = {"ce": ce}
    if aux is not None:
        loss = loss + AUX_WEIGHT * aux
        metrics["aux"] = aux
    metrics["z"] = z
    return loss, metrics


def lm_logits(params, tokens, cfg: ArchConfig, rt: Runtime, positions=None):
    """Full-sequence logits (B, S, V) of tokens (B, S) (small-model and
    test use)."""
    if positions is None:
        positions = _default_positions(cfg, *tokens.shape, tokens.device)
    h, _ = _backbone(params, cfg, tokens, positions, rt)
    return _head(params, cfg, h)


# -- dense serving ------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, kv_quant: bool = False,
                device=None) -> list:
    """Dense per-slot serving state for every slot in the pattern (K/V
    caches, recurrent states), on ``device`` (``cuda`` unless the caller
    asks for another)."""
    device = resolve_device(device)
    return [slot_init_cache(slot, cfg, batch, max_seq, dtype,
                            kv_quant=kv_quant, device=device)
            for slot in cfg.pattern]


def lm_prefill(params, tokens, caches, cfg: ArchConfig, rt: Runtime,
               positions=None):
    """Run the prompt tokens (B, S) through the stack, write its K/V into
    positions [0, S) of ``caches`` and each recurrent slot's final state
    (in place), and return the last position's logits (B, V) and the
    caches. Under ``rt.mesh`` (a ``HostMesh``: the serve steps of
    ``launch.steps``) ``params`` and ``caches`` are ``grid[d][m]`` trees
    and the prompt runs per data group (``mesh_apply``),
    tensor-parallel or, under ``rt.attn_cp``, context-parallel over its
    model shards (whole on the first where its length does not divide
    them)."""
    if positions is None:
        positions = _default_positions(cfg, *tokens.shape[:2],
                                       tokens.device)
    if rt.mesh is not None:
        return _mesh_prefill(params, tokens, positions, caches, cfg, rt)
    x = embedding_apply(params["embed"], tokens)
    h, caches, _ = stack_prefill(params["stack"], x, positions, cfg, rt,
                                 caches)
    h = norm_apply(cfg.norm, params["final_norm"], h[:, -1:])
    return _head(params, cfg, h[:, 0]), caches


def lm_decode_step(params, token, pos, caches, cfg: ArchConfig,
                   rt: Runtime):
    """One decode step. token: (B,) int; pos: scalar or (B,) write position
    (tokens already in each row's cache). Returns (logits (B, V),
    caches). Under ``rt.mesh`` as ``lm_prefill``: the caches' blocks cut on
    their sequence (``rt.decode_seq_axis``) take the token where it
    lands and attend in parallel."""
    if rt.mesh is not None:
        return _mesh_decode(params, token, pos, caches, cfg, rt)
    x = embedding_apply(params["embed"], token[:, None])
    h, caches = stack_decode(params["stack"], x, pos, cfg, rt, caches)
    h = norm_apply(cfg.norm, params["final_norm"], h)
    return _head(params, cfg, h[:, 0]), caches


def mesh_apply(params, tokens, caches, cfg: ArchConfig, rt: Runtime, body,
               head_w=None):
    """The serve steps' forward under ``rt.mesh`` (a ``HostMesh``): each
    data group takes its rows of ``tokens`` (split over ``rt.data_axes``,
    else the whole batch in every group) and runs ``body(ps, tokens_d,
    rows, rt_d, caches_d)`` over its model shards (``rt_d.mesh``), which
    returns the last hidden rows (B_d, 1, D) and the shards (a slice)
    whose head slices give the logits; the final norm and the vocabulary
    projection (``head_w(p)``, the tied table or untied head by default)
    follow. Returns the logits (B, V) on the mesh's first device, side by
    side where the batch split, and the caches. Under ``rt.live`` only
    the rows whose devices are live run; a group none of them ran gives
    stand-in logits."""
    head_w = head_w or (lambda p: _head_w(p, cfg))
    mesh, b = rt.mesh, tokens.shape[0]
    n = 1
    for a in rt.data_axes:
        n *= mesh.shape[a]
    per = b // n
    outs, groups = {}, set()
    for d in range(len(mesh.grid)):
        g = _group(mesh, d, rt.data_axes)
        groups.add(g)
        rt_d = rt.replace(mesh=mesh.row(d))
        if not _row_live(rt_d.mesh, rt.live):
            continue
        rows = slice(g * per, (g + 1) * per)
        h, heads = body(params[d], tokens[rows], rows, rt_d, caches[d])
        ps = [whole({k: p[k] for k in ("final_norm", "embed", "head")
                     if k in p}) for p in params[d][heads]]
        sub = rt_d.mesh.part(heads)
        h = norm_apply(cfg.norm, ps[0]["final_norm"], h.to(sub.devices[0]))
        logits = sharded_logits([head_w(p) for p in ps], h[:, 0], sub)
        outs.setdefault(g, logits.to(mesh.devices[0]))
    like = next(iter(outs.values()))
    return torch.cat([outs[g] if g in outs else collectives.stand_in(like)
                      for g in sorted(groups)]), caches


def mesh_embed(ps: list, tokens, cfg: ArchConfig, rt: Runtime):
    """``tokens`` embedded over the shards' slices of the table, on the
    first shard's device."""
    return sharded_embedding_apply([whole(p["embed"]) for p in ps],
                                   tokens.to(rt.mesh.devices[0]), rt.mesh,
                                   cfg.vocab_size)


def _mesh_prefill(params, tokens, positions, caches, cfg: ArchConfig,
                  rt: Runtime):
    def tp(ps, tok, rows, rt_d, c):
        x = mesh_embed(ps, tok, cfg, rt_d)
        h, _, _ = stack_prefill([p["stack"] for p in ps], x,
                                positions[rows].to(x.device), cfg, rt_d, c)
        return h[:, -1:], slice(None)

    def cp(ps, tok, rows, rt_d, c):
        # shard m embeds and runs its row block (``cp_blocks``: the rows
        # [m S/n, (m + 1) S/n), or all of them on the first shard); the
        # last block holds the last position
        toks, pos = cp_blocks(tok, positions[rows], rt_d.mesh.devices)
        xs = [embedding_apply(whole(p["embed"]), t)
              for p, t in zip(ps, toks)]
        xs = stack_prefill_cp([p["stack"] for p in ps], xs, pos, cfg, rt_d,
                              c)
        return xs[-1][:, -1:], slice(len(xs) - 1, len(xs))
    return mesh_apply(params, tokens, caches, cfg, rt,
                      cp if rt.attn_cp else tp)


def _mesh_decode(params, token, pos, caches, cfg: ArchConfig, rt: Runtime):
    pos = torch.as_tensor(pos)

    def body(ps, tok, rows, rt_d, c):
        x = mesh_embed(ps, tok, cfg, rt_d)
        h, _ = stack_decode([p["stack"] for p in ps], x,
                            (pos[rows] if pos.ndim else pos).to(x.device),
                            cfg, rt_d, c)
        return h, slice(None)
    return mesh_apply(params, token[:, None], caches, cfg, rt, body)


# -- paged serving ------------------------------------------------------------

def paged_init_caches(cfg: ArchConfig, n_pages: int, page_size: int,
                      dtype=torch.bfloat16, kv_quant: bool = False,
                      n_slabs: int = 0, n_cross: int = 0,
                      device=None) -> list:
    """The state-cache regions of every slot in the pattern, on ``device``
    (``cuda`` unless the caller asks for another): K/V page pools for
    attention slots — values of ``dtype`` (bf16 unless asked for f32), or
    codes + scale dicts when ``kv_quant`` (scheme from
    ``Runtime.kv_scheme`` at step time) — ``n_slabs`` recurrent-state
    slabs for recurrent slots, and ``n_cross`` read-only encoder-output
    entries for xdec slots."""
    device = resolve_device(device)
    return [slot_init_paged_cache(slot, cfg, n_pages, page_size, dtype,
                                  kv_quant=kv_quant, n_slabs=n_slabs,
                                  n_cross=n_cross, device=device)
            for slot in cfg.pattern]


def _slab_keys(slot_cache: dict) -> list:
    return [k for k in slot_cache
            if k not in _PAGE_KEYS and k not in _CROSS_KEYS]


def _paged_forward(params, tokens, ctx_len, block_table, n_valid,
                   state_idx, caches, cfg: ArchConfig, rt: Runtime, *,
                   fused: bool = False, stack: str = "stack"):
    """Embedding, the stack ``params[stack]`` over the state cache, the
    final norm: (h (B, C, D), caches); one device, or the shards of
    ``rt.mesh``. ``cfg`` is the stack's (an enc-dec model's decoder)."""
    if rt.mesh is None:
        x = embedding_apply(params["embed"], tokens)
        layers, final_norm = params[stack], params["final_norm"]
    else:
        x = sharded_embedding_apply([p["embed"] for p in params], tokens,
                                    rt.mesh, cfg.vocab_size)
        layers = [p[stack] for p in params]
        final_norm = params[0]["final_norm"]
    h, caches = stack_paged(layers, x, ctx_len, block_table, n_valid,
                            state_idx, cfg, rt, caches, fused=fused)
    return norm_apply(cfg.norm, final_norm, h), caches


def _paged_head(params, cfg: ArchConfig, h, rt: Runtime) -> torch.Tensor:
    """The head of a paged step; under ``rt.mesh`` over the shards'
    slices of it (``sharded_logits``: the vocabulary's slices joined, or
    the partial logits of a d-cut head summed, in shard order on the
    first shard's device)."""
    if rt.mesh is None:
        return _head(params, cfg, h)
    return sharded_logits([_head_w(p, cfg) for p in params], h, rt.mesh)


def lm_paged_step(params, tokens, ctx_len, block_table, n_valid, state_idx,
                  caches, cfg: ArchConfig, rt: Runtime):
    """One paged engine step: the next C tokens of each sequence — a
    prefill chunk (C > 1) or a decode step (C == 1).

    tokens: (B, C) int (rows may be padded past ``n_valid``); ctx_len:
    (B,) tokens already in the pages; block_table: (B, max_pages);
    n_valid: (B,) valid tokens in this chunk (0 = inactive row);
    state_idx: (B, 2) each row's (slab, cross) index, the out-of-range
    sentinels for rows without one (all-sentinel for attention-only
    patterns). Returns (logits (B, V) at each row's last valid position,
    caches)."""
    h, caches = _paged_forward(params, tokens, ctx_len, block_table, n_valid,
                               state_idx, caches, cfg, rt)
    last = torch.clamp(n_valid.long() - 1, 0, tokens.shape[1] - 1)
    h_last = h[torch.arange(h.shape[0], device=h.device), last.to(h.device)]
    return _paged_head(params, cfg, h_last, rt), caches


def lm_paged_verify(params, tokens, ctx_len, block_table, n_valid,
                    state_idx, caches, cfg: ArchConfig, rt: Runtime):
    """Score a speculation window in one paged forward pass (the unfused
    verify step; serving/spec.py has the drafter). Same contract as
    ``lm_paged_step`` — tokens (B, C) is the pending token plus up to C-1
    drafts, padded past ``n_valid``, written to the pages and attended
    causally through the chunked page-gather path (or, at C == 1, through
    ``ops.paged_attention``: the unfused decode tick) — but logits come
    back at every window position, (B, C, V): position j scores the token
    after window token j. Rows past ``n_valid`` carry garbage logits —
    never read."""
    h, caches = _paged_forward(params, tokens, ctx_len, block_table, n_valid,
                               state_idx, caches, cfg, rt)
    return _paged_head(params, cfg, h, rt), caches


def lm_paged_fused_step(params, tokens, ctx_len, block_table, n_valid,
                        state_idx, caches, cfg: ArchConfig, rt: Runtime):
    """One fused decode tick, plain decode (W == 1) and the speculative
    verify window (W == spec_k + 1) alike: every layer's attention is ONE
    ``paged_decode_ragged`` launch over the batch's ragged (slot,
    attend_len) grid (one per shard under ``rt.mesh``). tokens (B, W) is
    each row's window, padded past ``n_valid``; logits come back at every
    window position, (B, W, V), as from ``lm_paged_verify``. Rows past
    ``n_valid`` carry garbage logits — never read."""
    h, caches = _paged_forward(params, tokens, ctx_len, block_table, n_valid,
                               state_idx, caches, cfg, rt, fused=True)
    return _paged_head(params, cfg, h, rt), caches


def paged_copy_page(caches, src: int, dst: int):
    """Copy physical page ``src`` -> ``dst`` across every layer, head and
    pool leaf (codes and scales of a quantized pool), in place."""
    for slot_cache in caches:
        for k in _PAGE_KEYS:
            for leaf in tree_leaves(slot_cache.get(k, {})):
                leaf[:, dst] = leaf[:, src]
    return caches


def paged_gather_pages(caches, pages: torch.Tensor) -> list:
    """Whole physical pages across every pool leaf: the preemption
    snapshot. Each (P, n_pages, Hkv, ps, w) leaf yields (P, n, Hkv, ps,
    w); quantized pools keep their codes + scale structure. Slab leaves
    are left out (``paged_gather_slabs``): one dict per slot, empty for
    recurrent slots."""
    idx = pages.long()
    return [{k: tree_map(lambda _, leaf: leaf[:, idx.to(leaf.device)],
                         slot_cache[k])
             for k in _PAGE_KEYS if k in slot_cache}
            for slot_cache in caches]


def paged_scatter_pages(caches, pages: torch.Tensor, payload):
    """Write snapshotted pages back into the pools, in place — the inverse
    of ``paged_gather_pages``."""
    idx = pages.long()
    for slot_cache, pay in zip(caches, payload):
        for k in pay:
            for leaf, val in zip(tree_leaves(slot_cache[k]),
                                 tree_leaves(pay[k])):
                leaf[:, idx.to(leaf.device)] = torch.as_tensor(val).to(
                    leaf.device, leaf.dtype)
    return caches


def paged_gather_slabs(caches, slab: int) -> list:
    """One slab's recurrent state across every recurrent slot, copied:
    each (P, n_slabs, ...) slab leaf yields (P, ...). One dict per slot,
    empty for attention slots."""
    return [{k: slot_cache[k][:, slab].clone() for k in _slab_keys(slot_cache)}
            for slot_cache in caches]


def paged_scatter_slabs(caches, slab: int, payload):
    """Write a snapshotted slab back, in place — the inverse of
    ``paged_gather_slabs``, possibly into another slab index than the one
    it was taken from."""
    for slot_cache, pay in zip(caches, payload):
        for k, val in pay.items():
            leaf = slot_cache[k]
            leaf[:, slab] = torch.as_tensor(val).to(leaf.device, leaf.dtype)
    return caches


def paged_reset_slabs(caches, slab: int):
    """Zero one slab across every recurrent slot, in place: a fresh
    sequence starts from the zero state, and a recycled slab still holds
    its previous owner's."""
    for slot_cache in caches:
        for k in _slab_keys(slot_cache):
            slot_cache[k][:, slab] = 0
    return caches


def paged_fill_cross(caches, idx: int, entries):
    """Write one encoder pass's projected K/V into cross entry ``idx`` of
    every xdec slot, in place. ``entries``: per slot ``None`` (no xdec) or
    {"xk", "xv"} each (P, 1, Hkv, enc_seq_len, dh), the output of
    ``models.encdec.encdec_cross_kv`` on one input. An entry is written
    once here and only read by the decode path."""
    for slot_cache, ent in zip(caches, entries):
        if ent is not None:
            for k in _CROSS_KEYS:
                slot_cache[k][:, idx] = ent[k][:, 0].to(slot_cache[k].dtype)
    return caches
