"""Plain PyTorch reference of a decoder-only LM of attention layers with a
SwiGLU or mixture-of-experts FFN: the full causal forward pass of whole
sequences, in f32, with no cache, no batching and no kernel of the
program. Imports torch, numpy and the benchmark's own modules only.

Per layer: x += Wo attn(rope(q), rope(k), v) of rmsnorm(x), then
x += ffn(rmsnorm(x)). Attention is causal softmax(q k^T / sqrt(dh)) v,
query head h reading KV head h // (Hq / Hkv); q and k are rotated by
RoPE (pairs split at dh / 2, frequencies theta^(-2i/dh)) or, with
``mrope_sections``, by M-RoPE, frequency i taking the position stream
of its section (temporal, height, width; all three are the token index
for text). The FFN is SwiGLU, silu(x Wg) * (x Wu) Wd, or a router
softmax whose top_k experts (the lower index first on a tie) are
weighted by their renormalized probabilities. Then rmsnorm and the
head. Weights are the benchmark's seeded draws (``perfbench.weights``),
each quantized leaf replaced by its SPx round trip
(``perfbench.reference.spx``), one layer at a time, so the f32 weights
of the whole model are never held at once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench import weights
from perfbench.reference import spx

EPS = 1e-6


def _rmsnorm(x, g):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + EPS) * g


def _rope(x, pos, arch):
    """x (L, H, dh) rotated at positions pos (L,)."""
    dh = x.shape[-1]
    half = dh // 2
    inv = 1.0 / (arch["rope_theta"] ** (
        torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh))
    sections = arch.get("mrope_sections")
    streams = pos.to(torch.float32)[None, :].expand(3, -1)   # (t, h, w)
    if sections:
        sec = torch.repeat_interleave(
            torch.arange(3, device=x.device),
            torch.tensor(sections, device=x.device), output_size=half)
        ang = streams[sec].T * inv[None, :]                    # (L, dh/2)
    else:
        ang = streams[0][:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _lin(w, x, name):
    y = x @ w[name]["w"]
    b = w[name].get("b")
    return y if b is None else y + b


def _attention(w, h, arch):
    hq, hkv, dh = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    n = h.shape[0]
    pos = torch.arange(n, device=h.device)
    q = _rope(_lin(w, h, "wq").view(n, hq, dh), pos, arch)
    k = _rope(_lin(w, h, "wk").view(n, hkv, dh), pos, arch)
    v = _lin(w, h, "wv").view(n, hkv, dh)
    rep = hq // hkv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) * dh ** -0.5
    causal = torch.ones((n, n), dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
    return o.reshape(n, hq * dh) @ w["wo"]["w"]


def _swiglu(h, wg, wu, wd):
    return (F.silu(h @ wg) * (h @ wu)) @ wd


def _moe(w, h, arch):
    """h (N, D) -> (every token's top_k experts, weighted; the router
    logit of its k-th expert less that of its (k+1)-th)."""
    logits = h @ w["router"]["w"]
    k = arch["top_k"]
    top = torch.topk(logits, k + 1, dim=-1).values
    margin = top[:, k - 1] - top[:, k]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = vals[:, :k], idx[:, :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(arch["n_experts"]):
        hit = top_e == e
        rows = torch.nonzero(hit.any(dim=-1)).squeeze(1)
        if rows.numel() == 0:
            continue
        p = (top_p * hit)[rows].sum(dim=-1)
        ye = _swiglu(h[rows], w["gate"][e], w["up"][e], w["down"][e])
        y.index_add_(0, rows, ye * p[:, None])
    return y, margin


def _quantized(flat: dict, rule: dict) -> dict:
    """The layer's leaves as the configuration states them: SPx round
    trips where the rule says codes, f32 elsewhere."""
    return {path: (spx.fake_quantize(leaf, rule["scheme"])
                   if spx.is_quantized(path, leaf, rule) else leaf)
            for path, leaf in flat.items()}


def logits_at(arch: dict, rule: dict, seed: int, seqs: list, want: list,
              device) -> tuple:
    """Logits (n_i, V) of each sequence ``seqs[i]`` (token ids) at the
    positions ``want[i]`` (a range), in f32 under the current matmul
    precision settings; and at the same positions the smallest routing
    margin over the MoE layers (the router logit of the k-th expert less
    the (k+1)-th's; inf without MoE layers)."""
    g = weights.nest(_quantized(weights.global_weights(arch, seed, device),
                                rule))
    xs = [g["embed"]["table"][torch.as_tensor(s, device=device).long()]
          for s in seqs]
    head = g["embed"]["table"].T if arch["tie_embeddings"] else g["head"]["w"]
    final_g = g["final_norm"]["g"]
    del g
    margins = [torch.full((x.shape[0],), float("inf"), device=device)
               for x in xs]
    for layer in range(arch["n_layers"]):
        w = weights.nest(_quantized(
            weights.layer_weights(arch, seed, layer, device), rule))
        ffn = weights.layer_slot(arch, layer).partition("+")[2]
        xs = [x + _attention(w["attn"], _rmsnorm(x, w["norm1"]["g"]), arch)
              for x in xs]
        if ffn == "dense":
            xs = [x + _swiglu(_rmsnorm(x, w["norm2"]["g"]),
                              w["mlp"]["gate"]["w"], w["mlp"]["up"]["w"],
                              w["mlp"]["down"]["w"]) for x in xs]
        elif ffn == "moe":
            lens = [x.shape[0] for x in xs]
            h = torch.cat([_rmsnorm(x, w["norm2"]["g"]) for x in xs])
            y, margin = _moe(w["moe"], h, arch)
            xs = [x + part for x, part in zip(xs, torch.split(y, lens))]
            margins = [torch.minimum(m, part) for m, part in
                       zip(margins, torch.split(margin, lens))]
        del w
    return ([_rmsnorm(x[list(r)], final_g) @ head for x, r in zip(xs, want)],
            [m[list(r)] for m, r in zip(margins, want)])
