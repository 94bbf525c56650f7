"""Seeded f32 weights, drawn on the device: the benchmark's input to both
the program and the reference. Imports torch only.

Each layer draws its leaves from its own generator, seeded from (run
seed, layer), in one ``randn`` call that is cut into the leaves; the
embedding, the final norm and the head draw from a generator of their
own. So a layer can be drawn again alone, identical, on the same device.
Leaves are named by the port's parameter paths, which is the interface
the program takes its weights through:

* matrices: N(0, 1) / sqrt(fan_in) (expert stacks per expert);
* norm gains: 1 + N(0, 1) / 10; biases: N(0, 1) / 10 (random, so a
  missing gain or bias shows).
"""
from __future__ import annotations

import hashlib

import torch


def derive_seed(seed: int, tag: str) -> int:
    h = hashlib.blake2b(f"{int(seed)}:{tag}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def layer_slot(arch: dict, layer: int) -> str:
    pattern = arch["pattern"]
    return pattern[layer % len(pattern)]


def layer_spec(arch: dict, layer: int) -> list:
    """[(path, shape, init)] of one layer, init a scale or "gain" /
    "bias"."""
    if arch["norm"] != "rmsnorm":
        raise ValueError(f"no weights rule for norm {arch['norm']!r}")
    d, dh, f = arch["d_model"], arch["head_dim"], arch["d_ff"]
    hq, hkv = arch["n_heads"], arch["n_kv_heads"]
    mixer, _, ffn = layer_slot(arch, layer).partition("+")
    if mixer != "attn":
        raise ValueError(f"no weights rule for mixer {mixer!r}")
    spec = [(("norm1", "g"), (d,), "gain")]
    for name, n_out in (("wq", hq * dh), ("wk", hkv * dh), ("wv", hkv * dh)):
        spec.append((("attn", name, "w"), (d, n_out), d ** -0.5))
        if arch["qkv_bias"]:
            spec.append((("attn", name, "b"), (n_out,), "bias"))
    spec.append((("attn", "wo", "w"), (hq * dh, d), (hq * dh) ** -0.5))
    if ffn:
        spec.append((("norm2", "g"), (d,), "gain"))
    if ffn == "dense":
        if arch["mlp_variant"] != "swiglu":
            raise ValueError(f"no weights rule for {arch['mlp_variant']!r}")
        spec += [(("mlp", "up", "w"), (d, f), d ** -0.5),
                 (("mlp", "gate", "w"), (d, f), d ** -0.5),
                 (("mlp", "down", "w"), (f, d), f ** -0.5)]
    elif ffn == "moe":
        e = arch["n_experts"]
        if arch.get("n_shared_experts"):
            raise ValueError("no weights rule for shared experts")
        spec += [(("moe", "router", "w"), (d, e), d ** -0.5),
                 (("moe", "gate"), (e, d, f), d ** -0.5),
                 (("moe", "up"), (e, d, f), d ** -0.5),
                 (("moe", "down"), (e, f, d), f ** -0.5)]
    elif ffn:
        raise ValueError(f"no weights rule for ffn {ffn!r}")
    return spec


def globals_spec(arch: dict) -> list:
    d, v = arch["d_model"], arch["vocab_size"]
    spec = [(("embed", "table"), (v, d), d ** -0.5),
            (("final_norm", "g"), (d,), "gain")]
    if not arch["tie_embeddings"]:
        spec.append((("head", "w"), (d, v), d ** -0.5))
    return spec


def _draw(spec: list, seed: int, device) -> dict:
    """{path: f32 tensor} of ``spec``, from one randn call."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(_numel(shape) for _, shape, _ in spec)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for path, shape, init in spec:
        n = _numel(shape)
        piece = flat[off:off + n].view(shape)
        if init == "gain":
            out[path] = 1.0 + 0.1 * piece
        elif init == "bias":
            out[path] = 0.1 * piece
        else:
            out[path] = piece * init
        off += n
    del flat
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def layer_weights(arch: dict, seed: int, layer: int, device) -> dict:
    return _draw(layer_spec(arch, layer), derive_seed(seed, f"layer{layer}"),
                 device)


def global_weights(arch: dict, seed: int, device) -> dict:
    return _draw(globals_spec(arch), derive_seed(seed, "globals"), device)


def nest(flat: dict) -> dict:
    """{path tuple: leaf} -> nested dicts."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
