"""End-to-end LM training (``examples/train_llm.py`` of the reference): a
~100M-parameter dense transformer (granite family, shrunk: 8 layers,
d_model 640, 8 query heads over 2 KV heads of 80, vocab 8192) trained on
the synthetic Markov corpus, with optional checkpointing and SPx gradient
compression. On the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.examples.train_llm --steps 300
  PYTHONPATH=src python -m repro_torch.examples.train_llm --tiny --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.models import lm as lm_mod
from repro_torch.nn.layers import tree_leaves
from repro_torch.runtime import Runtime, resolve_device
from repro_torch.training import (GradCompressor, TrainConfig, TrainLoop,
                                  make_optimizer)


def make_100m_cfg():
    base = get_config("granite-3-8b")
    return dataclasses.replace(
        base, name="granite-100m", n_layers=8, d_model=640, n_heads=8,
        n_kv_heads=2, head_dim=80, d_ff=1792, vocab_size=8192)


def main(argv=None):
    """Train; returns the loss history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = make_100m_cfg()
    if args.tiny:
        cfg = dataclasses.replace(cfg, n_layers=2, d_model=128, n_heads=4,
                                  n_kv_heads=2, head_dim=32, d_ff=256,
                                  vocab_size=512)
        args.steps = min(args.steps, 30)
        args.seq, args.batch = 64, 8

    rt = Runtime(q_chunk=min(512, args.seq), device=str(device))

    def init_params():
        gen = torch.Generator(device=device).manual_seed(0)
        p = lm_mod.lm_init(gen, cfg, device=device)
        n = sum(leaf.numel() for leaf in tree_leaves(p))
        print(f"[train_llm] {cfg.name}: {n / 1e6:.1f}M params")
        return p

    comp = GradCompressor(args.compress_grads) if args.compress_grads else None
    tc = TrainConfig(max_steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=100, log_every=10)
    data = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=0)
    try:
        loop = TrainLoop(lambda p, b: lm_mod.lm_loss(p, b, cfg, rt),
                         make_optimizer("adamw", lr=3e-3), init_params,
                         iter(data), tc, compressor=comp)
        _, hist = loop.run()
        uniform = math.log(cfg.vocab_size)
        first = np.mean([h["loss"] for h in hist[:5]])
        last = np.mean([h["loss"] for h in hist[-5:]])
        print(f"[train_llm] loss {first:.3f} -> {last:.3f} "
              f"(uniform {uniform:.3f}); structure learned: "
              f"{'yes' if last < uniform * 0.75 else 'no'}")
        return hist
    finally:
        data.close()


if __name__ == "__main__":
    main()
