"""End-to-end training entry point (``repro.launch.train``), on the card
unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch gemma-2b --reduced --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --batch 2 --seq 256 --optimizer adamw_q8

Decoder-only configs train through ``models.lm.lm_loss``; an enc-dec
config (whisper-small) through ``models.encdec.encdec_loss`` with zero
encoder frames. ``--ckpt-dir`` checkpoints every ``--ckpt-every`` steps
and at the end, and a rerun resumes from the latest; ``--kill-at-step``
injects a failure there; ``--compress-grads sp2_8`` turns on SPx gradient
compression with error feedback. Weights come from a ``torch.Generator``
seeded with ``--seed`` on the device; batches from the Markov token
stream of the same seed.
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.tokens import TokenStream
from repro_torch.models import encdec as ed
from repro_torch.models import lm as lm_mod
from repro_torch.runtime import Runtime, resolve_device
from repro_torch.training import (GradCompressor, TrainConfig, TrainLoop,
                                  make_optimizer)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving small config (CPU-runnable)")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["sgd", "adamw", "adamw_q8"])
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--kill-at-step", type=int, default=None)
    ap.add_argument("--compress-grads", default=None,
                    help="SPx scheme for gradient compression, e.g. sp2_8")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Train; returns the loss history (one record per step taken)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, d_model=args.d_model,
                      n_layers=args.layers or None)
    rt = Runtime(q_chunk=min(1024, args.seq), device=str(device))
    loss_mod = ed.encdec_loss if cfg.enc_dec else lm_mod.lm_loss

    def loss_fn(params, batch, rt):
        if cfg.enc_dec and "frames" not in batch:
            b = batch["tokens"].shape[0]
            batch = dict(batch, frames=torch.zeros(
                (b, cfg.enc_seq_len, cfg.d_model), device=device))
        return loss_mod(params, batch, cfg, rt)

    def init_params():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        init = ed.encdec_init if cfg.enc_dec else lm_mod.lm_init
        return init(gen, cfg, device=device)

    comp = GradCompressor(args.compress_grads) if args.compress_grads else None
    tc = TrainConfig(max_steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, log_every=10,
                     accum_steps=args.accum, kill_at_step=args.kill_at_step,
                     compress_grads=args.compress_grads)
    data = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
    try:
        loop = TrainLoop(loss_fn, make_optimizer(args.optimizer, lr=args.lr),
                         init_params, iter(data), tc, compressor=comp, rt=rt)
        _, hist = loop.run()
        print(f"[train] done: {hist[-1]['loss']:.4f} final loss "
              f"(uniform={math.log(cfg.vocab_size):.2f})")
        return hist
    finally:
        data.close()


if __name__ == "__main__":
    main()
