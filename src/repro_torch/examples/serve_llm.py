"""Batched LM serving with SPx-quantized weights (``examples/serve_llm.py``
of the reference): train a small LM briefly (so the weights are not
random), quantize it to the paper's 4-bit SP2, and serve a batch of
requests through the engine, comparing f32 and quantized weights, the
dense and the paged KV layouts, SPx-coded KV pages, shared prefix pages
and speculative decoding (throughput, occupancy, agreement). On the card
unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.examples.serve_llm --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_llm --arch whisper-small

``--arch`` takes any bundled config, reduced. Each runs the axes its
pattern supports: recurrent and hybrid patterns compare the weight and
layout axes only; whisper-small (random weights, synthetic input frames,
no training) adds speculation back.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.tokens import TokenStream
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.runtime import Runtime, resolve_device
from repro_torch.serving import Request, ServeConfig, ServeEngine
from repro_torch.training import TrainConfig, TrainLoop, make_optimizer


def main(argv=None):
    """Serve every axis; returns {axis tag: {rid: tokens}}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b",
                    help="any bundled config (each runs the axes its "
                         "layer pattern supports)")
    ap.add_argument("--train-steps", type=int, default=40)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    cfg = (reduced(cfg, d_model=128, vocab=512)
           if args.arch == "gemma-2b" else reduced(cfg))
    rt = Runtime(q_chunk=64, device=str(device))
    mixers = {s.split("+")[0] for s in cfg.pattern}
    recurrent = bool(mixers & {"mamba", "mlstm", "slstm"})
    gen = torch.Generator(device=device).manual_seed(0)

    if cfg.enc_dec:
        # random weights and synthetic frames: two distinct inputs
        # alternate, so the shared cross region sees encoder-pass reuse
        params = encdec_mod.encdec_init(gen, cfg, device=device)
        frame_sets = np.random.default_rng(1).standard_normal(
            (2, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    else:
        # brief training so the engine serves learned weights
        frame_sets = None
        data = TokenStream(cfg.vocab_size, 8, 64, seed=0)
        try:
            loop = TrainLoop(lambda p, b: lm_mod.lm_loss(p, b, cfg, rt),
                             make_optimizer("adamw", lr=3e-3),
                             lambda: lm_mod.lm_init(gen, cfg, device=device),
                             iter(data),
                             TrainConfig(max_steps=args.train_steps,
                                         log_every=20))
            params, _ = loop.run()
        finally:
            data.close()

    rng = np.random.default_rng(0)
    # every request opens with the same 16-token system prompt: the
    # prefix-cache axis shares its pages across requests
    sys_prompt = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    prompts = [np.concatenate(
        [sys_prompt,
         rng.integers(0, cfg.vocab_size,
                      int(rng.integers(4, 16))).astype(np.int32)])
        for _ in range(args.requests)]

    # axes: weights (f32 vs sp2_4) x KV layout (dense slots, paged, paged
    # with SPx-coded pages) x shared prefix pages x prompt-lookup
    # speculation; the pattern-gated ones only where the engine takes them
    axes = [(None, "dense", False, False, False),
            ("sp2_4", "dense", False, False, False),
            ("sp2_4", "paged", False, False, False)]
    if not (recurrent or cfg.enc_dec):
        axes += [("sp2_4", "paged", True, False, False),
                 ("sp2_4", "paged", False, True, False)]
    if not recurrent:
        axes += [("sp2_4", "paged", False, False, True)]

    results = {}
    for scheme, layout, kvq, share, spec in axes:
        tag = (f"{scheme or 'dense'}/{layout}{'+kvq' if kvq else ''}"
               f"{'+share' if share else ''}{'+spec' if spec else ''}")
        ert = rt.replace(kv_quant=True, kv_scheme="spx_8_x3") if kvq else rt
        eng = ServeEngine(params, cfg,
                          ServeConfig(batch_slots=4, max_seq=64,
                                      quantize=scheme, kv_layout=layout,
                                      prefix_cache=share, spec_decode=spec),
                          rt=ert)
        t0 = time.monotonic()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p,
                               max_new_tokens=args.new_tokens,
                               frames=(None if frame_sets is None
                                       else frame_sets[i % 2])))
        done = eng.run()
        dt = time.monotonic() - t0
        n_tok = sum(len(r.output) for r in done)
        results[tag] = {r.rid: r.output for r in done}
        m = eng.metrics()
        extra = (f" pages {m['n_pages']}x{m['page_size']} "
                 f"occ {m['occupancy_mean']:.2f}"
                 if layout == "paged" else "")
        if share:
            extra += (f" hits {m['prefix_hits']}"
                      f" skipped {m['prefill_tokens_skipped']}tok")
        if spec:
            extra += (f" calls {m['model_calls']}"
                      f" acc {m['draft_acceptance_rate']:.2f}")
        print(f"[serve_llm] {tag:12s}: {n_tok} tokens in {dt:.2f}s "
              f"({n_tok / dt:.0f} tok/s) peak state "
              f"{m['peak_state_bytes'] / 2**10:.0f} KiB{extra}")

    # lossy axes (weights, coded pages) report token agreement; every
    # same-weights axis (layout, sharing, speculation) is exact by
    # construction and reports exact-output agreement
    def tok_agree(a, b):
        return float(np.mean([
            np.mean(np.array(results[a][i]) == np.array(results[b][i]))
            for i in range(args.requests)]))

    def exact_agree(a, b):
        return float(np.mean([results[a][i] == results[b][i]
                              for i in range(args.requests)]))

    print(f"[serve_llm] dense vs sp2_4 greedy-token agreement: "
          f"{tok_agree('dense/dense', 'sp2_4/dense'):.2f}")
    print(f"[serve_llm] dense vs paged KV exact-output agreement: "
          f"{exact_agree('sp2_4/dense', 'sp2_4/paged'):.2f}")
    for tag, what, agree in (
            ("sp2_4/paged+kvq", "f32 vs SPx-quantized KV pages token",
             tok_agree),
            ("sp2_4/paged+share",
             "private vs shared prefix pages exact-output", exact_agree),
            ("sp2_4/paged+spec",
             "plain vs speculative decode exact-output", exact_agree)):
        if tag in results:
            print(f"[serve_llm] {what} agreement: "
                  f"{agree('sp2_4/paged', tag):.2f}")
    return results


if __name__ == "__main__":
    main()
