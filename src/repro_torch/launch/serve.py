"""Serving driver (the reference's ``repro.launch.serve``): build the
batched engine with SPx-quantized weights and run a synthetic request
wave, reporting latency, throughput and occupancy. On the card unless
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch gemma-2b --reduced --requests 3 --slots 2 --max-seq 32 \
      --new-tokens 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --kv-quant --kv-scheme spx_8_x3

The reference's flags, plus ``--device``. ``--arch`` takes every bundled
config: recurrent, hybrid and M-RoPE patterns serve through the state
cache's slab region, and an enc-dec config (whisper-small) runs with
synthetic input frames, two distinct inputs alternating across requests
so that identical inputs share one encoder pass (the cross region).

``--scheme`` quantizes the weights, ``--kv-quant --kv-scheme`` the KV
cache; ``--prefix-cache``, ``--spec-decode``, ``--no-fused-decode`` and
``--scheduler`` pick the paged engine's modes; ``--stream`` drives it
from an asyncio front-end and reports the time to the first *delivered*
token.

``--shards N`` runs the engine tensor-parallel (paged layout, the
``attn+dense`` patterns: head-sharded KV pools, replicated block tables);
``--replicas N`` stacks data-parallel engine replicas behind a
least-loaded router. ``REPRO_FORCE_DEVICE_COUNT=N`` lists the one device
N times (``launch.hostdev``), so that ``--shards 2`` runs on one card or
on the CPU.

The request wave is the reference's for the same ``--seed``: prompts
from ``np.random.default_rng(seed)``, whisper frames from
``default_rng(seed + 1)``. The weights come from a ``torch.Generator``
seeded with ``--seed``. It prints the reference's ``[serve]`` lines,
ending in ``[serve] metrics: {json}``.

Env knobs that reach serving are resolved in ``ServeConfig.resolve()``:
REPRO_PAGE_SIZE, REPRO_PREFILL_CHUNK, REPRO_PREFIX_CACHE, REPRO_SPEC_K,
REPRO_FUSED_DECODE, REPRO_SCHEDULER, REPRO_HOST_PAGES,
REPRO_PREFIX_CACHE_PAGES, REPRO_SHARDS and REPRO_REPLICAS.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import spx
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.runtime import Runtime, resolve_device
from repro_torch.serving import ReplicaRouter
from repro_torch.serving.engine import Request, ServeConfig, ServeEngine


def _run_streaming(eng, reqs, arrival_s: float):
    """Asyncio front-end over the tick-driven engine: one driver task
    steps the engine whenever it has work, a submitter feeds requests in
    over time (arrival overlaps compute), and one consumer per request
    drains ``async for tok in eng.stream(rid)`` as tokens are emitted —
    all on one event loop, no threads. Returns the finished list plus a
    per-rid monotonic stamp of the first *delivered* token, the
    user-visible TTFT the batch path cannot measure."""
    delivered: dict[int, float] = {}

    async def consume(req):
        async for _tok in eng.stream(req.rid):
            delivered.setdefault(req.rid, time.monotonic())

    async def submit_all(consumers):
        for req in reqs:
            eng.submit(req)
            consumers.append(asyncio.ensure_future(consume(req)))
            await asyncio.sleep(arrival_s)

    async def amain():
        consumers: list = []
        sub = asyncio.ensure_future(submit_all(consumers))
        # tick while anything is arriving or in flight, yielding after
        # every tick so consumers drain the tokens it just emitted
        while not sub.done() or eng.has_work():
            if eng.has_work():
                eng.step()
                await asyncio.sleep(0)
            else:
                await asyncio.sleep(arrival_s / 4)
        await sub
        await asyncio.gather(*consumers)

    asyncio.run(amain())
    return list(eng.finished), delivered


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--scheme", default="sp2_4",
                    help="SPx scheme for weights; 'none' = dense bf16")
    ap.add_argument("--kv-layout", default="auto",
                    choices=("auto", "paged", "dense"),
                    help="paged = block-table KV pool + chunked prefill")
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per KV page (default: planner-chosen)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="KV pool size in pages (default: dense-equivalent)")
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--prefix-cache", action="store_true", default=None,
                    help="share page-aligned prompt-prefix KV pages across "
                         "requests (paged layout only; REPRO_PREFIX_CACHE=1 "
                         "sets the default)")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="prepend the same N-token system prompt to every "
                         "synthetic request (exercises --prefix-cache)")
    ap.add_argument("--spec-decode", action="store_true", default=None,
                    help="prompt-lookup speculative decoding (paged layout "
                         "only; REPRO_SPEC_K=N sets the default)")
    ap.add_argument("--spec-k", type=int, default=None, metavar="K",
                    help="draft window for --spec-decode (default 4; "
                         "passing it alone implies --spec-decode)")
    fg = ap.add_mutually_exclusive_group()
    fg.add_argument("--fused-decode", dest="fused_decode",
                    action="store_true", default=None,
                    help="ragged decode megakernel: one attention launch "
                         "per decode tick (paged layout; default ON, "
                         "REPRO_FUSED_DECODE=0 flips the default)")
    fg.add_argument("--no-fused-decode", dest="fused_decode",
                    action="store_false",
                    help="per-call paged-attention kernels + page-gather "
                         "verify (the pre-megakernel decode path)")
    ap.add_argument("--scheduler", default=None, choices=("fifo", "cb"),
                    help="admission policy: cb = continuous batching with "
                         "priority preemption + KV offload (paged default), "
                         "fifo = synchronous head-blocks-queue baseline "
                         "(REPRO_SCHEDULER sets the default)")
    ap.add_argument("--host-pages", type=int, default=None, metavar="N",
                    help="host offload tier capacity in pages (paged "
                         "layout; default unbounded, REPRO_HOST_PAGES "
                         "sets the default)")
    ap.add_argument("--prefix-cache-pages", type=int, default=None,
                    metavar="N",
                    help="cached-free prefix index budget in pages — LRU "
                         "eviction past it (default unbounded, "
                         "REPRO_PREFIX_CACHE_PAGES sets the default)")
    ap.add_argument("--shards", type=int, default=None, metavar="N",
                    help="tensor-parallel shards over the 'model' mesh axis "
                         "(paged layout, attn+dense patterns; needs N "
                         "devices — REPRO_FORCE_DEVICE_COUNT=N runs N "
                         "shards on one device; REPRO_SHARDS sets the "
                         "default)")
    ap.add_argument("--replicas", type=int, default=None, metavar="N",
                    help="data-parallel engine replicas behind a "
                         "least-loaded router, each with a per-replica "
                         "page budget (REPRO_REPLICAS sets the default)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="quantize the KV cache to codes+scale pages")
    ap.add_argument("--kv-scheme", default="spx_8_x3",
                    choices=sorted(s for s in spx.SCHEMES
                                   if spx.code_width(
                                       spx.scheme_levels(s)) == 8),
                    help="level set for --kv-quant (8-bit-code schemes)")
    ap.add_argument("--kv-dtype", default="f32", choices=("f32", "bf16"),
                    help="unquantized KV cache element dtype")
    ap.add_argument("--stream", action="store_true",
                    help="asyncio front-end: request arrival overlaps "
                         "engine ticks and each request's tokens are "
                         "consumed as they are emitted (async for over "
                         "engine.stream(rid)) — TTFT becomes time to "
                         "first *delivered* token. docs/SERVING.md, "
                         "'Streaming delivery and cancellation'.")
    ap.add_argument("--arrival-ms", type=float, default=0.0, metavar="MS",
                    help="gap between request arrivals under --stream "
                         "(0 = back-to-back, still interleaved with ticks)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the engine runs: the card by default "
                         "(raises without one), 'cpu' for the plain "
                         "PyTorch versions of the kernels")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)

    # the driver serves every bundled architecture: decoder-only configs
    # (dense/MoE/SSM/hybrid/M-RoPE) through the LM assembly, enc-dec
    # through the encoder-decoder assembly with synthetic input frames —
    # two distinct inputs alternating across requests, so the state
    # cache's shared cross-KV region sees hits (docs/SERVING.md)
    # weights from a torch.Generator seeded with --seed (the reference's
    # draws cannot be reproduced); the request wave from its numpy
    # generators
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if cfg.enc_dec:
        params = encdec_mod.encdec_init(gen, cfg, device=device)
        fr_rng = np.random.default_rng(args.seed + 1)
        frame_sets = fr_rng.standard_normal(
            (2, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    else:
        params = lm_mod.lm_init(gen, cfg, device=device)
        frame_sets = None
    scheme = None if args.scheme == "none" else args.scheme
    rt = Runtime(q_chunk=256, kv_quant=args.kv_quant,
                 kv_scheme=args.kv_scheme, device=str(device))
    sconf = ServeConfig(
        batch_slots=args.slots, max_seq=args.max_seq, quantize=scheme,
        kv_layout=args.kv_layout, page_size=args.page_size,
        pool_pages=args.pool_pages, prefill_chunk=args.prefill_chunk,
        kv_cache_dtype=("bfloat16" if args.kv_dtype == "bf16"
                        else "float32"),
        prefix_cache=args.prefix_cache,
        spec_decode=args.spec_decode, spec_k=args.spec_k,
        fused_decode=args.fused_decode,
        scheduler=args.scheduler, host_pages=args.host_pages,
        prefix_cache_pages=args.prefix_cache_pages,
        shards=args.shards, replicas=args.replicas).resolve(cfg)
    if sconf.replicas > 1:
        eng = ReplicaRouter(params, cfg, sconf, rt=rt)
    else:
        eng = ServeEngine(params, cfg, sconf, rt=rt)

    rng = np.random.default_rng(args.seed)
    sys_prompt = (rng.integers(0, cfg.vocab_size, args.shared_prefix)
                  .astype(np.int32))
    # each request must fit shared prefix + tail + new tokens in max_seq
    tail_cap = args.max_seq - args.shared_prefix - args.new_tokens
    if tail_cap < 2:
        raise SystemExit(
            f"--shared-prefix {args.shared_prefix} leaves no room for a "
            f"prompt tail (max-seq {args.max_seq}, new-tokens "
            f"{args.new_tokens})")
    hi = max(2, min(args.max_seq // 4, tail_cap))
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(min(4, hi - 1), hi))
        prompt = np.concatenate(
            [sys_prompt,
             rng.integers(0, cfg.vocab_size, plen).astype(np.int32)])
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new_tokens=args.new_tokens,
                            frames=(None if frame_sets is None
                                    else frame_sets[i % 2])))
    t0 = time.monotonic()
    if args.stream:
        done, delivered = _run_streaming(eng, reqs,
                                         args.arrival_ms / 1e3)
    else:
        for req in reqs:
            eng.submit(req)
        done = eng.run()
    dt = time.monotonic() - t0
    n_tok = sum(len(r.output) for r in done)
    m = eng.metrics()
    # router metrics carry fleet sums; per-engine facts (layout, dtype,
    # pool geometry) live in the untouched per-replica dicts
    m0 = m["per_replica"][0] if sconf.replicas > 1 else m
    print(f"[serve] {len(done)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s), median TTFT {m['ttft_p50_ms']:.0f}ms "
          f"scheme={scheme} layout={m0['kv_layout']} "
          f"kv={m0['kv_scheme']}/{m0['kv_cache_dtype']}")
    if sconf.replicas > 1:
        print(f"[serve] router: {m['replicas']} replicas x {m['shards']} "
              f"shard(s), finished per replica "
              f"{m['requests_per_replica']}, fleet peak KV "
              f"{m['peak_kv_bytes'] / 2**20:.2f} MiB")
    if args.stream:
        sttft = sorted(delivered[r.rid] - r.t_enqueue for r in done)
        print(f"[serve] streaming: delivered TTFT p50 "
              f"{1e3 * sttft[len(sttft) // 2]:.0f}ms over "
              f"{len(done)} consumers (whole-request latency p50 "
              f"{m['latency_p50_ms']:.0f}ms)")
    if sconf.replicas == 1 and m["kv_layout"] == "paged":
        print(f"[serve] pages: {m['n_pages']} x {m['page_size']} tok, "
              f"occupancy mean {m['occupancy_mean']:.2f} / "
              f"peak {m['occupancy_peak']:.2f}, "
              f"peak KV {m['peak_kv_bytes'] / 2**20:.2f} MiB, "
              f"denials {m['admission_denials']}")
        if m["shards"] > 1:
            print(f"[serve] sharded: {m['shards']} shards, kv_sharded="
                  f"{m['kv_sharded']}, {m['kv_heads_per_shard']} KV "
                  f"head(s)/shard, peak KV/shard "
                  f"{m['peak_kv_bytes_per_shard'] / 2**20:.2f} MiB")
        if m["slab_bytes_per_seq"] or m["cross_bytes_per_entry"]:
            print(f"[serve] state cache: peak "
                  f"{m['peak_state_bytes'] / 2**20:.2f} MiB "
                  f"(slabs {m['peak_slabs']} x "
                  f"{m['slab_bytes_per_seq'] / 2**20:.2f} MiB, cross "
                  f"{m['peak_cross']} x "
                  f"{m['cross_bytes_per_entry'] / 2**20:.2f} MiB, "
                  f"{m['cross_hits']}/{m['cross_lookups']} cross hits)")
        if m["scheduler"] == "cb":
            host_cap = ("inf" if m["host_pages"] is None
                        else m["host_pages"])
            print(f"[serve] cb scheduler: {m['preemptions']} preemptions, "
                  f"{m['resumes']} resumes, "
                  f"{m['offload_bytes'] / 2**10:.1f} KiB offloaded, "
                  f"host tier peak {m['peak_host_pages']}/{host_cap} pages")
        if m["prefix_cache"]:
            print(f"[serve] prefix cache: {m['prefix_hits']} hits, "
                  f"{m['prefill_tokens_skipped']} prefill tokens skipped, "
                  f"{m['cow_copies']} COW copies, hit rate "
                  f"{m['prefix_hit_rate']:.2f}, "
                  f"{m['prefix_evictions']} evictions")
        if m["spec_decode"]:
            print(f"[serve] spec decode: K={m['spec_k']}, "
                  f"{m['model_calls']} model calls, "
                  f"{m['accepted_per_step']:.2f} accepted/step, "
                  f"acceptance {m['draft_acceptance_rate']:.2f}")
    print("[serve] metrics: " + json.dumps(m, sort_keys=True))
    return done


if __name__ == "__main__":
    main()
