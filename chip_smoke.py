#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing JSON lines:

  1. device   the card, ``nvidia-smi``'s name and power limit, TF32 off;
  2. build    nvcc builds every kernel from ``src/repro_torch/kernels/csrc``;
              cuobjdump counts each library's tensor-core instructions;
  3. kernels  each hand-written kernel against its plain PyTorch version on
              the card, at the shapes the serving path gives it and on edge
              rows (empty slots, ragged windows, ragged lengths):
              spx_matmul at M in {1, 3, 4, 8} (decode kernel) and {9, 37,
              64, 65, 128, 256} (the tensor-core prefill kernel), also at
              the paper MLP's layers (784, 128) and (128, 10) and M = 1024
              and 2048, and the Q-network's (4, 64) and (64, 64) at M = 1
              and 64 (the small-layer kernel; each key's kernel is
              recorded, and a gate requires the 24 §4 keys on the small
              kernel and gemma-2b's on the decode and prefill kernels),
              the ragged decode kernel at a w = 5 verify window
              that crosses a page boundary, kernels 2 and 5 over bf16 and
              f16 pages (the tensor-core kernel: head dims 32 to 256, page
              sizes 32 and 16, w in {1, 5, 8}, contexts 0 to 2048, each
              slot within BF16_ATTN_RTOL / F16_ATTN_RTOL of its own peak;
              on f16 pages also a case whose probabilities are all f16
              subnormals, within 1e-5), flash attention up to 2048
              tokens; second launches bit-identical; then every shape the
              four families of ``serve_families`` give the kernels:
              spx_matmul at each (K, N) of their projections (N = 8 and
              160, K = 128 among them) and every M their ticks give it,
              kernels 2 and 5 at head_dim 128 with GQA ratios 1, 6 and 8,
              flash attention at olmoe's heads; and every shape
              whisper-small gives them (``whisper_kernel_phase``): flash
              attention not causal at head_dim 64 over 1500 encoder frames
              (the encoder, the cross-attention of every paged tick and
              dense step) and the dense prefill's causal self-attention,
              kernels 2, 3 and 5 at head_dim 64 with 12 KV heads (f32,
              bf16 and code pages), spx_matmul at M = 1500 and every M of
              the whisper ticks; and flash attention at every shape the
              train phase launches (``train_kernel_phase``: gemma-2b,
              granite-100m, whisper's encoder, decoder and
              cross-attention, all at their training batches); and every
              per-shard shape of the shards=2 runs
              (``sharded_kernel_phase``): spx_matmul at one shard's
              column and row cuts of gemma-2b and qwen2-vl-2b at M in
              SHARD_MS, kernels 2, 3, 5 and 6 at one shard's heads (4
              query heads over gemma's one KV head of 256, 6 over one of
              qwen2-vl's two of 128), w = 1 and 5, and one shard's
              shapes of olmoe-1b-7b, xlstm-350m, whisper-small (its
              encoder at M = 1500, flash over 1500 frames at 6 heads) and
              full-width jamba at one period (also its shards=1 shapes);
              and every shape of
              the router and serve_cli runs (``tier_kernel_phase``):
              spx_matmul at gemma-2b's (K, N) at M in TIER_MS, kernels 2
              (w = 1) and 5 at its heads with the block tables of
              max_seq 256 and 128; every per-shard shape of the wide runs
              (``wide_kernel_phase``: qwen2-vl-2b at 4 shards, 3 query
              heads over one KV head of 128 read as a view of the
              replicated pool; whisper-small at 8, head groups of 2 and 1
              over views of its 12 replicated KV heads; spx_matmul at every
              shard's uneven cut, flash at whisper's per-shard heads); and
              every shape of serve_mesh (``mesh_kernel_phase``):
              spx_matmul at gemma-2b's 4-shard cut and at its whole
              weights at the mesh steps' and the one-device steps' M,
              flash attention at a tensor-parallel shard's 2 heads over
              512 tokens and at the context-parallel shards' 128 rows
              over 512 keys with causal offsets 0, 128, 256 and 384; and
              whisper-small's: spx_matmul at its whole weights at M = 3000,
              896, 24000 and 7168 and at its 4-shard cut at M = 12000 and
              3584, flash attention at a context-parallel shard's encoder
              (375 rows over 1500 frames, not causal, at every shard's
              offset, which must change nothing), decoder (112 over 448
              keys at offsets 0, 112, 224, 336) and cross-attention (112
              over 1500), and at the tensor-parallel and one-device
              steps' heads;
  4. paper_mlp the paper's 784-128-10 sigmoid MLP (§4.1), random weights
              from a seed quantized to sp2_4, on 1024 procedural digits:
              two spx_matmul launches per forward, both on the
              small-layer kernel, outputs against the plain version, time
              per sample at batch 1, 64 and 1024 for the sp2_4 and the f32
              torch.matmul arm;
     paper_experiments  the paper's §4 through the port's entry points:
              ``examples.quickstart`` (4 epochs of SGD, then test accuracy
              per scheme, held to tests/test_system.py's bars),
              ``benchmarks.table1`` (time and energy per sample, power
              from nvidia-smi), ``benchmarks.fig5`` (time per sample
              against batch, §3.1 margins on H100_SXM),
              ``benchmarks.quant_quality`` and ``examples.rl_qlearning``
              (120 episodes, returns per scheme); every quantized arm
              through spx_matmul's small-layer kernel, at shapes the
              kernel phase checked on it;
  5. serve    full-width gemma-2b (18 layers, d_model 2048, vocab 256000,
              random weights from a seed, quantized to sp2_4) served three
              ways, each engine answering the same 8 greedy requests of 16
              new tokens, one prompt of 33 tokens so that a one-token
              prefill chunk reaches the single-token kernel:
                paged   ``ServeEngine(params, cfg, ServeConfig())``;
                quant   the same weights (``ServeConfig(quantize=None)``)
                        with ``Runtime(kv_quant=True, kv_scheme="spx_8_x3")``:
                        an SPx-coded KV cache;
                dense   ``ServeConfig(kv_layout="dense", quantize=None)``:
                        whole-prompt prefill through the flash kernel;
                unfused ``ServeConfig(fused_decode=False)``: paged_attention
                        in every layer of every one-token step;
                spec    ``ServeConfig(spec_decode=True, spec_k=4)``: W = 5
                        verify windows through the fused tick, with a
                        drafter replaying the paged engine's tokens, then
                        the prompt-lookup drafter on repetitive prompts;
                prefix  ``ServeConfig(prefix_cache=True)``: requests that
                        share a 64-token prefix, and a whole repeat (the
                        copy-on-write copy);
                paged-bf16, unfused-bf16, dense-bf16
                        ``ServeConfig(kv_cache_dtype="bfloat16")`` on the
                        fused tick, the unfused tick and the dense layout,
                        each held to the same engine on the plain versions
                        (``Runtime(impl="ref")``), a difference allowed
                        only at a near-tie (BF16_E2E_RTOL);
                paged-f16, unfused-f16
                        ``ServeConfig(kv_cache_dtype="float16")`` on the
                        fused and the unfused tick (kernels 2 and 5's
                        ``F16Mma`` instance), held to the f32-page engine
                        up to a near-tie (F16_E2E_RTOL).
              Every kernel of each path must launch, as often per tick or
              per request as the path says, and no plain version may run;
              the last three give the paged engine's greedy tokens, or
              differ first where its top-2 logit gap is a near-tie;
     autotune the planner's knobs (``runtime/planner.py``): gemma-2b on
              paged f32 and paged bf16 pages, the 8 requests served with
              the knobs unset and again under ``REPRO_AUTOTUNE=1`` (tokens
              equal but at a near-tie, E2E_RTOL); the paper MLP at M = 1,
              64 and 1024 and the Q-network at M = 1 under autotune; each
              measured key printed (the analytical launch and its device
              ms, the winner and its, the candidates tried, the seconds)
              after every candidate it timed was launched once more
              against its plain version; pinned launches
              (``REPRO_BLOCKS_MATMUL`` on the small and the decode kernel,
              ``REPRO_BLOCKS_ATTN`` at dh 256 and 128) against their plain
              versions, an illegal pin of each kind raising; every knob
              unset and every plan table empty after;
     serve_families  olmoe-1b-7b, xlstm-350m and qwen2-vl-2b at their
              published widths and depths, and jamba-1.5-large at one
              period (8 layers, d_model 2048; the cuts listed under
              ``reduced``), built on the card from a seed and quantized to
              sp2_4 one period at a time (expert stacks too), each
              answering the 8 requests through ``ServeConfig()``: tokens
              held to the same engine on the plain versions (a difference
              only at a near-tie, E2E_RTOL); olmoe (capacity factor 64)
              and xlstm also on the dense layout, held to the paged
              tokens; xlstm with one injected preemption; one spx_matmul
              launch per quantized projection in every model step and one
              paged kernel per attention layer (none for xlstm); every
              launch at a shape checked in phase 3; per family the
              spx_matmul decode tick and the MoE experts' tick timed;
              olmoe and xlstm then also at ``ServeConfig(shards=2)``
              on the same weights (``REPRO_FORCE_DEVICE_COUNT=2``: the
              MoE expert-parallel, the recurrent mixers whole on each
              shard), held to the shards=1 run (a difference only at a
              near-tie), per model step one spx_matmul per shard and
              projection and one paged kernel per shard and attention
              layer, every launch at a shape ``sharded_kernel_phase``
              checked; one shard's kernels timed (``serve_sharded``
              lines);
     serve_jamba  jamba-1.5-large at one period and full width (d_model
              8192, 64 query heads over 8 KV heads, 16 experts of 8192 x
              24576), sp2_4 weights drawn an expert at a time, the 8
              requests at shards=1 and shards=2 (a ``serve_sharded`` line:
              tokens held to shards=1 up to a near-tie, launches per model
              step, one shard's kernels timed);
     serve_whisper  whisper-small at full width and depth (12 + 12
              layers, 1500 encoder frames), sp2_4 weights from a seed, the
              8 requests over 3 distinct encoder inputs through
              ``ServeConfig()``: 3 encoder passes (the rest served from the
              shared cross region: cross_hits >= 5, peak_cross <= 3,
              110,592,000 B per entry), every launch at a checked shape,
              launches per encoder pass and per model step, tokens against
              the plain versions, the dense layout and spec decoding
              (spec_k = 4), up to a near-tie; the encoder pass's
              spx_matmul, the encoder's and the cross-attention's flash
              launches and kernel 2 at head_dim 64 timed; then the same
              at shards=2 (6 heads per shard, the vocabulary cut on d),
              held to the shards=1 run;
     train    the flash kernel's ``autograd.Function`` against plain
              autograd at every training shape of phase 3;
              ``launch.train.main`` on full-width gemma-2b (2 x 256
              tokens): adamw_q8 killed at step 2 and resumed from its
              checkpoint (the resumed step-3 loss equal to an unbroken
              run's), one adamw step; whisper-small through
              ``launch.train`` (zero frames, one step) and ``TrainLoop`` on
              seeded frames (3 steps); ``examples/train_llm.py`` (granite-100m,
              TRAIN_LLM_STEPS steps); per run ms per step,
              max_memory_allocated, and every flash launch through the
              Function at a shape checked in phase 3; the Function's
              forward timed over a training step;
     train_mesh  gemma-2b's train step (``launch.steps.build_train_step``)
              at full width and depth under mesh (data 2, model 4) on the
              one card (``REPRO_FORCE_DEVICE_COUNT`` = 8), f32, remat
              full: fsdp (8 x 256 tokens, adamw) and tp (4 x 256, adamw_q8,
              2 microbatches), 2 steps each beside the one-device step
              from the same weights: each loss within E2E_RTOL, the
              update per leaf, AdamW-Q8's scales per device, host ms,
              max_memory_allocated, per-device bytes of params and
              optimizer state, flash launches per step by shape (every
              one checked in ``train_mesh_kernel_phase``), the collective
              counters of each step;
     serve_sharded  tensor-parallel serving on the one card
              (``REPRO_FORCE_DEVICE_COUNT=2``, set here for this phase
              only, lists it twice):
              full-width gemma-2b on the serve phase's weights at
              ``ServeConfig(quantize=None, shards=2)`` on the fused tick,
              the unfused tick, spec decoding (spec_k = 4) and coded
              pages, and qwen2-vl-2b at full width, whose two KV heads
              head-shard its pools (``kv_sharded`` true, per-shard KV bytes
              half); each held to the same config at shards=1 (a
              difference only at a near-tie), every launch at a shape
              ``sharded_kernel_phase`` checked, per model step one
              spx_matmul per shard and projection and one paged kernel per
              shard and layer; one shard's kernels timed (the ``shards2``
              entries of the kernels line);
     serve_wide  the widths the port refused before it cut heads
              unevenly (``REPRO_FORCE_DEVICE_COUNT`` = 4 and 8):
              qwen2-vl-2b at shards=4 on serve_sharded's weights and
              whisper-small at shards=8 on serve_whisper's, each held to
              its shards=1 run (a difference only at a near-tie), every
              launch at a checked shape, per model step one spx_matmul per
              shard and projection and one paged kernel per shard and
              layer; one shard's kernels timed (whisper: a 2-head and a
              1-head shard);
     serve_mesh  gemma-2b's serve steps (``launch.steps.build_serve_step``)
              at mesh (data 2, model 4) on the one card
              (``REPRO_FORCE_DEVICE_COUNT`` = 8), 16 rows, a 512-token f32
              cache: the tensor-parallel prefill, the context-parallel
              prefill (the flash kernel with causal offsets 0, 128, 256,
              384) and 16 decode steps against the sequence-sharded cache,
              each beside the one-device step: host ms,
              max_memory_allocated, launches by kernel and by shape
              (every one checked), logits and caches within E2E_RTOL,
              prefill reruns bit-identical, no plain version run; the
              weights stored as the reference's ``make_policy`` cuts them
              (FSDP over data: 2.51B params); per-device bytes of weights
              and cache blocks, the collective counters of a step; then
              full-width whisper-small at the same mesh, 16 rows of 1500
              frames and a 448-token prompt: the context-parallel
              prefill (weights whole on every device, both sequences cut
              into 4 row blocks, 288 flash and 1536 spx_matmul launches),
              the tensor-parallel prefill and the one-device prefill, the
              same numbers held and each step's device busy share;
     dryrun   the dry run (``launch.dryrun.dry_report``, on ``meta``, no
              card) of the five train_mesh and serve_mesh cells and of
              whisper-small's context-parallel prefill at the same shapes
              and knobs, every device run and again one representative
              per symmetric class: per-device state bytes and every
              device's collective counters equal to the card's; the train
              cells' mesh peak of live storage within DRYRUN_MEM_RTOL of
              max_memory_allocated (the serve cells' printed, no gate);
              the phase within DRYRUN_SECONDS;
     router   ``ReplicaRouter`` over 2 replicas sharing the card: the 8
              requests land [0, 1, 0, 1, ...] and give the paged engine's
              tokens; every launch at a shape ``tier_kernel_phase``
              checked;
     serve_cli  ``python -m repro_torch.launch.serve`` through its
              ``main`` at full width: default flags, ``--stream`` and
              ``--replicas 2``, each metrics line parsed, every launch at
              a shape ``tier_kernel_phase`` checked, the last two runs'
              tokens held to the default run's (a difference only at a
              near-tie);
  6. e2e      full-width logits, kernels against plain versions: a prefill
              chunk and a fused tick (f32 and coded pages), a one-token
              chunk over coded pages, a dense prefill; greedy tokens
              identical on the pinned config (reduced gemma-2b, vocab 32,
              head_dim 128, seed 3) for each path, kernels against plain
              versions and, for the unfused, spec and prefix engines,
              against the paged engine; on bf16 caches kernels against
              plain versions up to a near-tie;
  7. trace    torch.profiler over a serving run of 4 requests: the device's
              busy time and idle share, and device time by kernel name;
  8. timing   each kernel per serving tick (or per admitted request) at the
              main path's shapes, with CUDA events (``ms``) and the
              profiler's device time (``device_ms``), beside two bounds (one
              bf16 tensor-core pass, ``bound_ms``, the least the card could
              take; the f32 FMA rate, ``f32_bound_ms``), its plain version
              and one PyTorch library call that computes the same function,
              timed both ways (``library_ms``, ``library_device_ms``);
              ``spx_matmul`` also at prefill ticks of M = 128, 256 and 2048
              rows (``prefill_by_M``), flash attention also at a 2048-token
              prompt (``long_prompt``), the ragged paged kernels also at 4
              slots x 2048 tokens (``long_ctx_device_ms``), ``spx_matmul``
              at the paper MLP's two layers at M = 1, 64 and 1024 and the
              Q-network's at M = 1 (``paper_mlp_by_M``; also the kernels
              line's ``spx_matmul_small`` row, with each §4 key's kernel
              instance), the ragged
              kernel at a verify tick of W = 5 (``verify_tick``), kernels 2
              and 5 over bf16 and f16 pages (a decode tick and 4 slots x
              2048 tokens; SDPA over the same K/V), one shard's kernels of
              the families served at shards=2 (``shards2_by_family``,
              ``shards2_whisper``) and of the wide runs (``wide``,
              ``wide_whisper``: qwen2-vl-2b's shard 0 of 4, whisper's
              shards 0 and 4 of 8), flash attention at the
              context-parallel shards' rows with the first and the last
              causal offset beside SDPA with the same mask
              (``context_parallel``) and at whisper-small's
              context-parallel shard (``whisper_context_parallel``), each
              flash row with SDPA's kernels a call and their names, and
              the split counts the
              wrappers chose (a ``splits`` line); the whisper and training
              rows of the serve_whisper and train phases ride along
              (``whisper_encoder_pass``, ``whisper``,
              ``whisper_decode_tick``, ``train_function``).

A ``clock`` line after each group of phases gives the seconds since the
start. Exits non-zero on any failure, and when no CUDA device is visible
or the package is missing. The last line is the device record.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import resource
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
NEW_TOKENS = 16
N_REQUESTS = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failed(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


# -- phase 1 -------------------------------------------------------------------

def device_phase(torch) -> dict:
    require(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed ({smi.returncode})"
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": card,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


# -- phase 3 -------------------------------------------------------------------

#: spx_matmul: |kernel - plain| <= SPX_RTOL * max|plain|. Both sum f32
#: products over K, in another order (the kernels' K splits and tiles, the
#: prefill kernel's exact bf16 planes on the tensor cores, against cuBLAS's
#: blocking); at K = 16384 the two differ by ~1e-5 of the largest output.
SPX_RTOL = 1e-4
#: paged attention: |kernel - plain| <= ATTN_TOL * (1 + |plain|). The
#: kernel's online softmax rescales per page and sums P @ V page by page;
#: the plain version takes one max and one sum over the whole context.
ATTN_TOL = 1e-4


#: the 24 spx_matmul launch keys (``_launch_key``) of the paper's §4
#: experiments: the MLP's (784, 128) and (128, 10) at every batch of
#: Table 1, Fig. 5, quickstart and quant_quality, the Q-network's (4, 64)
#: and (64, 64) at one state; sp2_4 (16 entries, packed), pot4 (32) and
#: sp2_8 (256). Each must take the small-layer kernel.
PAPER_SPX_KEYS = frozenset(
    [("spx_matmul", True, 16, m, k, n) for k, n in ((784, 128), (128, 10))
     for m in (1, 8, 64, 256, 1024, 2048)]
    + [("spx_matmul", True, 16, 1, 4, 64), ("spx_matmul", True, 16, 1, 64, 64)]
    + [("spx_matmul", False, lut, m, k, n) for lut in (32, 256)
       for k, n in ((784, 128), (128, 10)) for m in (1024, 2048)]
    + [("spx_matmul", False, 256, 1, 4, 64),
       ("spx_matmul", False, 256, 1, 64, 64)])
#: gemma-2b's projections (K, N), which keep the decode kernel at M <= 8
#: and the prefill kernel above
GEMMA_SPX_SHAPES = ((2048, 2048), (2048, 256), (2048, 16384), (16384, 2048))
#: the kernel (``skinny``, ``mma``, ``small``) of every spx_matmul launch
#: key a kernel phase checked
SPX_PATHS: dict = {}


def _rand_pools(torch, gen, n_pages, hkv, ps, dh):
    kp = torch.randn((n_pages, hkv, ps, dh), generator=gen, device="cuda")
    vp = torch.randn((n_pages, hkv, ps, dh), generator=gen, device="cuda")
    return kp, vp


def kernel_phase(torch, np) -> tuple[dict, set]:
    from repro_torch.core import spx
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_decode_ragged_cuda)
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda
    from repro_torch.runtime import planner

    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {"spx_matmul": 0.0, "spx_matmul_small": 0.0,
             "paged_decode_ragged": 0.0, "paged_attention": 0.0}
    # spx_matmul at the serving shapes: q/o (2048, 2048), k/v (2048, 256),
    # gate/up (2048, 16384), down (16384, 2048); decode M = slots, prefill
    # M = slots x chunk
    # and K, N that no tile divides; M over both kernels (decode M <= 8);
    # the paper MLP's layers (784, 128) and (128, 10) also at the batches
    # of its experiments, up to quickstart's 2048 test digits (K = 784 ends
    # in a ragged K step, N = 10 packs 5-byte rows); the Q-network's
    # quantized layers (4, 64) and (64, 64) at one state and at 64, also
    # under pot4's 5-bit codebook (32 LUT entries, unpacked). Every
    # launch key (``_launch_key``: packed, LUT size, M, K, N) checked here
    # is returned: the paper_experiments phase launches no other
    serve_m = (1, 3, 4, 8, 9, 37, 64, 65, 128, 256)
    mlp_m = serve_m + (1024, 2048)
    serve_shapes = ((2048, 2048, serve_m), (2048, 256, serve_m),
                    (2048, 16384, serve_m), (16384, 2048, serve_m),
                    (1000, 2050, serve_m), (333, 130, serve_m))
    paper_shapes = ((784, 128, mlp_m), (128, 10, mlp_m), (4, 64, (1, 64)),
                    (64, 64, (1, 64)))
    checked = set()
    for scheme, packed, shapes in (
            ("sp2_4", True, serve_shapes + paper_shapes),
            ("sp2_8", False, serve_shapes + paper_shapes),
            ("pot4", False, paper_shapes)):
        lut = spx.codebook(spx.scheme_levels(scheme), device="cuda")
        for k, n, ms in shapes:
            ncode = n // 2 if packed else n
            codes = torch.randint(0, lut.numel(), (k, ncode), generator=gen,
                                  device="cuda", dtype=torch.int32)
            codes = codes.to(torch.uint8)
            scale = torch.rand((1, n), generator=gen, device="cuda") * 0.05
            for m in ms:
                x = torch.randn((m, k), generator=gen, device="cuda")
                _, rec = _check_launch(
                    torch, "spx_matmul", spx_matmul_cuda, ref.spx_matmul_ref,
                    (x, codes, scale, lut), {"packed": packed}, checked,
                    worst, SPX_RTOL)
                emit({"phase": "kernel", "kernel": "spx_matmul",
                      "scheme": scheme, "M": m, "K": k, "N": n, **rec})
    # the gate: the §4 keys on the small-layer kernel, gemma-2b's on the
    # decode (M <= 8) and prefill kernels
    gemma = {key: "skinny" if key[3] <= 8 else "mma"
             for key in SPX_PATHS if key[4:] in GEMMA_SPX_SHAPES}
    paper = {key: "small" for key in PAPER_SPX_KEYS}
    wrong = {key: SPX_PATHS.get(key) for key, path in {**gemma,
                                                      **paper}.items()
             if SPX_PATHS.get(key) != path}
    emit({"phase": "kernel", "kernel": "spx_matmul", "paths_gate": {
              "paper_keys_on_small": len(paper.keys() - wrong.keys()),
              "paper_keys": len(paper),
              "gemma_keys_on_old_kernels": len(gemma.keys() - wrong.keys()),
              "gemma_keys": len(gemma),
              "by_kernel": dict(collections.Counter(SPX_PATHS.values()))},
          "wrong": {str(k): v for k, v in wrong.items()}, "ok": not wrong})
    require(not wrong, f"spx_matmul keys on the wrong kernel: {wrong}")

    # ragged decode at gemma-2b's head shapes: B=4, Hkv=1, rep=8, dh=256
    ps = planner.plan_kv_pages(256).page_size
    b, hkv, rep, dh, mp = 4, 1, 8, 256, 8
    n_pages = 1 + b * mp
    kp, vp = _rand_pools(torch, gen, n_pages, hkv, ps, dh)
    bt = torch.randperm(n_pages - 1, generator=gen, device="cuda")[
        :b * mp].reshape(b, mp).to(torch.int32) + 1
    # the last case is a speculative verify tick: w = 5 windows that cross
    # a page boundary (ctx = ps - 2), beside one-token and empty rows
    for w, qlens, ctx_l in (
            (1, [0, 1, 1, 1], [ps - 1, ps, ps + 1, 3 * ps + 7]),
            (5, [0, 1, 3, 5], [ps - 1, ps, ps + 1, 3 * ps + 7]),
            (5, [5, 5, 1, 0], [ps - 2, 2 * ps - 3, ps - 2, 0])):
        q = torch.randn((b, hkv, rep * w, dh), generator=gen, device="cuda")
        ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
        qn = torch.tensor(qlens, dtype=torch.int32, device="cuda")
        got = paged_decode_ragged_cuda(q, kp, vp, bt, ctx, qn, w=w)
        want = ref.paged_decode_ragged_ref(q, kp, vp, bt, ctx, qn, w=w)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        bound = (ATTN_TOL * (1 + want.abs())).min().item()
        rows_off = torch.arange(rep * w, device="cuda") % w >= qn[:, None]
        zeros = bool((got.permute(0, 2, 1, 3)[rows_off] == 0).all())
        ok = bool(torch.isfinite(got).all()) and zeros and bool(
            ((got - want).abs() <= ATTN_TOL * (1 + want.abs())).all())
        emit({"phase": "kernel", "kernel": "paged_decode_ragged", "w": w,
              "page_size": ps, "ctx_len": ctx.tolist(), "q_len": qlens,
              "max_abs_err": err, "max_rel_err": err / want.abs().max().item(),
              "tol": f"{ATTN_TOL} * (1 + |plain|)", "min_tol": bound,
              "masked_rows_exact_zero": zeros, "ok": ok})
        require(ok, f"paged_decode_ragged w={w} ctx={ctx_l}")
        worst["paged_decode_ragged"] = max(worst["paged_decode_ragged"], err)

    q = torch.randn((b, hkv, rep, dh), generator=gen, device="cuda")
    ctx = torch.tensor([0, 1, ps, 2 * ps + 3], dtype=torch.int32,
                       device="cuda")
    got = paged_attention_cuda(q, kp, vp, bt, ctx)
    want = ref.paged_attention_ref(q, kp, vp, bt, ctx)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    zeros = bool((got[0] == 0).all())
    ok = bool(torch.isfinite(got).all()) and zeros and bool(
        ((got - want).abs() <= ATTN_TOL * (1 + want.abs())).all())
    emit({"phase": "kernel", "kernel": "paged_attention", "page_size": ps,
          "ctx_len": ctx.tolist(), "max_abs_err": err,
          "max_rel_err": err / want.abs().max().item(),
          "tol": f"{ATTN_TOL} * (1 + |plain|)",
          "ctx0_rows_exact_zero": zeros, "ok": ok})
    require(ok, "paged_attention")
    worst["paged_attention"] = max(worst["paged_attention"], err)
    worst.update(_quant_kernel_checks(torch, gen))
    for name, err in _split_kernel_checks(torch, gen).items():
        worst[name] = max(worst[name], err)
    worst.update(_half_kernel_checks(torch, gen, torch.bfloat16))
    worst.update(_half_kernel_checks(torch, gen, torch.float16))
    _flash_kernel_checks(torch, gen, checked, worst)
    ops.reset_op_calls()
    return worst, checked


def _attn_ok(torch, got, want) -> bool:
    return bool(torch.isfinite(got).all()) and bool(
        ((got - want).abs() <= ATTN_TOL * (1 + want.abs())).all())


def _quant_kernel_checks(torch, gen) -> dict:
    """Kernels 3 and 6 (code + scale pages) at gemma-2b's head shapes with
    the quantized cache's page size, on edge rows, for two codebooks."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (
        paged_attention_quant_cuda, paged_decode_ragged_quant_cuda)
    from repro_torch.nn.attention import kv_lut, quantize_kv
    from repro_torch.runtime import planner

    b, hkv, rep, dh, mp = 4, 1, 8, 256, 8
    worst = {"paged_decode_ragged_quant": 0.0, "paged_attention_quant": 0.0}
    for scheme in ("spx_8_x3", "uniform8"):
        ps = planner.plan_kv_pages(dh, kv_scheme=scheme).page_size
        n_pages = 1 + b * mp
        lut = kv_lut(scheme, "cuda")
        kc, ks = quantize_kv(torch.randn((n_pages, hkv, ps, dh),
                                         generator=gen, device="cuda"),
                             scheme)
        vc, vs = quantize_kv(torch.randn((n_pages, hkv, ps, dh),
                                         generator=gen, device="cuda"),
                             scheme)
        bt = torch.randperm(n_pages - 1, generator=gen, device="cuda")[
            :b * mp].reshape(b, mp).to(torch.int32) + 1
        pools = (kc, ks, vc, vs, bt)
        for w, ctx_l, qlens in (
                (1, [0, ps - 1, ps, 3 * ps + 7], [0, 1, 1, 1]),
                (4, [0, ps - 2, ps + 1, 5 * ps], [0, 1, 3, 4])):
            q = torch.randn((b, hkv, rep * w, dh), generator=gen,
                            device="cuda")
            ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
            qn = torch.tensor(qlens, dtype=torch.int32, device="cuda")
            got = paged_decode_ragged_quant_cuda(q, *pools, ctx, qn, lut, w=w)
            want = ref.paged_decode_ragged_quant_ref(q, *pools, ctx, qn, lut,
                                                     w=w)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rows_off = torch.arange(rep * w, device="cuda") % w >= qn[:, None]
            zeros = bool((got.permute(0, 2, 1, 3)[rows_off] == 0).all())
            ok = zeros and _attn_ok(torch, got, want)
            emit({"phase": "kernel", "kernel": "paged_decode_ragged_quant",
                  "scheme": scheme, "w": w, "page_size": ps, "ctx_len": ctx_l,
                  "q_len": qlens, "max_abs_err": err,
                  "max_rel_err": err / want.abs().max().item(),
                  "tol": f"{ATTN_TOL} * (1 + |plain|)",
                  "masked_rows_exact_zero": zeros, "ok": ok})
            require(ok, f"paged_decode_ragged_quant {scheme} w={w}")
            worst["paged_decode_ragged_quant"] = max(
                worst["paged_decode_ragged_quant"], err)
        q = torch.randn((b, hkv, rep, dh), generator=gen, device="cuda")
        ctx_l = [0, 1, ps, 2 * ps + 3]
        ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
        got = paged_attention_quant_cuda(q, *pools, ctx, lut)
        want = ref.paged_attention_quant_ref(q, *pools, ctx, lut)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        zeros = bool((got[0] == 0).all())
        ok = zeros and _attn_ok(torch, got, want)
        emit({"phase": "kernel", "kernel": "paged_attention_quant",
              "scheme": scheme, "page_size": ps, "ctx_len": ctx_l,
              "max_abs_err": err,
              "max_rel_err": err / want.abs().max().item(),
              "tol": f"{ATTN_TOL} * (1 + |plain|)",
              "ctx0_rows_exact_zero": zeros, "ok": ok})
        require(ok, f"paged_attention_quant {scheme}")
        worst["paged_attention_quant"] = max(worst["paged_attention_quant"],
                                             err)
    return worst


def _split_kernel_checks(torch, gen) -> dict:
    """Kernels 2, 3, 5 and 6 where the sequence splits over several blocks:
    gemma-2b's heads, 4 slots, block tables of 2048 tokens, contexts of 0,
    one token into a page, mid-table and the full 2048; ragged q_len at
    w in {1, 5, 8}; the single-token mode against its own plain version.
    Masked rows and empty slots must be exact zeros and a second launch
    bit-identical (the fixed-order merge)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (
        decode_splits, paged_attention_cuda, paged_attention_quant_cuda,
        paged_decode_ragged_cuda, paged_decode_ragged_quant_cuda)
    from repro_torch.nn.attention import kv_lut, quantize_kv
    from repro_torch.runtime import planner

    b, hkv, rep, dh, tokens = 4, 1, 8, 256, 2048
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lut = kv_lut(KV_SCHEME, "cuda")
    worst = {}
    for quant in (False, True):
        ps = planner.plan_kv_pages(
            dh, kv_scheme=KV_SCHEME if quant else None).page_size
        mp = tokens // ps
        n_pages = 1 + b * mp
        k, v = _rand_pools(torch, gen, n_pages, hkv, ps, dh)
        bt = (torch.randperm(n_pages - 1, generator=gen, device="cuda")[
            :b * mp].reshape(b, mp) + 1).to(torch.int32)
        if quant:
            pools = (*quantize_kv(k, KV_SCHEME), *quantize_kv(v, KV_SCHEME),
                     bt)
            names = ("paged_decode_ragged_quant", "paged_attention_quant")
            kernels = (paged_decode_ragged_quant_cuda,
                       paged_attention_quant_cuda)
            plains = (ref.paged_decode_ragged_quant_ref,
                      ref.paged_attention_quant_ref)
            extra = (lut,)
        else:
            pools = (k, v, bt)
            names = ("paged_decode_ragged", "paged_attention")
            kernels = (paged_decode_ragged_cuda, paged_attention_cuda)
            plains = (ref.paged_decode_ragged_ref, ref.paged_attention_ref)
            extra = ()
        for w in (1, 5, 8):
            qlens = [0, 1, max(1, w - 2), w]
            ctx_l = [0, 5 * ps + 1 - qlens[1], 700 - qlens[2], tokens - w]
            ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
            qn = torch.tensor(qlens, dtype=torch.int32, device="cuda")
            q = torch.randn((b, hkv, rep * w, dh), generator=gen,
                            device="cuda")
            got = kernels[0](q, *pools, ctx, qn, *extra, w=w)
            again = kernels[0](q, *pools, ctx, qn, *extra, w=w)
            want = plains[0](q, *pools, ctx, qn, *extra, w=w)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rows_off = torch.arange(rep * w, device="cuda") % w >= qn[:, None]
            zeros = bool((got.permute(0, 2, 1, 3)[rows_off] == 0).all())
            same = bool(torch.equal(got, again))
            ok = zeros and same and _attn_ok(torch, got, want)
            emit({"phase": "kernel", "kernel": names[0], "w": w,
                  "page_size": ps, "ctx_len": ctx_l, "q_len": qlens,
                  "splits": decode_splits(b, hkv, rep * w, mp, ps, sms),
                  "max_abs_err": err, "tol": f"{ATTN_TOL} * (1 + |plain|)",
                  "masked_rows_exact_zero": zeros,
                  "bit_identical_rerun": same, "ok": ok})
            require(ok, f"{names[0]} split case w={w}")
            worst[names[0]] = max(worst.get(names[0], 0.0), err)
        ctx_l = [0, 1, 5 * ps + 1, tokens]
        ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
        q = torch.randn((b, hkv, rep, dh), generator=gen, device="cuda")
        got = kernels[1](q, *pools, ctx, *extra)
        again = kernels[1](q, *pools, ctx, *extra)
        want = plains[1](q, *pools, ctx, *extra)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        zeros = bool((got[0] == 0).all())
        same = bool(torch.equal(got, again))
        ok = zeros and same and _attn_ok(torch, got, want)
        emit({"phase": "kernel", "kernel": names[1], "mode": "single-token",
              "page_size": ps, "ctx_len": ctx_l,
              "splits": decode_splits(b, hkv, rep, mp, ps, sms),
              "max_abs_err": err, "tol": f"{ATTN_TOL} * (1 + |plain|)",
              "ctx0_rows_exact_zero": zeros, "bit_identical_rerun": same,
              "ok": ok})
        require(ok, f"{names[1]} split case")
        worst[names[1]] = max(worst.get(names[1], 0.0), err)
    return worst


#: bf16 pages: in each slot, |kernel - plain| <= BF16_ATTN_RTOL * that
#: slot's max|plain|. The kernel rounds each probability to bf16 before
#: P @ V (relative error up to 2^-9 per term), as the TPU kernel does; the
#: plain version keeps them in f32, as the reference oracle does. Each slot
#: is held to its own largest output: at 2048 tokens a slot's outputs are
#: ~20x smaller than a one-token slot's, and a dropped page or split there
#: moves them by more than 1e-2 of their own peak.
BF16_ATTN_RTOL = 1e-2


def _slot_rel_err(torch, got, want) -> float:
    """The largest over slots (dim 0) of max|got - want| / max|want| in
    that slot; a slot whose plain output is all zeros (no query rows or no
    context) counts as inf unless the kernel's is all zeros too."""
    err = (got - want).abs().flatten(1).amax(1)
    peak = want.abs().flatten(1).amax(1)
    rel = torch.where(peak > 0, err / peak.clamp_min(1e-30),
                      torch.where(err > 0, float("inf"), 0.0))
    return float(rel.max())


#: f16 pages: in each slot, |kernel - plain| <= F16_ATTN_RTOL * that
#: slot's max|plain|. Both round each probability to f16 before P @ V, the
#: kernel at its running max and the plain version at the global one: the
#: bf16 bound over 2^3, f16 carrying three more significand bits.
F16_ATTN_RTOL = BF16_ATTN_RTOL / 8
#: the half-width page dtypes: (the launch count's suffix, the per-slot
#: tolerance against the plain version)
HALF_PAGES = {"bfloat16": ("_bf16", BF16_ATTN_RTOL),
              "float16": ("_f16", F16_ATTN_RTOL)}


#: the 16-bit kernel's checks: contexts (positions before the window) of
#: the slots beside a full table (300: some ranks of a larger cluster busy,
#: the others only at its barriers), and the block tables' widths (the
#: decode tick's 256 tokens, the long context's 2048: two cluster sizes)
HALF_CONTEXTS = (0, 1, 15, 16, 17, 49, 300)
HALF_TABLES = (256, 2048)


def _half_kernel_checks(torch, gen, dtype) -> dict:
    """Kernels 2 and 5 over bf16 or f16 pages (``dtype``; the tensor-core
    kernel ``paged_decode_mma_kernel``) at every head dim the port serves
    (32, 64, 128 over 2 KV heads, gemma-2b's one of 256), page sizes 16
    and 32, windows w in {1, 5, 8} under rep 8 (8 to 64 rows: up to 8
    row groups), block tables of 256 and 2048 tokens: slots with
    contexts 0, 1, 15, 16, 17, 49, 300 (within the table) and a full
    table, a partial window and an empty slot; the single-token mode at
    ctx_len 0, 1, 15, 16, 17, 49, 300 and the full table. Each launch twice: the second must be
    bit-identical. Each slot within the page dtype's tolerance of its own
    largest plain output; masked rows and empty slots exact zeros."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (
        cluster_used, decode_cluster, paged_attention_cuda,
        paged_decode_ragged_cuda)

    suffix, tol = HALF_PAGES[str(dtype).removeprefix("torch.")]
    ragged_name, single_name = ("paged_decode_ragged" + suffix,
                                "paged_attention" + suffix)
    rep = 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = {ragged_name: 0.0, single_name: 0.0}
    for dh in (32, 64, 128, 256):
        hkv = 2 if dh < 256 else 1
        for ps in (16, 32):
            for tokens in HALF_TABLES:
                mp = tokens // ps
                rec = {}
                contexts = [c for c in HALF_CONTEXTS if c + 8 <= tokens]
                for w in (1, 5, 8):
                    ctx_l = contexts + [tokens - w, tokens - w, 0]
                    qlens = [w] * len(contexts) + [max(1, w - 2), w, 0]
                    b = len(ctx_l)
                    n_pages = 1 + b * mp
                    kp, vp = (t.to(dtype) for t in _rand_pools(
                        torch, gen, n_pages, hkv, ps, dh))
                    bt = (torch.randperm(n_pages - 1, generator=gen,
                                         device="cuda")[:b * mp]
                          .reshape(b, mp) + 1).to(torch.int32)
                    ctx = torch.tensor(ctx_l, dtype=torch.int32,
                                       device="cuda")
                    qn = torch.tensor(qlens, dtype=torch.int32, device="cuda")
                    q = torch.randn((b, hkv, rep * w, dh), generator=gen,
                                    device="cuda")
                    got = paged_decode_ragged_cuda(q, kp, vp, bt, ctx, qn,
                                                   w=w)
                    again = paged_decode_ragged_cuda(q, kp, vp, bt, ctx, qn,
                                                     w=w)
                    want = ref.paged_decode_ragged_ref(q, kp, vp, bt, ctx,
                                                       qn, w=w)
                    torch.cuda.synchronize()
                    rows_off = torch.arange(rep * w, device="cuda") % w \
                        >= qn[:, None]
                    rec[f"w={w}"] = {
                        "cluster": cluster_used(dtype, dh, decode_cluster(
                            b, hkv, rep * w, mp, ps, sms)),
                        "max_abs_err": (got - want).abs().max().item(),
                        "max_slot_rel_err": _slot_rel_err(torch, got, want),
                        "masked_rows_exact_zero": bool(
                            (got.permute(0, 2, 1, 3)[rows_off] == 0).all()),
                        "bit_identical_rerun": bool(torch.equal(got, again)),
                        "finite": bool(torch.isfinite(got).all())}
                    if w == 1:
                        ctx1_l = contexts + [tokens]
                        ctx1 = torch.tensor(ctx1_l, dtype=torch.int32,
                                            device="cuda")
                        q1 = q[:len(ctx1_l)].contiguous()
                        bt1 = bt[:len(ctx1_l)].contiguous()
                        got = paged_attention_cuda(q1, kp, vp, bt1, ctx1)
                        again = paged_attention_cuda(q1, kp, vp, bt1, ctx1)
                        want = ref.paged_attention_ref(q1, kp, vp, bt1, ctx1)
                        torch.cuda.synchronize()
                        rec["single"] = {
                            "ctx_len": ctx1_l,
                            "max_abs_err": (got - want).abs().max().item(),
                            "max_slot_rel_err": _slot_rel_err(torch, got,
                                                              want),
                            "masked_rows_exact_zero": bool(
                                (got[0] == 0).all()),
                            "bit_identical_rerun": bool(
                                torch.equal(got, again)),
                            "finite": bool(torch.isfinite(got).all())}
                ok = all(r["max_slot_rel_err"] <= tol
                         and r["masked_rows_exact_zero"]
                         and r["bit_identical_rerun"] and r["finite"]
                         for r in rec.values())
                emit({"phase": "kernel", "kernel": ragged_name,
                      "also": single_name, "dh": dh, "hkv": hkv,
                      "rep": rep, "page_size": ps, "table_tokens": tokens,
                      "contexts": contexts + [tokens],
                      "tol_slot_rel": tol, "cases": rec, "ok": ok})
                require(ok, f"{ragged_name} dh={dh} ps={ps} "
                            f"tokens={tokens}")
                for key, r in rec.items():
                    name = single_name if key == "single" else ragged_name
                    worst[name] = max(worst[name], r["max_abs_err"])
    if dtype == torch.float16:
        worst[ragged_name] = max(worst[ragged_name],
                                 _f16_subnormal_check(torch))
    return worst


def _f16_subnormal_check(torch) -> float:
    """Kernel 2 over f16 pages whose probabilities are f16 subnormals, at
    2048 tokens (a cluster of blocks): every fourth position (the first
    of each 16-token chunk among them, so every running max holds one)
    scores 12 over the rest and has V = 0, the others score 0 and have
    V = 1, so each
    output is made of probabilities exp(-12) = 6.1e-6, below f16's normal
    range, alone. Within 1e-5 of the plain version (which rounds them as
    ``Tensor.to(torch.float16)`` does) and nonzero: a kernel that flushed
    them would give zeros. Returns the largest error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode_ragged_cuda

    b, ps, dh, tokens = 2, 16, 128, 2048
    mp = tokens // ps
    k = torch.zeros((b * mp, 1, ps, dh), device="cuda")
    k[:, :, ::4, 0] = 1.0
    v = torch.ones((b * mp, 1, ps, dh), device="cuda")
    v[:, :, ::4] = 0.0
    q = torch.zeros((b, 1, 1, dh), device="cuda")
    q[..., 0] = 12.0 * dh ** 0.5
    bt = torch.arange(b * mp, dtype=torch.int32,
                      device="cuda").reshape(b, mp)
    ctx = torch.tensor([tokens - 1, tokens // 2 - 1], dtype=torch.int32,
                       device="cuda")
    qn = torch.ones((b,), dtype=torch.int32, device="cuda")
    args = (q, k.half(), v.half(), bt, ctx, qn)
    got = paged_decode_ragged_cuda(*args, w=1)
    want = ref.paged_decode_ragged_ref(*args, w=1)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ok = bool((want > 0).all()) and err <= 1e-5 * want.abs().min().item()
    emit({"phase": "kernel", "kernel": "paged_decode_ragged_f16",
          "case": "subnormal probabilities", "tokens": tokens,
          "plain_output": want.abs().min().item(), "max_abs_err": err,
          "tol": "1e-5 * |plain|", "ok": ok})
    require(ok, "paged_decode_ragged_f16: subnormal probabilities")
    return err


def _flash_kernel_checks(torch, gen, checked, worst) -> None:
    """Kernel 4 at the dense prefill's lengths (ragged ones included),
    causal and not, at two head dims and two GQA groupings, and at a long
    prompt (2048 tokens, gemma-2b's heads, causal); a second launch must be
    bit-identical."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    for dh in (128, 256):
        for rep in (1, 8):
            for causal in (True, False):
                errs = {}
                long = dh == 256 and rep == 8 and causal
                for s in (1, 33, 128, 256) + ((2048,) if long else ()):
                    q = torch.randn((2, rep, s, dh), generator=gen,
                                    device="cuda")
                    k, v = (torch.randn((2, 1, s, dh), generator=gen,
                                        device="cuda") for _ in range(2))
                    _, rec = _check_launch(
                        torch, "flash_attention", flash_attention_cuda,
                        _flash_plain, (q, k, v), {"causal": causal}, checked,
                        worst)
                    errs[s] = rec["max_abs_err"]
                emit({"phase": "kernel", "kernel": "flash_attention",
                      "dh": dh, "rep": rep, "causal": causal,
                      "max_abs_err_by_len": errs,
                      "tol": f"{ATTN_TOL} * (1 + |plain|)",
                      "bit_identical_rerun": True, "ok": True})


# -- phase 5 -------------------------------------------------------------------

def serve_phase(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.lm import lm_init
    from repro_torch.serving import Request, ServeConfig, ServeEngine

    cfg = get_config("gemma-2b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(lm_init(gen, cfg, device="cuda"), cfg, ServeConfig())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    peak_setup = torch.cuda.max_memory_allocated()
    lens, prompts = _prompts(np, cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_op_calls()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
    done = eng.run()
    torch.cuda.synchronize()
    launches, plain = ops.op_calls(), ops.ref_calls()
    m = eng.metrics()
    require(len(done) == N_REQUESTS, f"{len(done)} of {N_REQUESTS} finished")
    for r in done:
        require(len(r.output) == NEW_TOKENS
                and all(0 <= t < cfg.vocab_size for t in r.output),
                f"request {r.rid}: bad output {r.output}")
    for op in ("spx_matmul", "paged_decode_ragged", "paged_attention"):
        require(launches.get(op, 0) > 0, f"{op} never launched")
    require(not plain, f"plain versions ran on the card: {plain}")
    paths = ops.path_calls()
    require(set(paths) <= {"spx_matmul_skinny", "spx_matmul_mma"},
            f"gemma-2b's projections left their kernels: {paths}")
    decode_ticks = launches["paged_decode_ragged"] // cfg.n_layers
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "config": "ServeConfig()", "page_size": eng.page_size,
          "batch_slots": eng.batch_slots, "prompt_lens": lens,
          "requests_finished": len(done), "setup_s": setup_s,
          "tokens_per_s": m["tokens_per_s"], "ttft_p50_ms": m["ttft_p50_ms"],
          "latency_p50_ms": m["latency_p50_ms"], "wall_s": m["wall_s"],
          "model_calls": m["model_calls"], "decode_ticks": decode_ticks,
          "launches": launches, "plain_calls": plain,
          "spx_matmul_kernels": paths,
          "launches_per_decode_tick": {
              "spx_matmul": launches["spx_matmul"] / m["model_calls"],
              "paged_decode_ragged": launches["paged_decode_ragged"]
              / decode_ticks},
          "paged_attention_launches_per_one_token_prefill": cfg.n_layers,
          "max_memory_allocated_setup": peak_setup,
          "max_memory_allocated_serve": torch.cuda.max_memory_allocated()})
    return eng, launches, m, {r.rid: list(r.output) for r in done}


def _prompts(np, cfg):
    """The serve phase's 8 prompts: one of 33 tokens (its second chunk is
    a one-token chunk), seven of 8 to 32."""
    rng = np.random.default_rng(0)
    lens = [33] + [int(n) for n in rng.integers(8, 33, N_REQUESTS - 1)]
    return lens, [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                  for n in lens]


def _serve_ticks(torch, eng, prompts, watch=(), staged: int = 0,
                 frames=None):
    """Serve ``prompts`` through ``eng.step()`` until drained. The counts
    are set to 0 just before and read just after. ``staged``: submit the
    first prompt alone and step that many ticks before the others arrive.
    ``frames``: each request's encoder input (enc-dec models). Returns
    (finished, launches, plain calls, {op: launches of each tick that
    launched it})."""
    from repro_torch.kernels import ops
    from repro_torch.serving import Request
    torch.cuda.reset_peak_memory_stats()
    ops.reset_op_calls()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS,
                           frames=None if frames is None else frames[i]))
        if i == 0:
            for _ in range(staged):
                eng.step()
    per_tick = {op: [] for op in watch}
    prev = {}
    while eng.has_work():
        eng.step()
        now = ops.op_calls()
        for op in watch:
            if now.get(op, 0) != prev.get(op, 0):
                per_tick[op].append(now.get(op, 0) - prev.get(op, 0))
        prev = now
    torch.cuda.synchronize()
    return eng.finished, ops.op_calls(), ops.ref_calls(), per_tick


#: the quantized-KV path's codebook
KV_SCHEME = "spx_8_x3"


def serve_new_paths_phase(torch, np, params) -> dict:
    """The SPx-coded KV cache (paged) and the dense layout, at full width,
    on the quantized weights of the paged engine. Each engine is freed
    before the next. Returns each path's launches."""
    from repro_torch.configs import get_config
    from repro_torch.runtime import Runtime
    from repro_torch.serving import ServeConfig, ServeEngine

    cfg = get_config("gemma-2b")
    lens, prompts = _prompts(np, cfg)
    paths = {
        "quant": (ServeConfig(quantize=None),
                  Runtime(kv_quant=True, kv_scheme=KV_SCHEME),
                  ("paged_decode_ragged_quant", "paged_attention_quant")),
        "dense": (ServeConfig(kv_layout="dense", quantize=None), Runtime(),
                  ("flash_attention",)),
    }
    out = {}
    for path, (sc, rt, watch) in paths.items():
        eng = ServeEngine(params, cfg, sc, rt=rt)
        done, launches, plain, per_tick = _serve_ticks(torch, eng, prompts,
                                                       watch)
        m = eng.metrics()
        require(len(done) == N_REQUESTS,
                f"{path}: {len(done)} of {N_REQUESTS} finished")
        for r in done:
            require(len(r.output) == NEW_TOKENS
                    and all(0 <= t < cfg.vocab_size for t in r.output),
                    f"{path}: request {r.rid}: bad output {r.output}")
        for op in ("spx_matmul",) + watch:
            require(launches.get(op, 0) > 0, f"{path}: {op} never launched")
        require(not plain, f"{path}: plain versions ran on the card: {plain}")
        # one launch per layer in every tick that runs the op; the dense
        # prefill runs once per admitted request
        for op in watch:
            require(all(n % cfg.n_layers == 0 for n in per_tick[op]),
                    f"{path}: {op} launches per tick {per_tick[op]}")
        if path == "quant":
            require(set(per_tick["paged_decode_ragged_quant"])
                    == {cfg.n_layers}, "quant: decode ticks")
            require(set(per_tick["paged_attention_quant"])
                    == {cfg.n_layers}, "quant: one-token prefill ticks")
            unwanted = {"paged_decode_ragged", "paged_attention",
                        "flash_attention"}
        else:
            require(launches["flash_attention"]
                    == cfg.n_layers * N_REQUESTS, "dense: flash per request")
            unwanted = {"paged_decode_ragged", "paged_attention",
                        "paged_decode_ragged_quant", "paged_attention_quant"}
        require(not unwanted & set(launches),
                f"{path}: launched another path's kernels: {launches}")
        emit({"phase": "serve", "path": path, "arch": cfg.name,
              "layers": cfg.n_layers, "d_model": cfg.d_model,
              "vocab": cfg.vocab_size,
              "config": {"quant": f"ServeConfig(quantize=None), Runtime("
                                  f"kv_quant=True, kv_scheme='{KV_SCHEME}')",
                         "dense": "ServeConfig(kv_layout='dense', "
                                  "quantize=None)"}[path],
              "kv_scheme": m["kv_scheme"],
              "kv_cache_dtype": m["kv_cache_dtype"],
              "page_size": m.get("page_size"),
              "batch_slots": eng.batch_slots, "prompt_lens": lens,
              "requests_finished": len(done),
              "tokens_per_s": m["tokens_per_s"],
              "ttft_p50_ms": m["ttft_p50_ms"],
              "latency_p50_ms": m["latency_p50_ms"], "wall_s": m["wall_s"],
              "model_calls": m["model_calls"],
              "peak_kv_bytes": m["peak_kv_bytes"], "launches": launches,
              "plain_calls": plain,
              "launches_per_tick": {op: sorted(set(v))
                                    for op, v in per_tick.items()},
              "ticks_launching": {op: len(v) for op, v in per_tick.items()},
              "max_memory_allocated_serve": torch.cuda.max_memory_allocated()})
        out[path] = launches
        del eng
        torch.cuda.empty_cache()
    return out


# -- phase 4: the paper's own MLP ----------------------------------------------

def paper_mlp_phase(torch, np, card: str) -> dict:
    """The paper's 784-128-10 sigmoid MLP (§4.1) from ``mlp_net_init`` on a
    seeded generator, both layers quantized to sp2_4 as
    ``benchmarks/table1.py`` does, on the port's procedural digits: the
    quantized forward launches ``spx_matmul`` exactly twice and runs no
    plain version; its outputs agree with the plain version's. Time per
    sample at batch 1, 64 and 1024 for the sp2_4 arm and the f32
    ``torch.matmul`` arm, by CUDA events and by the profiler's device
    time of every kernel of the forward."""
    from repro_torch.core.quantized import QuantizedTensor
    from repro_torch.data import make_dataset
    from repro_torch.kernels import ops
    from repro_torch.models.mlp_mnist import (PAPER_LAYERS, mlp_net_init,
                                              paper_mlp_apply)
    from repro_torch.nn.layers import quantize_params
    from repro_torch.runtime import Runtime

    gen = torch.Generator(device="cuda").manual_seed(0)
    params = mlp_net_init(gen, PAPER_LAYERS, device="cuda")
    qparams = quantize_params(params, "sp2_4", min_size=1024)
    require(all(isinstance(qparams[f"l{i}"]["w"], QuantizedTensor)
                for i in range(len(PAPER_LAYERS) - 1)),
            "paper_mlp: a layer stayed dense")
    x_np, _ = make_dataset(1024, seed=7)
    x = torch.as_tensor(x_np, device="cuda")
    rt = Runtime()
    torch.cuda.synchronize()
    ops.reset_op_calls()
    out = paper_mlp_apply(qparams, x, rt)
    torch.cuda.synchronize()
    launches, plain = ops.op_calls(), ops.ref_calls()
    paths = ops.path_calls()
    require(launches == {"spx_matmul": 2},
            f"paper_mlp: launches per forward {launches}")
    require(paths == {"spx_matmul_small": 2},
            f"paper_mlp: not on the small-layer kernel: {paths}")
    require(not plain, f"paper_mlp: plain versions ran on the card: {plain}")
    want = paper_mlp_apply(qparams, x, Runtime(impl="ref"))
    dense = paper_mlp_apply(params, x, rt)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    peak = want.abs().max().item()
    same_argmax = bool(torch.equal(out.argmax(-1), want.argmax(-1)))
    ok = (tuple(out.shape) == (1024, 10) and bool(torch.isfinite(out).all())
          and err <= SPX_RTOL * peak and same_argmax)
    timing = {}
    for batch in (1, 64, 1024):
        xb = x[:batch].contiguous()
        for arm, p in (("sp2_4 spx_matmul", qparams),
                       ("f32 torch.matmul", params)):
            fn = (lambda p=p, xb=xb: paper_mlp_apply(p, xb, rt))
            ms = _time_ms(torch, fn, reps=50, warmup=5)
            dev = _device_ms(torch, fn, ("",), reps=20)
            timing[f"{arm}, batch {batch}"] = {
                "us_per_sample": ms * 1e3 / batch,
                "device_us_per_sample": dev * 1e3 / batch if dev else None,
                "ms_per_forward": ms, "device_ms_per_forward": dev}
    emit({"phase": "paper_mlp", "card": card, "layers": list(PAPER_LAYERS),
          "weights": "mlp_net_init, torch.Generator seed 0, quantize_params"
                     "(sp2_4, min_size=1024)",
          "inputs": "make_dataset(1024, seed=7)",
          "launches_per_forward": launches, "plain_calls": plain,
          "spx_matmul_kernels": paths, "max_abs_err": err,
          "max_rel_err": err / peak, "tol_rel": SPX_RTOL,
          "argmax_identical": same_argmax,
          "argmax_agreement_with_f32_weights": float(
              (out.argmax(-1) == dense.argmax(-1)).float().mean()),
          "timing": timing, "ok": ok})
    require(ok, "paper_mlp: quantized forward disagrees with its plain "
                "version")
    ops.reset_op_calls()
    return {"params": qparams, "launches": launches["spx_matmul"],
            "small_launches": paths["spx_matmul_small"], "max_abs_err": err}


#: the reference's defaults for the §4 experiments
PAPER_EPOCHS = 4
RL_EPISODES = 120
#: test_system.py's accuracy bars: f32 above 0.9, each scheme within its
#: tolerance of f32
ACC_FLOOR = 0.9
ACC_TOL = {"sp2_8": 0.01, "spx_8_x3": 0.01, "sp2_4": 0.02, "pot4": 0.03}


def paper_experiments_phase(torch, np, card: str, checked: set) -> dict:
    """The paper's §4 experiments through the port's entry points, on the
    card: ``examples.quickstart`` (train the MLP for 4 epochs, then test
    accuracy per scheme), ``benchmarks.table1`` (time and energy per
    sample at batch 1 and 1024), ``benchmarks.fig5`` (time per sample
    against batch, and the §3.1 margins on H100_SXM),
    ``benchmarks.quant_quality`` and ``examples.rl_qlearning`` (120
    episodes, then the returns per scheme). Each is one run with the
    counts set to 0 just before and read just after: every quantized arm
    must launch ``spx_matmul`` and no plain version may run. Each launch's
    ``_launch_key`` (packed, LUT size, M, K, N) is recorded, and each must
    be one that the kernel phase held against the plain version
    (``checked``), and every launch must take the small-layer kernel.
    Returns the launches of all five, per op and per spx_matmul kernel."""
    from repro_torch.benchmarks import fig5, quant_quality, table1
    from repro_torch.examples import quickstart, rl_qlearning
    from repro_torch.kernels import ops

    total: dict[str, int] = {}

    def run(name, fn):
        ops.reset_op_calls()
        t0 = time.perf_counter()
        with _ShapeRecorder(torch) as shapes:
            result = fn()
        torch.cuda.synchronize()
        launches, plain = ops.op_calls(), ops.ref_calls()
        paths = ops.path_calls()
        require(launches.get("spx_matmul", 0) > 0,
                f"{name}: spx_matmul never launched")
        require(paths == {"spx_matmul_small": launches["spx_matmul"]},
                f"{name}: spx_matmul launches off the small-layer kernel: "
                f"{paths}")
        off = sorted(key for key in shapes if SPX_PATHS.get(key) != "small")
        require(not off, f"{name}: launched at {off}, which the kernel "
                         "phase did not see on the small-layer kernel")
        require(not plain, f"{name}: plain versions ran on the card: "
                           f"{plain}")
        unchecked = sorted(shapes - checked)
        require(not unchecked, f"{name}: launched at {unchecked}, which the "
                               "kernel phase never held to the plain version")
        for op, n in {**launches, **paths}.items():
            total[op] = total.get(op, 0) + n
        return result, {"launches": launches, "spx_matmul_kernels": paths,
                        "spx_matmul_shapes": sorted(shapes),
                        "seconds": time.perf_counter() - t0}

    acc, info = run("quickstart", lambda: quickstart.main(
        ["--epochs", str(PAPER_EPOCHS)]))
    ok = acc["float32"] > ACC_FLOOR and all(
        acc[s] > acc["float32"] - tol for s, tol in ACC_TOL.items())
    emit({"phase": "paper_experiments", "experiment": "quickstart (§4.1)",
          "card": card, "epochs": PAPER_EPOCHS,
          "train": "SynthDigits(8192, 2048, batch 64), SGD lr 0.5, "
                   "torch.Generator seed 0",
          "test_accuracy": acc, "floor": ACC_FLOOR, "tol": ACC_TOL,
          "ok": ok, **info})
    require(ok, f"quickstart: accuracy {acc}")

    rows, info = run("table1", lambda: table1.run([]))
    measured = [r for r in rows if r["name"] in
                {f"{a}_b{b}" for a in ("fp32", "sp2_4")
                 for b in table1.BATCHES}]
    ok = len(measured) == 4 and all(
        r["s_per_sample"] > 0 and r["j_per_sample"] is not None
        for r in measured)
    emit({"phase": "paper_experiments", "experiment": "Table 1",
          "card": card, "rows": rows, "ok": ok, **info})
    require(ok, f"table1: rows {measured}")

    csv, info = run("fig5", lambda: fig5.run([]))
    curve = {name.split("/")[1]: us for name, us, _ in csv
             if not name.startswith("fig5/pipe_")}
    margins = {name.split("/")[1]: {"margin": v, "pipelined": bool(flag)}
               for name, v, flag in csv if name.startswith("fig5/pipe_")}
    ok = len(curve) == 2 * len(fig5.BATCHES) and all(
        v > 0 for v in curve.values())
    emit({"phase": "paper_experiments", "experiment": "Fig. 5",
          "card": card, "us_per_sample": curve,
          "pipeline_margins_h100_sxm": margins, "ok": ok, **info})
    require(ok, f"fig5: {curve}")

    csv, info = run("quant_quality", lambda: quant_quality.run([]))
    table = {name.split("/")[1]: [v, extra] for name, v, extra in csv}
    emit({"phase": "paper_experiments", "experiment": "quant_quality",
          "card": card, "rows": table,
          "columns": "snr rows: [dB, tail density]; acc rows: [accuracy, "
                     "difference from float32]", **info})

    res, info = run("rl_qlearning", lambda: rl_qlearning.main(
        ["--episodes", str(RL_EPISODES)]))
    ok = (len(res["returns"]) == RL_EPISODES
          and set(res["eval"]) == {"float32", "sp2_8", "sp2_4"})
    emit({"phase": "paper_experiments", "experiment": "Q-learning (§4.2)",
          "card": card, "episodes": RL_EPISODES,
          "avg_return_last_20_episodes": float(np.mean(res["returns"][-20:])),
          "eval_avg_return_by_scheme": res["eval"], "ok": ok, **info})
    require(ok, f"rl_qlearning: {res['eval']}")
    ops.reset_op_calls()
    return total


# -- phase 5: the unfused tick, speculative decoding, the prefix cache --------

class _ReplayDrafter:
    """The engine's drafter protocol (start, extend, drop, propose),
    proposing the tokens a reference run emitted: every window is full
    until the reference's tokens run out."""

    def __init__(self, tokens: dict):
        self.tokens = tokens
        self.emitted: dict[int, int] = {}

    def start(self, rid, prompt):
        self.emitted[rid] = 0

    def extend(self, rid, tok):
        self.emitted[rid] += 1

    def drop(self, rid):
        self.emitted.pop(rid, None)

    def propose(self, rid, k):
        n = self.emitted[rid]
        return list(self.tokens[rid][n:n + k])


def _record_steps(torch, names, module=None):
    """Wrap the model-step functions ``names`` of ``module``
    (``repro_torch.models.lm`` by default; the engine looks them up at each
    call): each call appends [name, window width, n_valid (its largest
    value once ``restore`` ran), launches by op during the call]. Returns
    (records, restore)."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm as lm_mod
    lm_mod = module or lm_mod
    records, saved = [], {}
    for name in names:
        fn = saved[name] = getattr(lm_mod, name)

        def wrapped(params, tokens, ctx, bt, n_valid, *rest, fn=fn,
                    name=name):
            before = ops.op_calls()
            out = fn(params, tokens, ctx, bt, n_valid, *rest)
            after = ops.op_calls()
            records.append([name, int(tokens.shape[1]), n_valid,
                            {op: after[op] - before.get(op, 0)
                             for op in after
                             if after[op] != before.get(op, 0)}])
            return out
        setattr(lm_mod, name, wrapped)

    def restore():
        for name, fn in saved.items():
            setattr(lm_mod, name, fn)
        for r in records:
            r[2] = int(r[2].max())
    return records, restore


def _run_engine(torch, eng, prompts, staged: int = 0, frames=None):
    """``_serve_ticks`` without a watch: (tokens by rid, launches, plain
    calls, metrics)."""
    done, launches, plain, _ = _serve_ticks(torch, eng, prompts,
                                            staged=staged, frames=frames)
    return ({r.rid: list(r.output) for r in done}, launches, plain,
            eng.metrics())


def _record_gaps(np, eng, rtol: float) -> dict:
    """Make ``eng`` record, for every token it emits, the top-2 logit gap
    of the row it was picked from and the logit tolerance of that row
    (``rtol`` of its largest magnitude). Returns the {rid: [(gap, tol),
    ...]} it fills."""
    gaps: dict[int, list] = {}
    pick, accept = eng._pick_token, eng._accept_tokens

    def note(req, row):
        top2 = np.partition(np.asarray(row, np.float64), -2)[-2:]
        gaps.setdefault(req.rid, []).append(
            (float(top2[1] - top2[0]), rtol * float(np.abs(row).max())))

    def pick_noted(row, req):
        note(req, row)
        return pick(row, req)

    def accept_noted(req, drafts, logits):
        out = accept(req, drafts, logits)
        for j in range(len(out)):
            note(req, logits[j])
        return out
    eng._pick_token, eng._accept_tokens = pick_noted, accept_noted
    return gaps


def _reference_gaps(torch, np, params, cfg, prompts) -> tuple:
    """Serve ``prompts`` on the paged engine (``ServeConfig(quantize=None)``)
    recording every token's top-2 gap and E2E_RTOL tolerance. Returns
    (tokens, {rid: [(gap, tol), ...]})."""
    from repro_torch.serving import ServeConfig, ServeEngine
    eng = ServeEngine(params, cfg, ServeConfig(quantize=None))
    gaps = _record_gaps(np, eng, E2E_RTOL)
    tokens, _, _, _ = _run_engine(torch, eng, prompts)
    del eng
    return tokens, gaps


def _check_tokens(torch, np, path, got, want, params, cfg, prompts) -> dict:
    """Greedy tokens of ``path`` against the paged engine's on the same
    requests. A difference is allowed only where the paged run's top-2
    logit gap at the first differing position is within the logit
    tolerance (two correct paths that sum in another order may round a
    near-tie apart); otherwise the phase fails."""
    if got == want:
        return {"identical": True}
    ref_tokens, gaps = _reference_gaps(torch, np, params, cfg, prompts)
    require(ref_tokens == want, f"{path}: the paged engine is not "
                                "deterministic across runs")
    return _near_tie_check(path, got, want, gaps)


def _near_tie_check(path, got, want, gaps) -> dict:
    """Tokens ``got`` against ``want``, whose run recorded ``gaps``
    (``_record_gaps``): each request may differ only first where that
    run's top-2 gap is within its tolerance."""
    if got == want:
        return {"identical": True}
    diffs = {}
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        if a == b:
            continue
        j = next(i for i in range(min(len(a), len(b))) if a[i] != b[i])
        gap, tol = gaps[rid][j]
        diffs[rid] = {"first_diff": j, "top2_gap": gap, "logit_tol": tol,
                      "near_tie": gap <= tol}
    emit({"phase": "serve", "path": path, "token_differences": diffs})
    require(all(d["near_tie"] for d in diffs.values()),
            f"{path}: greedy tokens differ from the reference run's away "
            f"from a near-tie: {diffs}")
    return {"identical": False, "near_ties": diffs}


def _tiled_prompts(np, vocab, n=4, reps=3, motif=8):
    """Repetition-heavy prompts (tiled motifs), as the reference's spec
    tests build them: the n-gram drafter has something to find."""
    rng = np.random.default_rng(4)
    return [np.tile(rng.integers(0, vocab, motif).astype(np.int32), reps)
            for _ in range(n)]


def _shared_prompts(np, vocab, prefix=64, tails=(5, 9, 12, 20)):
    """Prompts sharing a page-aligned prefix with distinct tails, then the
    bare prefix again: a served page-aligned prompt repeated whole."""
    rng = np.random.default_rng(6)
    system = rng.integers(0, vocab, prefix).astype(np.int32)
    return [np.concatenate([system, rng.integers(0, vocab, n)
                            .astype(np.int32)]) for n in tails] + [system]


def serve_modes_phase(torch, np, params, paged_tokens, paged_m) -> dict:
    """The paged engine's other decode modes at full width, on the
    quantized weights of the paged engine, each engine freed before the
    next:

      unfused  ``ServeConfig(fused_decode=False)`` on the 8 requests:
               every one-token step launches ``paged_attention`` once per
               layer, ``paged_decode_ragged`` never;
      spec     ``ServeConfig(spec_decode=True, spec_k=4)``, fused: with a
               drafter replaying the paged engine's tokens (full W = 5
               windows), then with the prompt-lookup drafter on
               repetition-heavy prompts;
      prefix   ``ServeConfig(prefix_cache=True)``: 4 requests sharing a
               64-token prefix, the first served alone for 2 ticks so the
               rest match its pages, and the bare prefix again (the
               copy-on-write copy).

    Greedy tokens must equal the paged engine's on the same requests, or
    differ first at a near-tie. Returns each path's launches."""
    from repro_torch.configs import get_config
    from repro_torch.serving import ServeConfig, ServeEngine

    cfg = get_config("gemma-2b")
    layers = cfg.n_layers
    _, prompts = _prompts(np, cfg)
    out = {}

    def paged_run(ps):
        tokens, _, _, m = _run_engine(
            torch, ServeEngine(params, cfg, ServeConfig(quantize=None)), ps)
        return tokens, m

    def report(path, sc, eng, m, launches, plain, records, tokens_check,
               **extra):
        emit({"phase": "serve", "path": path, "arch": cfg.name,
              "layers": layers, "d_model": cfg.d_model,
              "vocab": cfg.vocab_size, "config": sc,
              "page_size": eng.page_size, "batch_slots": eng.batch_slots,
              "requests_finished": m["requests_finished"],
              "tokens_per_s": m["tokens_per_s"],
              "ttft_p50_ms": m["ttft_p50_ms"],
              "latency_p50_ms": m["latency_p50_ms"], "wall_s": m["wall_s"],
              "model_calls": m["model_calls"],
              "engine_steps": m["engine_steps"],
              "spec_k": m["spec_k"],
              "draft_acceptance_rate": m["draft_acceptance_rate"],
              "accepted_per_step": m["accepted_per_step"],
              "prefix_hits": m["prefix_hits"],
              "prefill_tokens_skipped": m["prefill_tokens_skipped"],
              "cow_copies": m["cow_copies"],
              "launches": launches, "plain_calls": plain,
              "model_steps": len(records), "tokens": tokens_check,
              **extra})

    def checks(path, tokens, launches, plain, n_req):
        require(len(tokens) == n_req, f"{path}: {len(tokens)} of {n_req} "
                                      "finished")
        for rid, toks in tokens.items():
            require(len(toks) == NEW_TOKENS
                    and all(0 <= t < cfg.vocab_size for t in toks),
                    f"{path}: request {rid}: bad output {toks}")
        require(launches.get("spx_matmul", 0) > 0,
                f"{path}: spx_matmul never launched")
        require(not plain, f"{path}: plain versions ran on the card: {plain}")

    # -- unfused: the one-token step in every decode tick
    sc = "ServeConfig(fused_decode=False, quantize=None)"
    eng = ServeEngine(params, cfg, ServeConfig(fused_decode=False,
                                               quantize=None))
    records, restore = _record_steps(torch, ("lm_paged_step",
                                             "lm_paged_verify",
                                             "lm_paged_fused_step"))
    try:
        tokens, launches, plain, m = _run_engine(torch, eng, prompts)
    finally:
        restore()
    checks("unfused", tokens, launches, plain, N_REQUESTS)
    one_token = [r for r in records if r[1] == 1]
    require(not any(r[0] == "lm_paged_fused_step" for r in records),
            "unfused: a fused tick ran")
    require(len(one_token) >= NEW_TOKENS - 1
            and all(r[3].get("paged_attention") == layers
                    and "paged_decode_ragged" not in r[3]
                    for r in one_token),
            f"unfused: paged_attention launches per one-token step "
            f"{sorted({r[3].get('paged_attention', 0) for r in one_token})}")
    require("paged_decode_ragged" not in launches,
            f"unfused: paged_decode_ragged launched: {launches}")
    report("unfused", sc, eng, m, launches, plain, records,
           _check_tokens(torch, np, "unfused", tokens, paged_tokens, params,
                         cfg, prompts),
           one_token_steps=len(one_token),
           paged_attention_launches_per_one_token_step=layers)
    out["unfused"] = launches
    del eng

    # -- spec, replay drafter: full W = 5 windows
    sc = ("ServeConfig(spec_decode=True, spec_k=4, quantize=None), drafter "
          "replaying the paged engine's tokens")
    eng = ServeEngine(params, cfg, ServeConfig(spec_decode=True, spec_k=4,
                                               quantize=None))
    eng.drafter = _ReplayDrafter(paged_tokens)
    records, restore = _record_steps(torch, ("lm_paged_step",
                                             "lm_paged_fused_step"))
    try:
        tokens, launches, plain, m = _run_engine(torch, eng, prompts)
    finally:
        restore()
    checks("spec", tokens, launches, plain, N_REQUESTS)
    ticks = [r for r in records if r[0] == "lm_paged_fused_step"]
    require(ticks and all(r[1] == 5 and r[3].get("paged_decode_ragged")
                          == layers for r in ticks),
            "spec: a fused tick ran at another window or launch count: "
            + str(sorted({(r[1], r[3].get("paged_decode_ragged", 0))
                          for r in ticks})))
    require(any(r[2] == 5 for r in ticks), "spec: no window of 5 valid rows")
    require(m["model_calls"] < paged_m["model_calls"],
            f"spec: {m['model_calls']} model calls, paged "
            f"{paged_m['model_calls']}")
    report("spec", sc, eng, m, launches, plain, records,
           _check_tokens(torch, np, "spec", tokens, paged_tokens, params,
                         cfg, prompts),
           paged_model_calls=paged_m["model_calls"],
           fused_ticks=len(ticks),
           windows_of_5_valid_rows=sum(r[2] == 5 for r in ticks))
    out["spec"] = launches
    del eng

    # -- spec, prompt-lookup drafter on repetition-heavy prompts
    tiled = _tiled_prompts(np, cfg.vocab_size)
    want, m_ref = paged_run(tiled)
    sc = ("ServeConfig(spec_decode=True, spec_k=4, quantize=None), "
          "PromptLookupDrafter, 4 tiled prompts of 24 tokens")
    eng = ServeEngine(params, cfg, ServeConfig(spec_decode=True, spec_k=4,
                                               quantize=None))
    tokens, launches, plain, m = _run_engine(torch, eng, tiled)
    checks("spec (prompt lookup)", tokens, launches, plain, len(tiled))
    report("spec (prompt lookup)", sc, eng, m, launches, plain, [],
           _check_tokens(torch, np, "spec (prompt lookup)", tokens, want,
                         params, cfg, tiled),
           paged_model_calls=m_ref["model_calls"])
    del eng

    # -- prefix cache
    shared = _shared_prompts(np, cfg.vocab_size)
    want, _ = paged_run(shared)
    sc = ("ServeConfig(prefix_cache=True, quantize=None), 4 prompts sharing "
          "a 64-token prefix (the first served alone for 2 ticks) and the "
          "bare prefix")
    eng = ServeEngine(params, cfg, ServeConfig(prefix_cache=True,
                                               quantize=None))
    tokens, launches, plain, m = _run_engine(torch, eng, shared, staged=2)
    checks("prefix", tokens, launches, plain, len(shared))
    require(m["prefix_hits"] >= 1 and m["cow_copies"] >= 1
            and m["prefill_tokens_skipped"] > 0,
            f"prefix: hits {m['prefix_hits']}, copies {m['cow_copies']}, "
            f"skipped {m['prefill_tokens_skipped']}")
    require(launches.get("paged_decode_ragged", 0) > 0,
            "prefix: paged_decode_ragged never launched")
    eng.pool.validate()
    report("prefix", sc, eng, m, launches, plain, [],
           _check_tokens(torch, np, "prefix", tokens, want, params, cfg,
                         shared),
           prefix_lookups=m["prefix_lookups"])
    out["prefix"] = launches
    del eng
    torch.cuda.empty_cache()
    return out


# -- phase 5: bf16 KV pages ----------------------------------------------------

#: greedy tokens of a bf16-cache engine against the same engine on the
#: plain versions may differ only first where the plain run's top-2 logit
#: gap is within BF16_E2E_RTOL of its largest |logit|: the bf16 kernel
#: rounds every probability to bf16 (see BF16_ATTN_RTOL) in each of the 18
#: layers, where the plain version keeps them in f32.
BF16_E2E_RTOL = 1e-2


def _token_agreement(got: dict, want: dict) -> dict:
    """Share of positions and of whole requests where ``got`` == ``want``."""
    pos = [a == b for rid in want for a, b in zip(got[rid], want[rid])]
    return {"positions": sum(pos) / len(pos),
            "requests_identical": sum(got[r] == want[r] for r in want)}


def _serve_half_path(torch, params, cfg, prompts, path, sc, watch,
                     unwanted) -> tuple:
    """Serve ``prompts`` on ``ServeEngine(params, cfg, sc)`` (bf16 or f16
    caches), freed after: every request finished with ``NEW_TOKENS`` valid
    tokens, every op of ``watch`` launched in multiples of the layer count
    per tick, no plain version and no op of ``unwanted`` launched, the
    caches and the metrics in ``sc.kv_cache_dtype``. Returns (tokens,
    launches, plain calls, launches per tick, metrics)."""
    from repro_torch.serving import ServeEngine
    eng = ServeEngine(params, cfg, sc)
    dtype = eng.kv_cache_dtype
    require(all(leaf.dtype == dtype for c in eng.caches
                for leaf in c.values()),
            f"{path}: the caches are not {dtype}")
    done, launches, plain, per_tick = _serve_ticks(torch, eng, prompts,
                                                   watch)
    m = eng.metrics()
    tokens = {r.rid: list(r.output) for r in done}
    require(len(done) == N_REQUESTS,
            f"{path}: {len(done)} of {N_REQUESTS} finished")
    for rid, toks in tokens.items():
        require(len(toks) == NEW_TOKENS
                and all(0 <= t < cfg.vocab_size for t in toks),
                f"{path}: request {rid}: bad output {toks}")
    for op in ("spx_matmul",) + watch:
        require(launches.get(op, 0) > 0, f"{path}: {op} never launched")
    require(not plain, f"{path}: plain versions ran on the card: {plain}")
    require(not unwanted & set(launches),
            f"{path}: launched another path's kernels: {launches}")
    for op in watch:
        require(all(n % cfg.n_layers == 0 for n in per_tick[op]),
                f"{path}: {op} launches per tick {per_tick[op]}")
    require(m["kv_cache_dtype"] == str(dtype).removeprefix("torch."),
            f"{path}: metrics say {m['kv_cache_dtype']}")
    del eng
    torch.cuda.empty_cache()
    return tokens, launches, plain, per_tick, m


def serve_bf16_phase(torch, np, params, paged_tokens) -> dict:
    """Full-width gemma-2b on bf16 KV caches (``ServeConfig(kv_cache_dtype=
    "bfloat16")``), on the quantized weights of the paged engine and the
    serve phase's 8 requests, each engine freed before the next:

      paged-bf16    the fused tick: kernel 2's bf16 instance in every
                    decode tick, kernel 5's in the one-token prefill chunk;
      unfused-bf16  ``fused_decode=False``: kernel 5's bf16 instance in
                    every layer of every one-token step;
      dense-bf16    the dense layout: flash attention at prefill (f32
                    q/k/v), the bf16 cache read through f32 math.

    Each path's greedy tokens are held against the same engine with
    ``Runtime(impl="ref")`` (the plain versions, on the same bf16 pages),
    a difference allowed only at a near-tie (BF16_E2E_RTOL); the agreement
    with the f32 paged engine is printed, not gated. Returns each path's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.runtime import Runtime
    from repro_torch.serving import ServeConfig, ServeEngine

    cfg = get_config("gemma-2b")
    layers = cfg.n_layers
    lens, prompts = _prompts(np, cfg)
    f32_kernels = {"paged_decode_ragged", "paged_attention",
                   "paged_decode_ragged_quant", "paged_attention_quant"}
    paths = {
        "paged-bf16": (dict(kv_cache_dtype="bfloat16"),
                       ("paged_decode_ragged_bf16", "paged_attention_bf16"),
                       f32_kernels | {"flash_attention"}),
        "unfused-bf16": (dict(kv_cache_dtype="bfloat16", fused_decode=False),
                         ("paged_attention_bf16",),
                         f32_kernels | {"flash_attention",
                                        "paged_decode_ragged_bf16"}),
        "dense-bf16": (dict(kv_cache_dtype="bfloat16", kv_layout="dense"),
                       ("flash_attention",),
                       f32_kernels | {"paged_decode_ragged_bf16",
                                      "paged_attention_bf16"}),
    }
    out = {}
    for path, (knobs, watch, unwanted) in paths.items():
        sc = ServeConfig(quantize=None, **knobs)
        tokens, launches, plain, per_tick, m = _serve_half_path(
            torch, params, cfg, prompts, path, sc, watch, unwanted)
        if path == "dense-bf16":
            require(launches["flash_attention"] == layers * N_REQUESTS,
                    "dense-bf16: flash per request")

        ref_eng = ServeEngine(params, cfg, sc, rt=Runtime(impl="ref"))
        gaps = _record_gaps(np, ref_eng, BF16_E2E_RTOL)
        want, ref_launches, ref_plain, _ = _run_engine(torch, ref_eng,
                                                       prompts)
        del ref_eng
        torch.cuda.empty_cache()
        require(not ref_launches and ref_plain,
                f"{path}: the plain run launched {ref_launches}")
        check = _near_tie_check(path, tokens, want, gaps)
        emit({"phase": "serve", "path": path, "arch": cfg.name,
              "layers": layers, "d_model": cfg.d_model,
              "vocab": cfg.vocab_size,
              "config": f"ServeConfig(quantize=None, "
                        + ", ".join(f"{k}={v!r}" for k, v in knobs.items())
                        + ")",
              "kv_cache_dtype": m["kv_cache_dtype"],
              "page_size": m.get("page_size"),
              "batch_slots": sc.batch_slots, "prompt_lens": lens,
              "requests_finished": len(tokens),
              "tokens_per_s": m["tokens_per_s"],
              "ttft_p50_ms": m["ttft_p50_ms"],
              "latency_p50_ms": m["latency_p50_ms"], "wall_s": m["wall_s"],
              "model_calls": m["model_calls"],
              "peak_kv_bytes": m["peak_kv_bytes"], "launches": launches,
              "bf16_route_launches": {op: n for op, n in launches.items()
                                      if op.endswith("_bf16")},
              "plain_calls": plain,
              "launches_per_tick": {op: sorted(set(v))
                                    for op, v in per_tick.items()},
              "tokens_vs_plain_versions": check,
              "near_tie_tol_rel": BF16_E2E_RTOL,
              "agreement_with_f32_paged_engine": _token_agreement(
                  tokens, paged_tokens)})
        out[path] = launches
    return out


#: greedy tokens of an f16-page engine against the f32-page engine may
#: differ only first where the f32 run's top-2 logit gap is within
#: F16_E2E_RTOL of its largest |logit|: K, V and each probability round to
#: f16 (2^-11) in each of the 18 layers; BF16_E2E_RTOL over 2^3
F16_E2E_RTOL = BF16_E2E_RTOL / 8


def serve_f16_phase(torch, np, params) -> dict:
    """Full-width gemma-2b on f16 KV pages (``ServeConfig(kv_cache_dtype=
    "float16")``), on the quantized weights of the paged engine and the
    serve phase's 8 requests:

      paged-f16    the fused tick: kernel 2's f16 instance (``F16Mma``)
                   in every decode tick, kernel 5's in the one-token
                   prefill chunk;
      unfused-f16  ``fused_decode=False``: kernel 5's f16 instance in every
                   layer of every one-token step.

    Each path's greedy tokens are held against the f32-page engine of the
    same weights (run first, its top-2 gaps recorded), a difference
    allowed only at a near-tie (F16_E2E_RTOL). Returns each path's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.serving import ServeConfig, ServeEngine

    cfg = get_config("gemma-2b")
    lens, prompts = _prompts(np, cfg)
    f32 = ServeEngine(params, cfg, ServeConfig(quantize=None))
    gaps = _record_gaps(np, f32, F16_E2E_RTOL)
    want, _, _, fm = _run_engine(torch, f32, prompts)
    del f32
    torch.cuda.empty_cache()
    others = {"paged_decode_ragged", "paged_attention",
              "paged_decode_ragged_quant", "paged_attention_quant",
              "paged_decode_ragged_bf16", "paged_attention_bf16",
              "flash_attention"}
    paths = {
        "paged-f16": (dict(kv_cache_dtype="float16"),
                      ("paged_decode_ragged_f16", "paged_attention_f16"),
                      others),
        "unfused-f16": (dict(kv_cache_dtype="float16", fused_decode=False),
                        ("paged_attention_f16",),
                        others | {"paged_decode_ragged_f16"}),
    }
    out = {}
    for path, (knobs, watch, unwanted) in paths.items():
        sc = ServeConfig(quantize=None, **knobs)
        tokens, launches, plain, per_tick, m = _serve_half_path(
            torch, params, cfg, prompts, path, sc, watch, unwanted)
        emit({"phase": "serve", "path": path, "arch": cfg.name,
              "layers": cfg.n_layers, "d_model": cfg.d_model,
              "vocab": cfg.vocab_size,
              "config": "ServeConfig(quantize=None, "
                        + ", ".join(f"{k}={v!r}" for k, v in knobs.items())
                        + ")",
              "kv_cache_dtype": m["kv_cache_dtype"],
              "page_size": m["page_size"], "batch_slots": sc.batch_slots,
              "prompt_lens": lens, "requests_finished": len(tokens),
              "tokens_per_s": m["tokens_per_s"],
              "ttft_p50_ms": m["ttft_p50_ms"],
              "latency_p50_ms": m["latency_p50_ms"], "wall_s": m["wall_s"],
              "model_calls": m["model_calls"],
              "peak_kv_bytes": m["peak_kv_bytes"],
              "f32_pages": {k: fm[k] for k in (
                  "tokens_per_s", "ttft_p50_ms", "model_calls",
                  "peak_kv_bytes")},
              "launches": launches,
              "f16_route_launches": {op: n for op, n in launches.items()
                                     if op.endswith("_f16")},
              "launches_per_tick": {op: sorted(set(v))
                                    for op, v in per_tick.items()},
              "tokens_vs_f32_pages": _near_tie_check(
                  f"{path} vs f32 pages", tokens, want, gaps),
              "near_tie_tol_rel": F16_E2E_RTOL})
        out[path] = launches
    return out


# -- the planner's knobs: measured autotuning and tile pins --------------------

#: the planner's knobs (``runtime/planner.py``)
KNOBS = ("REPRO_AUTOTUNE", "REPRO_BLOCKS_MATMUL", "REPRO_BLOCKS_ATTN")
#: the autotune phase's gemma-2b serving paths: ServeConfig knobs
AUTOTUNE_PATHS = {"paged": {}, "paged-bf16": {"kv_cache_dtype": "bfloat16"}}


@contextlib.contextmanager
def _knobs(**values):
    """Set the planner's knobs (unset where not given) for the block, with
    no measured winner or cached launch choice before or after; then
    every knob is unset again."""
    from repro_torch.runtime import planner
    for var in KNOBS:
        os.environ.pop(var, None)
    os.environ.update(values)
    planner.clear_plan_cache()
    try:
        yield planner
    finally:
        for var in KNOBS:
            os.environ.pop(var, None)
        planner.clear_plan_cache()


def _spx_inputs(torch, gen, m, k, n, packed, lut_size):
    """Random inputs of an ``spx_matmul`` launch key: x (m, k), codes of a
    ``lut_size``-entry codebook (sp2_4, pot4 or sp2_8), scale (1, n)."""
    from repro_torch.core import spx
    scheme = {16: "sp2_4", 32: "pot4", 256: "sp2_8"}[lut_size]
    lut = spx.codebook(spx.scheme_levels(scheme), device="cuda")
    codes = torch.randint(0, lut_size, (k, n // 2 if packed else n),
                          generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
    scale = torch.rand((1, n), generator=gen, device="cuda") * 0.05
    x = torch.randn((m, k), generator=gen, device="cuda")
    return x, codes, scale, lut


def _paged_inputs(torch, gen, key):
    """Random inputs of a paged-decode key (``planner.fused_decode_key``):
    pools of its dtype (codes and scales for a coded pool), a permuted
    block table, contexts from 0 to the table's end less the window, and
    full windows. Returns (q4 of rep * w rows, pools, bt, ctx, q_len,
    lut or None)."""
    from repro_torch.nn.attention import kv_lut, quantize_kv
    _, b, hkv, rep, w, dh, ps, mp, scheme, dtype = key
    n_pages = 1 + b * mp
    kp, vp = (torch.randn((n_pages, hkv, ps, dh), generator=gen,
                          device="cuda") for _ in range(2))
    if scheme is not None:
        pools, lut = (*quantize_kv(kp, scheme), *quantize_kv(vp, scheme)), \
            kv_lut(scheme, "cuda")
    else:
        pools, lut = (kp.to(getattr(torch, dtype)),
                      vp.to(getattr(torch, dtype))), None
    bt = torch.randperm(n_pages, generator=gen, device="cuda")[:b * mp] \
        .reshape(b, mp).to(torch.int32)
    top = max(mp * ps - w, 1)
    ctx = torch.linspace(0, top, b, device="cuda").to(torch.int32)
    q_len = torch.full((b,), w, dtype=torch.int32, device="cuda")
    q4 = torch.randn((b, hkv, rep * w, dh), generator=gen, device="cuda")
    return q4, pools, bt, ctx, q_len, lut


def _check_candidates(torch, gen, key, report) -> tuple:
    """Every candidate the tuner timed at ``key`` (``planner.MeasuredKey``)
    launched once on fresh inputs of the key's shape against its plain
    version, at the kernel phase's tolerances (spx_matmul: SPX_RTOL of the
    largest |plain|; f32 and code pools: ATTN_TOL (1 + |plain|); 16-bit
    pools: the per-slot bound), in both modes at w = 1. Returns (the worst
    relative error, the count checked, the refused candidates, and for
    spx_matmul the ms of ``torch.matmul`` on the dequantized weights, timed
    as the tuner times a launch)."""
    from repro_torch.core import spx
    from repro_torch.kernels import autotune
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda
    worst, checked, refused = 0.0, 0, []
    if key[0] == "spx_matmul":
        _, m, k, n, _, packed, lut_size, _ = key
        x, codes, scale, lut = _spx_inputs(torch, gen, m, k, n, packed,
                                           lut_size)
        want = ref.spx_matmul_ref(x, codes, scale, lut, packed=packed)
        peak = want.abs().max().item()
        w = lut[(spx.unpack_int4(codes) if packed else codes).long()] * scale
        library_s = autotune.event_runner(lambda _: torch.matmul(x, w))(None)
        for plan, t in report.tried:
            if t is None:
                refused.append(repr(plan))
                continue
            got = spx_matmul_cuda(x, codes, scale, lut, packed=packed,
                                  plan=plan)
            err = (got - want).abs().max().item() / peak
            require(err <= SPX_RTOL, f"autotune: {plan} at {key} is "
                                     f"{err:.3g} of the plain version's peak")
            worst, checked = max(worst, err), checked + 1
        return worst, checked, refused, library_s * 1e3
    q4, pools, bt, ctx, q_len, lut = _paged_inputs(torch, gen, key)
    w, dtype = key[4], key[-1]
    quant = lut is not None
    half = dtype in ("bfloat16", "float16")
    tol = {"bfloat16": BF16_ATTN_RTOL,
           "float16": F16_ATTN_RTOL}.get(dtype, ATTN_TOL)
    modes = [("ragged", q4, (ctx, q_len))]
    if w == 1:
        modes.append(("single", q4, (ctx + 1,)))
    for mode, q, tail in modes:
        if quant:
            args = (q, *pools, bt, *tail, lut)
            fn = (pa.paged_decode_ragged_quant_cuda if mode == "ragged"
                  else pa.paged_attention_quant_cuda)
            plain = (ref.paged_decode_ragged_quant_ref if mode == "ragged"
                     else ref.paged_attention_quant_ref)
        else:
            args = (q, *pools, bt, *tail)
            fn = (pa.paged_decode_ragged_cuda if mode == "ragged"
                  else pa.paged_attention_cuda)
            plain = (ref.paged_decode_ragged_ref if mode == "ragged"
                     else ref.paged_attention_ref)
        kw = {"w": w} if mode == "ragged" else {}
        want = plain(*args, **kw)
        for plan, t in report.tried:
            if t is None:
                refused.append(repr(plan))
                continue
            got = fn(*args, plan=plan, **kw)
            if half:
                err = _slot_rel_err(torch, got, want)
                ok = err <= tol
            else:
                err = ((got - want).abs() / (1 + want.abs())).max().item()
                ok = err <= tol
            require(ok, f"autotune: {mode} plan {plan} at {key}: {err:.3g}")
            worst, checked = max(worst, err), checked + 1
    return worst, checked, refused, None


def _emit_measured(torch, gen, where: str, seen: set) -> list:
    """One ``autotune`` line per key measured since ``seen`` (which it
    extends): the analytical plan and its device ms, the winner and its,
    the candidates tried and refused, the tuning seconds; each timed
    candidate checked against its plain version first."""
    from repro_torch.runtime import planner
    rows = []
    for key, r in planner.measured_report().items():
        if key in seen:
            continue
        seen.add(key)
        require(r.best is not None, f"autotune: nothing measured at {key}")
        worst, checked, refused, library_ms = _check_candidates(
            torch, gen, key, r)
        row = {"phase": "autotune", "where": where, "key": list(key),
               "analytical": repr(r.seed),
               "analytical_ms": None if r.seed_s is None else r.seed_s * 1e3,
               "winner": repr(r.best), "winner_ms": r.best_s * 1e3,
               "winner_is_analytical": r.best == r.seed,
               "candidates_tried": len(r.tried), "refused": refused,
               "tried_ms": [None if t is None else t * 1e3
                            for _, t in r.tried],
               "candidates_checked": checked,
               "max_rel_err_vs_plain": worst, "tuning_s": r.seconds}
        if key[0] == "spx_matmul":
            m, k = key[1], key[2]
            row["blocks"] = {"analytical": planner.spx_matmul_block(
                r.seed, m, k), "winner": planner.spx_matmul_block(
                    r.best, m, k)}
            row["library_ms"] = library_ms
            row["library_call"] = ("torch.matmul on the dequantized f32 "
                                   "weights, timed as the tuner times")
        emit(row)
        rows.append(row)
    return rows


def _autotune_serve(torch, np, params, cfg, prompts, path, knobs, seen):
    """gemma-2b on ``ServeConfig(quantize=None, **knobs)``: once with the
    knobs unset (top-2 gaps recorded), once under ``REPRO_AUTOTUNE=1``;
    the tuned tokens equal the unset run's but at a near-tie (E2E_RTOL).
    Returns (the path's summary, its measured keys' lines)."""
    from repro_torch.serving import ServeConfig, ServeEngine
    sc = ServeConfig(quantize=None, **knobs)
    runs = {}
    for mode, env in (("unset", {}), ("autotune", {"REPRO_AUTOTUNE": "1"})):
        with _knobs(**env) as planner:
            eng = ServeEngine(params, cfg, sc)
            gaps = _record_gaps(np, eng, E2E_RTOL) if mode == "unset" else None
            t0 = time.perf_counter()
            tokens, launches, plain, m = _run_engine(torch, eng, prompts)
            wall = time.perf_counter() - t0
            rows = (_emit_measured(torch, torch.Generator(device="cuda")
                                   .manual_seed(28), f"serve {path}", seen)
                    if mode == "autotune" else [])
            require(not plain, f"autotune {path} {mode}: plain versions ran")
            require(mode == "unset" or planner.measured_report(),
                    f"autotune {path}: nothing was measured")
            runs[mode] = {"tokens": tokens, "launches": launches,
                          "wall_s": wall, "tokens_per_s": m["tokens_per_s"],
                          "ttft_p50_ms": m["ttft_p50_ms"], "gaps": gaps,
                          "rows": rows}
            del eng
            torch.cuda.empty_cache()
    check = _near_tie_check(f"autotune {path}", runs["autotune"]["tokens"],
                            runs["unset"]["tokens"], runs["unset"]["gaps"])
    summary = {"path": path, "config": f"ServeConfig(quantize=None, "
               + ", ".join(f"{k}={v!r}" for k, v in knobs.items()) + ")",
               "tokens_vs_unset": check, "near_tie_tol_rel": E2E_RTOL,
               **{f"{mode}_{f}": runs[mode][f] for mode in runs
                  for f in ("wall_s", "tokens_per_s", "ttft_p50_ms",
                            "launches")},
               "measured_keys": len(runs["autotune"]["rows"]),
               "keys_won_by_another_launch": sum(
                   not r["winner_is_analytical"]
                   for r in runs["autotune"]["rows"])}
    return summary, runs["autotune"]["rows"]


def _autotune_mlp(torch, np, qparams, seen) -> tuple:
    """The paper MLP at M = 1, 64 and 1024 and the Q-network (sp2_4,
    ``min_size=256``) at M = 1, under ``REPRO_AUTOTUNE=1``: outputs within
    SPX_RTOL of the plain version's peak. Returns (summary, lines)."""
    from repro_torch.data import make_dataset
    from repro_torch.examples.rl_qlearning import Q_LAYERS, _q
    from repro_torch.models.mlp_mnist import mlp_net_init, paper_mlp_apply
    from repro_torch.nn.layers import quantize_params
    from repro_torch.runtime import Runtime

    x_np, _ = make_dataset(1024, seed=7)
    x = torch.as_tensor(x_np, device="cuda")
    qnet = quantize_params(mlp_net_init(
        torch.Generator(device="cuda").manual_seed(0), Q_LAYERS,
        device="cuda"), "sp2_4", min_size=256)
    s = torch.rand((1, Q_LAYERS[0]), generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda")
    runs = {f"paper_mlp M={m}": (lambda rt, m=m: paper_mlp_apply(
        qparams, x[:m].contiguous(), rt)) for m in (1, 64, 1024)}
    runs["q_network M=1"] = lambda rt: _q(qnet, s, rt)
    out = {}
    with _knobs(REPRO_AUTOTUNE="1"):
        for name, fn in runs.items():
            got = fn(Runtime())
            want = fn(Runtime(impl="ref"))
            again = fn(Runtime())
            torch.cuda.synchronize()
            err = (got - want).abs().max().item() / want.abs().max().item()
            require(err <= SPX_RTOL and torch.equal(got, again),
                    f"autotune {name}: {err:.3g} of the plain peak")
            out[name] = {"max_rel_err": err, "rerun_identical": True}
        rows = _emit_measured(torch, torch.Generator(device="cuda")
                              .manual_seed(29), "paper_mlp, q_network", seen)
    return out, rows


def _pinned_checks(torch, card: str) -> dict:
    """One legal ``REPRO_BLOCKS_MATMUL`` pin on the small kernel (the paper
    MLP's first layer at M = 64) and one on the decode kernel (gemma-2b's
    q projection at M = 4), one legal ``REPRO_BLOCKS_ATTN`` pin on the
    dense layout's 33-token prefill (8 query heads over 1 KV head of 256)
    and one at dh 128 (130 queries over 97 keys): each against its plain
    version, timed beside the unpinned launch by CUDA events; then one
    illegal pin of each kind must raise ``ValueError``."""
    from repro_torch.core.quantized import QuantizedTensor
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(30)
    out = {"card": card, "matmul": [], "attn": []}
    for (m, k, n), choose in (
            ((64, 784, 128), lambda p: p.path == "small"
             and (p.tile_m, p.tile_n, p.warps) == (16, 32, 8)),
            ((4, 2048, 2048), lambda p: p.path == "skinny"
             and p.splits == 8)):
        x, codes, scale, lut = _spx_inputs(torch, gen, m, k, n, True, 16)
        qt = QuantizedTensor(codes, scale, "sp2_4", True)
        with _knobs() as planner:
            analytical = planner.plan_spx_launch(m, k, n, True, 16, 132)
            block = next(b for b, p in sorted(planner.spx_pin_table(
                m, k, n, True).items()) if choose(p) and p != analytical)
            base_ms = _time_ms(torch, lambda: ops.spx_matmul(x, qt), reps=20)
        want = ref.spx_matmul_ref(x, codes, scale, lut, packed=True)
        pin = ",".join(map(str, block))
        with _knobs(REPRO_BLOCKS_MATMUL=pin) as planner:
            plan = planner.plan_spx_launch(m, k, n, True, 16, 132)
            ops.reset_op_calls()
            got = ops.spx_matmul(x, qt)
            paths = ops.path_calls()
            ms = _time_ms(torch, lambda: ops.spx_matmul(x, qt), reps=20)
        err = (got - want).abs().max().item() / want.abs().max().item()
        require(err <= SPX_RTOL and paths == {f"spx_matmul_{plan.path}": 1},
                f"pinned REPRO_BLOCKS_MATMUL={pin}: {err:.3g}, {paths}")
        out["matmul"].append({
            "shape": [m, k, n], "pin": pin, "plan": repr(plan),
            "analytical": repr(analytical), "max_rel_err": err,
            "ms": ms, "unpinned_ms": base_ms})
    with _knobs(REPRO_BLOCKS_MATMUL="100,100,100"):
        try:
            ops.spx_matmul(x, qt)
            raised = None
        except ValueError as e:
            raised = str(e)
    require(raised is not None and "legal (bm, bn, bk)" in raised,
            "an illegal REPRO_BLOCKS_MATMUL did not raise")
    out["matmul_illegal_raised"] = raised[:200]
    for b, hq, hkv, sq, skv, dh, pin in ((1, 8, 1, 33, 33, 256, "32,32"),
                                         (2, 8, 2, 130, 97, 128, "128,64")):
        q = torch.randn((b, hq, sq, dh), generator=gen, device="cuda")
        k, v = (torch.randn((b, hkv, skv, dh), generator=gen, device="cuda")
                for _ in range(2))
        want = ref.flash_attention_ref(q, k, v, causal=True, q_chunk=sq)
        with _knobs():
            base_ms = _time_ms(torch, lambda: ops.flash_attention(q, k, v),
                               reps=20)
        with _knobs(REPRO_BLOCKS_ATTN=pin):
            ops.reset_op_calls()
            got = ops.flash_attention(q, k, v)
            launches = ops.op_calls()
            ms = _time_ms(torch, lambda: ops.flash_attention(q, k, v),
                          reps=20)
        err = ((got - want).abs() / (1 + want.abs())).max().item()
        require(err <= ATTN_TOL and launches == {"flash_attention": 1},
                f"pinned REPRO_BLOCKS_ATTN={pin} at dh {dh}: {err:.3g}")
        out["attn"].append({"shape": [b, hq, hkv, sq, skv, dh], "pin": pin,
                            "max_rel_err": err, "ms": ms,
                            "unpinned_ms": base_ms})
    with _knobs(REPRO_BLOCKS_ATTN="128,64"):
        q = torch.randn((1, 8, 33, 256), device="cuda")
        k = torch.randn((1, 1, 33, 256), device="cuda")
        try:
            ops.flash_attention(q, k, k)
            raised = None
        except ValueError as e:
            raised = str(e)
    require(raised is not None and "[(32, 32), (64, 32)]" in raised,
            "an illegal REPRO_BLOCKS_ATTN did not raise")
    out["attn_illegal_raised"] = raised
    emit({"phase": "autotune", "pinned": out})
    return out


def autotune_phase(torch, np, params, mlp_qparams, card: str) -> dict:
    """The planner's knobs on the card. gemma-2b at full width on paged
    f32 and paged bf16 pages (``_autotune_serve``: knobs unset, then
    ``REPRO_AUTOTUNE=1``), the paper MLP and the Q-network under autotune
    (``_autotune_mlp``), every timed candidate held against its plain
    version (``_check_candidates``), one line per measured key; then the
    pinned launches (``_pinned_checks``). Every knob is unset and every
    table empty after. Returns what the kernels line carries."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma-2b")
    _, prompts = _prompts(np, cfg)
    t0 = time.perf_counter()
    seen: set = set()
    serve, rows = {}, []
    for path, knobs in AUTOTUNE_PATHS.items():
        serve[path], more = _autotune_serve(torch, np, params, cfg, prompts,
                                            path, knobs, seen)
        rows += more
    mlp, more = _autotune_mlp(torch, np, mlp_qparams, seen)
    rows += more
    pinned = _pinned_checks(torch, card)
    summary = {"phase": "autotune", "card": card, "serve": serve,
               "paper": mlp, "measured_keys": len(rows),
               "candidates_checked": sum(r["candidates_checked"]
                                         for r in rows),
               "refused": sum(len(r["refused"]) for r in rows),
               "tuning_s": sum(r["tuning_s"] for r in rows),
               "seconds": time.perf_counter() - t0}
    emit(summary)

    # the kernels line's row of each key: spx_matmul's by the analytical
    # launch's kernel, the paged kernels' by the pool's dtype
    out = collections.defaultdict(lambda: {"measured_launch_keys": [],
                                           "pinned_launch_keys": []})
    for r in rows:
        if r["key"][0] == "spx_matmul":
            name = ("spx_matmul_small" if r["analytical"].startswith(
                "SpxLaunchPlan(path='small'") else "spx_matmul")
        else:
            name = "paged_decode_ragged" + {"bfloat16": "_bf16",
                                            "float16": "_f16"}.get(
                r["key"][-1], "_quant" if r["key"][-2] else "")
        out[name]["measured_launch_keys"].append(
            {k: r.get(k) for k in ("key", "analytical", "analytical_ms",
                                   "winner", "winner_ms", "library_ms",
                                   "candidates_tried", "tuning_s")})
    for pin in pinned["matmul"]:
        name = ("spx_matmul_small" if "path='small'" in pin["plan"]
                else "spx_matmul")
        out[name]["pinned_launch_keys"].append(pin)
    out["flash_attention"]["pinned_launch_keys"] = pinned["attn"]
    return dict(out)


# -- phase 5: the MoE, recurrent and M-RoPE families ---------------------------

#: the spx_matmul (K, N) of every quantized projection of the four family
#: configurations: olmoe's attention; xlstm's mLSTM (in_proj, q/k/v,
#: w_gates, down_proj), sLSTM (w_in, out_proj) and the sLSTM slot's 4/3
#: FFN; qwen2-vl's attention and FFN; jamba's attention, FFN and mamba
#: (in_proj, x_proj, dt_proj, out_proj) at one period
FAMILY_SPX_SHAPES = (
    (2048, 2048),
    (1024, 4096), (2048, 8), (2048, 1024), (1024, 1024), (1024, 1408),
    (1408, 1024),
    (1536, 1536), (1536, 256), (1536, 8960), (8960, 1536),
    (2048, 256), (2048, 6144), (6144, 2048), (2048, 8192), (4096, 160),
    (128, 4096), (4096, 2048))
#: the ops whose launches serve_families records with their shapes
RECORDED_OPS = ("spx_matmul", "paged_decode_ragged", "paged_attention",
                "flash_attention")


def _family_configs() -> dict:
    """name -> (ArchConfig, the cuts from the published config). Jamba
    runs one period of its 72 layers at a cut width: the full model is
    398B parameters, and one of its MoE layers alone (16 experts of
    3 x 8192 x 24576) is 9.7B, 38.6 GB in f32 before quantization."""
    from repro_torch.configs import get_config
    jamba = get_config("jamba-1.5-large-398b")
    cut = dict(n_layers=8, d_model=2048, n_heads=16, n_kv_heads=2,
               d_ff=6144, ssm_dt_rank=128)
    return {
        "olmoe-1b-7b": (get_config("olmoe-1b-7b"), {}),
        "xlstm-350m": (get_config("xlstm-350m"), {}),
        "qwen2-vl-2b": (get_config("qwen2-vl-2b"), {}),
        "jamba-1.5-large-398b": (
            dataclasses.replace(jamba, **cut),
            {k: f"{getattr(jamba, k)} -> {v}" for k, v in cut.items()}),
    }


def _launch_key(op: str, args, kw) -> tuple:
    """What a kernel launch's shape is, as recorded and as checked."""
    if op.endswith("_quant"):
        q4, kc, _, _, _, bt = args[:6]
        return (op, tuple(q4.shape), tuple(kc.shape[1:]), str(kc.dtype),
                bt.shape[1], kw.get("w", 1))
    if op == "spx_matmul":
        x, _, scale, lut = args
        return (op, bool(kw["packed"]), lut.numel(), *x.shape,
                scale.numel())
    if op == "flash_attention":
        q, k = args[:2]
        return (op, tuple(q.shape), tuple(k.shape), bool(kw["causal"]),
                int(kw.get("q_offset", 0)))
    q4, kp, _, bt = args[:4]
    return (op, tuple(q4.shape), tuple(kp.shape[1:]), str(kp.dtype),
            bt.shape[1], kw.get("w", 1))


class _ShapeRecorder:
    """Swap the registry's CUDA impl of every op in ``ops`` (RECORDED_OPS
    by default) for one that records each launch's ``_launch_key``, and
    put them back on exit."""

    def __init__(self, torch, ops=RECORDED_OPS):
        from repro_torch.runtime import registry
        self.registry = registry
        self.saved = {op: registry.resolve(op, "cuda",
                                           torch.device("cuda"))[1]
                      for op in ops}
        self.keys: set = set()
        self.counts: collections.Counter = collections.Counter()

    def __enter__(self):
        for op, fn in self.saved.items():
            def recorded(*args, _op=op, _fn=fn, **kw):
                key = _launch_key(_op, args, kw)
                self.keys.add(key)
                self.counts[key] += 1
                return _fn(*args, **kw)
            self.registry.register(op, "cuda")(recorded)
        return self.keys

    def __exit__(self, *exc):
        for op, fn in self.saved.items():
            self.registry.register(op, "cuda")(fn)


def family_kernel_phase(torch, np) -> tuple[dict, set]:
    """The shapes that the four families give the kernels, each held
    against its plain version before serve_families launches it:
    ``spx_matmul`` at every (K, N) of FAMILY_SPX_SHAPES (sp2_4, packed) and
    every M the serving ticks give it (4 slots x the padded chunk, the
    dense prefill's prompt lengths), the decode kernel (M <= 8) and the
    tensor-core prefill kernel (M > 8) alike, N = 8 and N = 160 among
    them; kernels 2 and 5 at head_dim 128 with GQA ratios 1, 6 and 8 on
    the page size ``plan_kv_pages`` picks; flash attention at olmoe's
    heads for its dense prefill. A second launch must be bit-identical.
    Returns the worst errors and the checked launch keys."""
    from repro_torch.core import spx
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_decode_ragged_cuda)
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda
    from repro_torch.runtime import planner

    gen = torch.Generator(device="cuda").manual_seed(17)
    checked: set = set()
    worst = {"spx_matmul": 0.0, "paged_decode_ragged": 0.0,
             "paged_attention": 0.0, "flash_attention": 0.0}
    configs = {name: cfg for name, (cfg, _) in _family_configs().items()}
    lens, _ = _prompts(np, configs["olmoe-1b-7b"])
    ms = sorted({4 * c for c in (1, 2, 4, 8, 16, 32)} | set(lens)
                | {1, 9, 65, 256})
    lut = spx.codebook(spx.scheme_levels("sp2_4"), device="cuda")
    for k, n in FAMILY_SPX_SHAPES:
        codes = torch.randint(0, lut.numel(), (k, n // 2), generator=gen,
                              device="cuda", dtype=torch.int32)
        codes = (codes | (torch.randint_like(codes, 0, lut.numel()) << 4)) \
            .to(torch.uint8)
        scale = torch.rand((1, n), generator=gen, device="cuda") * 0.05
        errs = {}
        for m in ms:
            x = torch.randn((m, k), generator=gen, device="cuda")
            _, rec = _check_launch(torch, "spx_matmul", spx_matmul_cuda,
                                   ref.spx_matmul_ref, (x, codes, scale, lut),
                                   {"packed": True}, checked, worst, SPX_RTOL)
            errs[m] = rec["max_rel_err"]
        emit({"phase": "kernel", "kernel": "spx_matmul", "scheme": "sp2_4",
              "for": "serve_families", "K": k, "N": n,
              "max_rel_err_by_M": errs, "tol_rel": SPX_RTOL,
              "bit_identical_rerun": True, "ok": True})

    # (Hkv, rep, dh) of the attention families: olmoe (16, 1, 128),
    # qwen2-vl (2, 6, 128), jamba (2, 8, 128); 4 slots of max_seq 256
    heads = sorted({(c.n_kv_heads, c.n_heads // c.n_kv_heads, c.dh)
                    for c in configs.values()
                    if any(s.startswith("attn") for s in c.pattern)})
    b, max_seq = 4, 256
    for hkv, rep, dh in heads:
        ps = planner.plan_kv_pages(dh).page_size
        mp = -(-max_seq // ps)
        n_pages = 1 + b * mp
        kp, vp = _rand_pools(torch, gen, n_pages, hkv, ps, dh)
        bt = torch.randperm(n_pages - 1, generator=gen, device="cuda")[
            :b * mp].reshape(b, mp).to(torch.int32) + 1
        q = torch.randn((b, hkv, rep, dh), generator=gen, device="cuda")
        ctx = torch.tensor([ps - 1, ps, ps + 1, 3 * ps + 7],
                           dtype=torch.int32, device="cuda")
        qn = torch.tensor([0, 1, 1, 1], dtype=torch.int32, device="cuda")
        ctx1 = torch.tensor([0, 1, ps, 2 * ps + 3], dtype=torch.int32,
                            device="cuda")
        for name, launch, plain, args, kw in (
                ("paged_decode_ragged", paged_decode_ragged_cuda,
                 ref.paged_decode_ragged_ref, (q, kp, vp, bt, ctx, qn),
                 {"w": 1}),
                ("paged_attention", paged_attention_cuda,
                 ref.paged_attention_ref, (q, kp, vp, bt, ctx1), {})):
            got, rec = _check_launch(torch, name, launch, plain, args, kw,
                                     checked, worst)
            zeros = bool((got[0] == 0).all())
            emit({"phase": "kernel", "kernel": name, "for": "serve_families",
                  "hkv": hkv, "rep": rep, "dh": dh, "page_size": ps,
                  "max_pages": mp, **rec, "empty_row_exact_zero": zeros,
                  "ok": zeros})
            require(zeros, f"{name} hkv={hkv} rep={rep} dh={dh}: the empty "
                           "row is not zero")

    # olmoe's dense prefill: one prompt, 16 heads over 16 KV heads
    olmoe = configs["olmoe-1b-7b"]
    hq, hkv, dh = olmoe.n_heads, olmoe.n_kv_heads, olmoe.dh
    errs = {}
    for s in sorted(set(lens)):
        q = torch.randn((1, hq, s, dh), generator=gen, device="cuda")
        k, v = (torch.randn((1, hkv, s, dh), generator=gen, device="cuda")
                for _ in range(2))
        _, rec = _check_launch(torch, "flash_attention", flash_attention_cuda,
                               _flash_plain, (q, k, v), {"causal": True},
                               checked, worst)
        errs[s] = rec["max_abs_err"]
    emit({"phase": "kernel", "kernel": "flash_attention",
          "for": "serve_families", "hq": hq, "hkv": hkv, "dh": dh,
          "causal": True, "max_abs_err_by_len": errs,
          "tol": f"{ATTN_TOL} * (1 + |plain|)", "bit_identical_rerun": True,
          "ok": True})
    ops.reset_op_calls()
    return worst, checked


def _stack_periods(torch, trees):
    """Stack per-period param trees along a new leading (period) dim,
    QuantizedTensors by their codes and scales."""
    from repro_torch.core.quantized import QuantizedTensor
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_periods(torch, [t[k] for t in trees])
                for k in first}
    if isinstance(first, QuantizedTensor):
        return QuantizedTensor(torch.stack([t.codes for t in trees]),
                               torch.stack([t.scale for t in trees]),
                               first.scheme, first.packed)
    return torch.stack(trees)


def _quantized_slot(torch, gen, slot: str, cfg) -> dict:
    """One period of ``slot`` drawn from ``gen`` on the card and quantized
    to sp2_4. An MoE slot's expert stacks are drawn and quantized a block
    of experts at a time, the blocks of ``nn.moe.EXPERT_BLOCK_ELEMS``
    (``moe_init``'s scales; per (expert, column) scales, as the stacked
    quantization gives): a full-width jamba MoE layer, 38.6 GB in f32, is
    never whole in f32."""
    from repro_torch.core.quantized import QuantizedTensor, quantize_weight
    from repro_torch.nn.layers import dense_init, norm_init, quantize_params
    from repro_torch.nn.moe import EXPERT_BLOCK_ELEMS
    from repro_torch.nn.transformer import _slot_init

    mixer, _, ffn = slot.partition("+")
    if ffn != "moe":
        return quantize_params(_slot_init(gen, slot, cfg, torch.float32,
                                          device="cuda"), "sp2_4")
    require(not cfg.n_shared_experts, f"{cfg.name}: a shared expert")
    p = quantize_params(_slot_init(gen, mixer, cfg, torch.float32,
                                   device="cuda"), "sp2_4")
    d, f = cfg.d_model, cfg.d_ff
    moe = {"router": dense_init(gen, d, cfg.n_experts, device="cuda")}
    e, per = cfg.n_experts, max(1, EXPERT_BLOCK_ELEMS // (d * f))
    for name, (rows, cols) in (("gate", (d, f)), ("up", (d, f)),
                               ("down", (f, d))):
        qts = [quantize_weight(torch.randn(
            (min(per, e - lo), rows, cols), generator=gen, device="cuda")
            * rows ** -0.5, "sp2_4") for lo in range(0, e, per)]
        moe[name] = QuantizedTensor(torch.cat([q.codes for q in qts]),
                                    torch.cat([q.scale for q in qts]),
                                    qts[0].scheme, qts[0].packed)
        del qts
    p.update(norm2=norm_init(cfg.norm, d, device="cuda"), moe=moe)
    return p


def _family_params(torch, cfg, seed: int) -> dict:
    """Random weights from a seed on the card, each period's slots built
    and quantized to sp2_4 before the next is drawn (``_quantized_slot``:
    expert stacks one expert at a time): olmoe-1b-7b is 27.7 GB in f32,
    and building every period before quantizing would hold about twice
    that. Per-period quantization gives the stacked quantization's codes
    and scales (each scale is per period, expert and column)."""
    from repro_torch.nn.layers import dense_init, embedding_init, norm_init
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = {"embed": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                      device="cuda"),
              "final_norm": norm_init(cfg.norm, cfg.d_model,
                                      device="cuda")}
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                    device="cuda")
    slots = []
    for slot in cfg.pattern:
        slots.append(_stack_periods(torch, [
            _quantized_slot(torch, gen, slot, cfg)
            for _ in range(cfg.n_periods)]))
    params["stack"] = {"slots": slots}
    return params


def _projections(params) -> list:
    """Every quantized projection of the stack: (slot, path, stacked
    QuantizedTensor (P, K, N)). The MoE expert stacks are not among them:
    they are dequantized, not multiplied through spx_matmul."""
    from repro_torch.core.quantized import QuantizedTensor
    from repro_torch.nn.layers import tree_map
    out = []
    for j, slot_p in enumerate(params["stack"]["slots"]):
        def visit(path, leaf, j=j):
            if isinstance(leaf, QuantizedTensor) and path[-1] == "w":
                out.append((j, path, leaf))
            return leaf
        tree_map(visit, slot_p)
    return out


def _moe_layers(params) -> list:
    """The MoE params of every MoE slot and period, sliced per period."""
    from repro_torch.nn.layers import tree_index
    out = []
    for slot_p in params["stack"]["slots"]:
        if "moe" in slot_p:
            n = slot_p["moe"]["router"]["w"].shape[0]
            out += [tree_index(slot_p["moe"], i) for i in range(n)]
    return out


def _family_timing(torch, cfg, params, m: int) -> dict:
    """Per decode tick of ``m`` slots: ``spx_matmul`` over every quantized
    projection (its kernel, its plain version, ``torch.matmul`` on the
    dequantized weights, the bound), and the MoE experts of every MoE
    layer (``moe_apply`` on m tokens: the dequantize of the stacked experts
    and the batched products, the reference's library path)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda
    from repro_torch.nn.moe import moe_apply
    from repro_torch.runtime import Runtime

    gen = torch.Generator(device="cuda").manual_seed(23)
    mats = [qt[i] for _, _, qt in _projections(params)
            for i in range(qt.logical_shape[0])]
    lut = mats[0].lut()
    xs = {k: torch.randn((m, k), generator=gen, device="cuda")
          for k in {qt.logical_shape[0] for qt in mats}}

    def tick(fn):
        def run():
            for qt in mats:
                k, n = qt.logical_shape
                fn(xs[k], qt.codes, qt.scale.reshape(1, n), lut,
                   packed=True)
        return run

    dense = [qt.dequantize() for qt in mats]

    def library():
        for w in dense:
            torch.matmul(xs[w.shape[0]], w)

    nbytes = flops = 0
    for qt in mats:
        k, n = qt.logical_shape
        nbytes += m * k * 4 + k * n // 2 + n * 4 + 16 * 4 + m * n * 4
        flops += 2 * m * k * n
    row = {"per": f"decode tick: {len(mats)} launches, M={m}",
           "ms": _time_ms(torch, tick(spx_matmul_cuda)),
           "device_ms": _device_ms(torch, tick(spx_matmul_cuda),
                                   ("spx_matmul_kernel",)),
           "plain_ms": _time_ms(torch, tick(ref.spx_matmul_ref), reps=3),
           "library_ms": _time_ms(torch, library),
           "library_device_ms": _device_ms(torch, library, ("",)),
           "library_call": "torch.matmul on pre-dequantized f32 weights",
           "f32_bound_ms": _f32_bound_ms(nbytes, flops)}
    row["bound_ms"], row["bound_by"] = _bound_ms(nbytes, flops)
    del dense
    out = {"spx_matmul": row}
    moes = _moe_layers(params)
    if moes:
        rt = Runtime()
        x = torch.randn((m, 1, cfg.d_model), generator=gen, device="cuda")

        def experts():
            for p in moes:
                moe_apply(p, x, top_k=cfg.top_k, n_experts=cfg.n_experts,
                          capacity_factor=cfg.capacity_factor, rt=rt)

        codes_bytes = sum(p[k].codes.numel() + p[k].scale.numel() * 4
                          for p in moes for k in ("gate", "up", "down"))
        out["moe_experts"] = {
            "per": f"decode tick: {len(moes)} MoE layers, {m} tokens, "
                   f"{cfg.n_experts} experts top-{cfg.top_k}",
            "ms": _time_ms(torch, experts, reps=3),
            "device_ms": _device_ms(torch, experts, ("",), reps=2),
            "what": "moe_apply: router, dequantize of the stacked sp2_4 "
                    "experts to f32, batched products, combine",
            "codes_bytes": codes_bytes,
            "codes_read_bound_ms": codes_bytes / HBM_BYTES_PER_S * 1e3}
    torch.cuda.empty_cache()
    return out


def _serve_recorded(torch, np, eng, prompts, checked, name, *,
                    preempt_after=None, frames=None,
                    steps=("lm_paged_step", "lm_paged_fused_step"),
                    module=None, recorded=RECORDED_OPS):
    """Serve ``prompts`` (with ``frames``, an enc-dec model's inputs) on
    ``eng`` with the shape of every launch of ``recorded`` ops recorded
    and every model step (``steps`` of ``module``) counted; each launch
    must be at a shape the kernel phases checked. Returns (tokens, launches, plain
    calls, metrics, step records, preempted rid)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import Request
    records, restore = _record_steps(torch, steps, module)
    preempted = None
    try:
        with _ShapeRecorder(torch, recorded) as keys:
            torch.cuda.reset_peak_memory_stats()
            ops.reset_op_calls()
            for i, p in enumerate(prompts):
                eng.submit(Request(
                    rid=i, prompt=p, max_new_tokens=NEW_TOKENS,
                    frames=None if frames is None else frames[i]))
            if preempt_after is not None:
                for _ in range(preempt_after):
                    eng.step()
                preempted = next(r.rid for r in eng.slot_req
                                 if r is not None)
                eng.preempt(preempted)
            eng.run()
            torch.cuda.synchronize()
            launches, plain = ops.op_calls(), ops.ref_calls()
    finally:
        restore()
    unchecked = sorted(keys - checked)
    require(not unchecked, f"{name}: launches at shapes the kernel phases "
                           f"never held to the plain version: {unchecked}")
    tokens = {r.rid: list(r.output) for r in eng.finished}
    return tokens, launches, plain, eng.metrics(), records, preempted


def serve_families_phase(torch, np, card: str, checked: set) -> dict:
    """olmoe-1b-7b, xlstm-350m and qwen2-vl-2b at their published widths
    and depths, and jamba-1.5-large at one period, each built on the card
    from a seeded generator and quantized to sp2_4 (expert stacks too),
    each answering the serve phase's 8 greedy requests of 16 new tokens
    with ``ServeEngine(params, cfg, ServeConfig())`` (paged, cb, 4 slots,
    max_seq 256), one family at a time, each freed before the next.

    Each family's tokens are held to the same engine on the plain versions
    (``Runtime(impl="ref")``), a difference allowed only at a near-tie
    (E2E_RTOL). olmoe and xlstm are also served on the dense layout, held
    to the paged tokens; olmoe's pair runs at capacity_factor 64, as
    ``reduced`` does: at the published 1.25 the experts drop assignments
    by the batch's shape, and the reference's paged and dense layouts emit
    different tokens (tests/test_torch_state_cache.py). xlstm takes one
    injected preemption (its slab to the host and back). Every model step
    launches one spx_matmul per quantized projection, and one paged kernel
    per attention layer where the pattern has attention (none of xlstm's).
    olmoe and xlstm (SHARDED_FAMILIES) then serve the same requests
    on the same weights at shards=2 (``_serve_sharded_pair`` against the
    shards=1 run above), one shard's kernels timed. Returns, per family,
    its launches and the timing rows (and the sharded run's)."""
    from repro_torch.runtime import Runtime
    from repro_torch.serving import ServeConfig, ServeEngine

    out = {}
    for name, (cfg, cuts) in _family_configs().items():
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = _family_params(torch, cfg, seed=len(out))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        peak_setup = torch.cuda.max_memory_allocated()
        lens, prompts = _prompts(np, cfg)
        n_attn = cfg.n_periods * sum(s.startswith("attn")
                                     for s in cfg.pattern)
        per_call = sum(qt.logical_shape[0]
                       for _, _, qt in _projections(params))

        eng = ServeEngine(params, cfg, ServeConfig())
        slots = eng.batch_slots
        gaps = _record_gaps(np, eng, E2E_RTOL)
        tokens, launches, plain, m, records, _ = _serve_recorded(
            torch, np, eng, prompts, checked, name)
        peak_serve = torch.cuda.max_memory_allocated()
        require(len(tokens) == N_REQUESTS,
                f"{name}: {len(tokens)} of {N_REQUESTS} finished")
        for rid, toks in tokens.items():
            require(len(toks) == NEW_TOKENS
                    and all(0 <= t < cfg.vocab_size for t in toks),
                    f"{name}: request {rid}: bad output {toks}")
        require(not plain, f"{name}: plain versions ran on the card: {plain}")
        bad = [r for r in records if r[3].get("spx_matmul", 0) != per_call]
        require(not bad, f"{name}: model steps without {per_call} "
                         f"spx_matmul launches: {bad[:3]}")
        ticks = [r for r in records if r[0] == "lm_paged_fused_step"]
        one_token = [r for r in records if r[0] == "lm_paged_step"
                     and r[1] == 1]
        if n_attn:
            require(ticks and all(r[3].get("paged_decode_ragged") == n_attn
                                  for r in ticks),
                    f"{name}: decode ticks without {n_attn} ragged launches")
            require(one_token and all(r[3].get("paged_attention") == n_attn
                                      for r in one_token),
                    f"{name}: one-token chunks without {n_attn} "
                    "paged_attention launches")
        else:
            require(not {"paged_decode_ragged", "paged_attention"}
                    & set(launches), f"{name}: paged kernels launched "
                                     f"on a pageless pattern: {launches}")
        del eng
        _free(torch)

        ref_eng = ServeEngine(params, cfg, ServeConfig(),
                              rt=Runtime(impl="ref"))
        ref_gaps = _record_gaps(np, ref_eng, E2E_RTOL)
        want, ref_launches, ref_plain, _ = _run_engine(torch, ref_eng,
                                                       prompts)
        del ref_eng
        _free(torch)
        require(not ref_launches and ref_plain,
                f"{name}: the plain run launched {ref_launches}")
        vs_plain = _near_tie_check(f"{name} kernels vs plain", tokens, want,
                                   ref_gaps)
        result = {"phase": "serve_families", "arch": name,
                  "family": cfg.family, "pattern": list(cfg.pattern),
                  "layers": cfg.n_layers, "d_model": cfg.d_model,
                  "vocab": cfg.vocab_size, "reduced": cuts,
                  "config": "ServeConfig()", "card": card,
                  "page_size": m["page_size"], "n_pages": m["n_pages"],
                  "batch_slots": slots,
                  "prompt_lens": lens, "requests_finished": len(tokens),
                  "setup_s": setup_s, "tokens_per_s": m["tokens_per_s"],
                  "ttft_p50_ms": m["ttft_p50_ms"],
                  "latency_p50_ms": m["latency_p50_ms"],
                  "wall_s": m["wall_s"], "model_calls": m["model_calls"],
                  "peak_state_bytes": m["peak_state_bytes"],
                  "peak_kv_bytes": m["peak_kv_bytes"],
                  "peak_slabs": m["peak_slabs"],
                  "slab_bytes_per_seq": m["slab_bytes_per_seq"],
                  "max_memory_allocated_setup": peak_setup,
                  "max_memory_allocated_serve": peak_serve,
                  "launches": launches,
                  "launches_per_model_step": {
                      "spx_matmul": per_call,
                      "paged_decode_ragged_per_decode_tick":
                          n_attn if ticks else 0,
                      "paged_attention_per_one_token_chunk":
                          n_attn if one_token else 0},
                  "model_steps": len(records),
                  "tokens_vs_plain_versions": vs_plain,
                  "near_tie_tol_rel": E2E_RTOL}

        if name in ("olmoe-1b-7b", "xlstm-350m"):
            pair_cfg = (dataclasses.replace(cfg, capacity_factor=64.0)
                        if cfg.is_moe else cfg)
            pair, pair_gaps = {}, {}
            for layout in ("paged", "dense"):
                e = ServeEngine(params, pair_cfg,
                                ServeConfig(kv_layout=layout))
                pair_gaps[layout] = _record_gaps(np, e, E2E_RTOL)
                pair[layout], pair_launches, *_ = _serve_recorded(
                    torch, np, e, prompts, checked, f"{name} {layout}")
                del e
                _free(torch)
            if not cfg.is_moe:
                require(pair["paged"] == tokens,
                        f"{name}: the paged run is not repeatable")
            result["paged_vs_dense"] = {
                "capacity_factor": pair_cfg.capacity_factor
                if cfg.is_moe else None,
                "dense_launches": pair_launches,
                **_near_tie_check(f"{name} dense vs paged", pair["dense"],
                                  pair["paged"], pair_gaps["paged"])}
        if name == "xlstm-350m":
            e = ServeEngine(params, cfg, ServeConfig())
            got, _, _, pm, _, rid = _serve_recorded(
                torch, np, e, prompts, checked, f"{name} preempted",
                preempt_after=3)
            del e
            _free(torch)
            require(pm["preemptions"] >= 1 and pm["resumes"] >= 1
                    and pm["offload_bytes"] > 0,
                    f"{name}: preemption did not round-trip: {pm}")
            result["preemption"] = {
                "rid": rid, "preemptions": pm["preemptions"],
                "resumes": pm["resumes"],
                "offload_bytes": pm["offload_bytes"],
                "onload_bytes": pm["onload_bytes"],
                **_near_tie_check(f"{name} preempted vs paged", got, tokens,
                                  gaps)}
        result["timing"] = _family_timing(torch, cfg, params, 4)
        emit(result)
        out[name] = {"launches": launches, "timing": result["timing"]}
        if name in SHARDED_FAMILIES:
            # the same weights at shards=2, held to the shards=1 run above
            with _forced_shards():
                line, s_launches, s_eng = _serve_sharded_pair(
                    torch, np, params, cfg, prompts, {}, Runtime(), checked,
                    f"serve_sharded {name}", card, per_call=per_call,
                    n_attn=n_attn, base=(tokens, gaps, m))
            line.update(reduced=cuts, prompt_lens=lens,
                        timing=_sharded_family_timing(
                            torch, cfg, s_eng.params[0], n_attn))
            del s_eng
            _free(torch)
            emit(line)
            out[name]["sharded"] = {"launches": s_launches,
                                    "timing": line["timing"]}
        del params
        _free(torch)
    return out


def serve_jamba_phase(torch, np, card: str, checked: set) -> dict:
    """jamba-1.5-large at one period (8 of its 72 layers: attention, 7
    mamba mixers, 4 MoE layers of 16 experts top-2) and its published
    width (d_model 8192, 64 query heads over 8 KV heads of 128, d_ff
    24576, mamba d_state 16, dt_rank 256; arXiv:2403.19887): weights from
    a seed quantized to sp2_4 an expert at a time (``_family_params``),
    the serve phase's 8 requests through ``_serve_sharded_pair`` at
    shards=1 and at shards=2 (the experts expert-parallel, 8 a shard;
    the mamba mixers whole on each shard), tokens held to shards=1 up to
    a near-tie, per model step one spx_matmul per shard and projection
    and one paged kernel per shard in each decode tick and one-token
    step, every sharded launch at a shape ``sharded_kernel_phase``
    checked; one shard's kernels timed. Returns the sharded run's
    launches and timing rows."""
    from repro_torch.runtime import Runtime

    cfg, cuts = _jamba_full_config()
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _family_params(torch, cfg, seed=5)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    peak_setup = torch.cuda.max_memory_allocated()
    lens, prompts = _prompts(np, cfg)
    n_attn = cfg.n_periods * sum(s.startswith("attn") for s in cfg.pattern)
    per_call = sum(qt.logical_shape[0] for _, _, qt in _projections(params))
    with _forced_shards():
        line, launches, eng = _serve_sharded_pair(
            torch, np, params, cfg, prompts, {}, Runtime(), checked,
            f"serve_sharded {cfg.name}", card, per_call=per_call,
            n_attn=n_attn)
    line.update(reduced=cuts, prompt_lens=lens, params_setup_s=setup_s,
                max_memory_allocated_setup=peak_setup,
                timing=_sharded_family_timing(torch, cfg, eng.params[0],
                                              n_attn))
    del eng, params
    _free(torch)
    emit(line)
    return {"launches": launches, "timing": line["timing"]}


def _free(torch) -> None:
    """Drop an engine's caches: it holds itself in a cycle once
    ``_record_gaps`` wrapped its methods."""
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 5: whisper-small, the encoder-decoder -----------------------------

#: whisper-small's quantized projections (K, N): the attention's 768 x 768,
#: the MLP's 768 x 3072 and 3072 x 768
WHISPER_SPX_SHAPES = ((768, 768), (768, 3072), (3072, 768))
#: distinct encoder inputs among the serve phase's 8 requests (request i
#: takes input i % 3): 3 encoder passes, 5 requests served from the
#: shared cross region
WHISPER_INPUTS = 3
#: the paged engine's padded prefill chunks and decode windows (the fused
#: tick, and spec_k = 4's verify window)
WHISPER_CHUNKS = (1, 2, 4, 8, 16, 32)
WHISPER_WINDOWS = (1, 5)


def _whisper_config():
    from repro_torch.configs import get_config
    return get_config("whisper-small")


def _check_launch(torch, name, launch, plain, args, kw, checked, worst,
                  tol_rel=None) -> tuple:
    """One kernel launch at ``args`` twice against its plain version: the
    run fails unless the output is finite, the rerun bit-identical and the
    error within ATTN_TOL * (1 + |plain|) of every element (or, with
    ``tol_rel``, within tol_rel of the largest plain output; bf16 and f16
    pages: of each slot's). The error joins ``worst`` and the launch key of a
    recorded op joins ``checked``. Returns the output and the check's
    numbers."""
    from repro_torch.kernels import cuda_lib
    before = collections.Counter(cuda_lib.PATH_LAUNCHES)
    got, again, want = launch(*args, **kw), launch(*args, **kw), \
        plain(*args, **kw)
    torch.cuda.synchronize()
    path = [k.removeprefix("spx_matmul_") for k, n in
            (collections.Counter(cuda_lib.PATH_LAUNCHES) - before).items()]
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    if tol_rel is None:
        ok = _attn_ok(torch, got, want)
        tol = f"{ATTN_TOL} * (1 + |plain|)"
    elif name.endswith(("_bf16", "_f16")):
        ok = _slot_rel_err(torch, got, want) <= tol_rel
        tol = f"{tol_rel} of each slot's largest plain output"
    else:
        ok = err <= tol_rel * peak
        tol = f"{tol_rel} * max|plain|"
    ok = ok and bool(torch.isfinite(got).all()) \
        and bool(torch.equal(got, again))
    shapes = [tuple(a.shape) for a in args if hasattr(a, "shape")]
    require(ok, f"{name} {kw} at {shapes}: max_abs_err {err}, max|plain| "
                f"{peak}, tol {tol}, rerun identical "
                f"{bool(torch.equal(got, again))}")
    worst[name] = max(worst.get(name, 0.0), err)
    op = name.removesuffix("_bf16").removesuffix("_f16")
    if op in RECORDED_OPS or op in SHARDED_OPS:
        checked.add(_launch_key(op, args, kw))
    rec = {"max_abs_err": err, "max_rel_err": err / max(peak, 1e-30),
           "tol": tol, "bit_identical_rerun": True, "ok": True}
    if name == "spx_matmul":
        require(len(path) == 1, f"spx_matmul at {shapes}: kernels {path}")
        SPX_PATHS[_launch_key(op, args, kw)] = rec["path"] = path[0]
        if path[0] == "small":
            worst["spx_matmul_small"] = max(
                worst.get("spx_matmul_small", 0.0), err)
    return got, rec


def _flash_plain(q, k, v, *, causal, q_offset=0):
    """The plain version of kernel 4, all queries in one chunk."""
    from repro_torch.kernels import ref
    return ref.flash_attention_ref(q, k, v, causal=causal, q_chunk=q.shape[2],
                                   q_offset=q_offset)


def whisper_kernel_phase(torch, np) -> tuple[dict, set]:
    """Every shape whisper-small gives the kernels, each held against its
    plain version before the serve phase launches it, twice (the second
    launch bit-identical):

    * flash attention, 12 heads over 12 KV heads of 64: the encoder (1500
      frames, not causal); the cross-attention over 1500 encoder frames of
      every paged tick (4 slots x the padded chunk or window) and of the
      dense layout (one prompt, 4 slots x 1 token); the dense prefill's
      causal self-attention of each prompt;
    * kernels 2 and 5 at head_dim 64 with 12 KV heads on f32 and bf16
      pages (W = 1 and the W = 5 verify window), and kernel 3 over code
      pages;
    * spx_matmul at whisper's three (K, N), at M = 1500 (the encoder and
      the cross K/V projection of one input) and every M the paged and
      dense ticks give it.

    Returns the worst errors and the checked launch keys."""
    from repro_torch.core import spx
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_cuda, paged_decode_ragged_cuda,
        paged_decode_ragged_quant_cuda)
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda
    from repro_torch.nn.attention import kv_lut, quantize_kv
    from repro_torch.runtime import planner

    cfg = _whisper_config()
    gen = torch.Generator(device="cuda").manual_seed(29)
    checked: set = set()
    worst: dict = {}

    def check(name, launch, plain, args, kw, tol_rel=None, **record):
        _, rec = _check_launch(torch, name, launch, plain, args, kw, checked,
                               worst, tol_rel)
        emit({"phase": "kernel", "kernel": name, "for": "whisper", **record,
              **rec})

    lens, _ = _prompts(np, cfg)
    slots, enc, h, dh = 4, cfg.enc_seq_len, cfg.n_heads, cfg.dh
    rows = sorted({slots * c for c in WHISPER_CHUNKS + WHISPER_WINDOWS}
                  | set(lens) | {enc})
    lut = spx.codebook(spx.scheme_levels("sp2_4"), device="cuda")
    for k, n in WHISPER_SPX_SHAPES:
        codes = torch.randint(0, 256, (k, n // 2), generator=gen,
                              device="cuda", dtype=torch.int32) \
            .to(torch.uint8)
        scale = torch.rand((1, n), generator=gen, device="cuda") * 0.05
        for m in rows:
            x = torch.randn((m, k), generator=gen, device="cuda")
            check("spx_matmul", spx_matmul_cuda, ref.spx_matmul_ref,
                  (x, codes, scale, lut), {"packed": True}, tol_rel=SPX_RTOL,
                  K=k, N=n, M=m)

    shapes = ([(1, enc, enc, False)]
              + [(slots, c, enc, False)
                 for c in sorted(set(WHISPER_CHUNKS + WHISPER_WINDOWS))]
              + [(1, s, enc, False) for s in sorted(set(lens))]
              + [(1, s, s, True) for s in sorted(set(lens))])
    for b, sq, skv, causal in shapes:
        q = torch.randn((b, h, sq, dh), generator=gen, device="cuda")
        kv = tuple(torch.randn((b, h, skv, dh), generator=gen,
                               device="cuda") for _ in range(2))
        check("flash_attention", flash_attention_cuda, _flash_plain,
              (q, *kv), {"causal": causal}, B=b, Sq=sq, Skv=skv, dh=dh,
              causal=causal)

    b, hkv, max_seq = slots, cfg.n_kv_heads, 256
    for pool_dtype in (torch.float32, torch.bfloat16):
        ps = planner.plan_kv_pages(
            dh, act_bytes=torch.tensor([], dtype=pool_dtype).element_size()
        ).page_size
        mp = -(-max_seq // ps)
        n_pages = 1 + b * mp
        kp, vp = (t.to(pool_dtype) for t in
                  _rand_pools(torch, gen, n_pages, hkv, ps, dh))
        bt = (torch.randperm(n_pages - 1, generator=gen, device="cuda")[
            :b * mp].reshape(b, mp) + 1).to(torch.int32)
        suffix = "_bf16" if pool_dtype == torch.bfloat16 else ""
        tol = BF16_ATTN_RTOL if suffix else None
        for w, ctx_l, qlens in (
                (1, [0, ps - 1, ps, 3 * ps + 7], [0, 1, 1, 1]),
                (5, [0, ps - 2, ps + 1, 2 * ps], [0, 5, 3, 5])):
            q = torch.randn((b, hkv, w, dh), generator=gen, device="cuda")
            ctx, qn = (torch.tensor(v, dtype=torch.int32, device="cuda")
                       for v in (ctx_l, qlens))
            check("paged_decode_ragged" + suffix, paged_decode_ragged_cuda,
                  ref.paged_decode_ragged_ref, (q, kp, vp, bt, ctx, qn),
                  {"w": w}, tol_rel=tol, hkv=hkv, dh=dh, page_size=ps, w=w,
                  ctx_len=ctx_l, q_len=qlens)
        q = torch.randn((b, hkv, 1, dh), generator=gen, device="cuda")
        ctx = torch.tensor([0, 1, ps, 2 * ps + 3], dtype=torch.int32,
                           device="cuda")
        check("paged_attention" + suffix, paged_attention_cuda,
              ref.paged_attention_ref, (q, kp, vp, bt, ctx), {},
              tol_rel=tol, hkv=hkv, dh=dh, page_size=ps, mode="single-token")
    scheme = KV_SCHEME
    ps = planner.plan_kv_pages(dh, kv_scheme=scheme).page_size
    mp = -(-max_seq // ps)
    n_pages = 1 + b * mp
    kc, ks = quantize_kv(torch.randn((n_pages, hkv, ps, dh), generator=gen,
                                     device="cuda"), scheme)
    vc, vs = quantize_kv(torch.randn((n_pages, hkv, ps, dh), generator=gen,
                                     device="cuda"), scheme)
    bt = (torch.randperm(n_pages - 1, generator=gen, device="cuda")[
        :b * mp].reshape(b, mp) + 1).to(torch.int32)
    q = torch.randn((b, hkv, 1, dh), generator=gen, device="cuda")
    ctx = torch.tensor([0, ps - 1, ps, 3 * ps + 7], dtype=torch.int32,
                       device="cuda")
    qn = torch.tensor([0, 1, 1, 1], dtype=torch.int32, device="cuda")
    check("paged_decode_ragged_quant", paged_decode_ragged_quant_cuda,
          ref.paged_decode_ragged_quant_ref,
          (q, kc, ks, vc, vs, bt, ctx, qn, kv_lut(scheme, "cuda")), {"w": 1},
          hkv=hkv, dh=dh, page_size=ps, scheme=scheme)
    return worst, checked


def _whisper_params(torch, cfg, seed: int) -> dict:
    """Random whisper weights from a seed on the card, quantized to sp2_4
    (the engine takes them as they are: ``quantize_params`` passes
    quantized leaves through)."""
    from repro_torch.models.encdec import encdec_init
    from repro_torch.nn.layers import quantize_params
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return quantize_params(encdec_init(gen, cfg, device="cuda"), "sp2_4")


class _EncoderPasses:
    """Wrap ``models.encdec.encdec_cross_kv`` (the engine's encoder pass,
    looked up at each call): count the calls and each call's launches by
    op."""

    def __init__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import encdec
        self.module, self.ops = encdec, ops
        self.fn = encdec.encdec_cross_kv
        self.calls: list[dict] = []

    def __enter__(self):
        def wrapped(*args, **kw):
            before = self.ops.op_calls()
            out = self.fn(*args, **kw)
            after = self.ops.op_calls()
            self.calls.append({op: after[op] - before.get(op, 0)
                               for op in after
                               if after[op] != before.get(op, 0)})
            return out
        self.module.encdec_cross_kv = wrapped
        return self.calls

    def __exit__(self, *exc):
        self.module.encdec_cross_kv = self.fn


def serve_whisper_phase(torch, np, card: str, checked: set) -> dict:
    """whisper-small at its published width and depth (12 encoder and 12
    decoder layers, d_model 768, 12 heads of 64, d_ff 3072, vocab 51865,
    1500 encoder frames; arXiv:2212.04356), nothing cut: random weights
    from a seed quantized to sp2_4, 8 greedy requests of 16 new tokens
    (the serve phase's prompt lengths, one of 33) over 3 distinct encoder
    inputs of (1500, 768) f32 from a seed, through
    ``ServeEngine(params, cfg, ServeConfig())`` (paged, cb, fused tick, 4
    slots, max_seq 256). Held: every launch at a shape the kernel phase
    checked; 3 encoder passes (one per distinct input), each 96
    spx_matmul launches (12 layers x 6 projections and 12 x the cross K
    and V) and 12 flash launches; each decoder step 96 spx_matmul launches
    (12 layers x 8), 12 flash launches (the cross-attention), and 12 of
    kernel 2 (fused tick) or kernel 5 (a one-token chunk); cross_hits >= 5,
    peak_cross <= 3, cross_bytes_per_entry == 110,592,000; tokens equal to
    the same engine's on the plain versions, to the dense layout's and to
    a speculative run's (spec_k = 4), a difference allowed only at a
    near-tie (E2E_RTOL). Then the same at shards=2 (6 heads and 1536 FFN
    columns per shard, the vocabulary of 51865 cut on d), held to the
    shards=1 run: per encoder pass and per model step twice the launches,
    every one at a shape ``sharded_kernel_phase`` checked; one shard's
    kernels timed. Returns the launches and the timing rows."""
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.runtime import Runtime
    from repro_torch.serving import ServeConfig, ServeEngine

    cfg = _whisper_config()
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _whisper_params(torch, cfg, seed=7)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    peak_setup = torch.cuda.max_memory_allocated()
    lens, prompts = _prompts(np, cfg)
    inputs = np.random.default_rng(11).standard_normal(
        (WHISPER_INPUTS, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    frames = [inputs[i % WHISPER_INPUTS] for i in range(N_REQUESTS)]
    steps = ("encdec_paged_step", "encdec_paged_fused_step")
    per_step = cfg.n_layers * 8
    per_pass = cfg.n_enc_layers * 6 + cfg.n_layers * 2

    eng = ServeEngine(params, cfg, ServeConfig())
    gaps = _record_gaps(np, eng, E2E_RTOL)
    with _EncoderPasses() as passes:
        tokens, launches, plain, m, records, _ = _serve_recorded(
            torch, np, eng, prompts, checked, "whisper-small",
            frames=frames, steps=steps, module=encdec_mod)
    peak_serve = torch.cuda.max_memory_allocated()
    del eng
    _free(torch)
    require(len(tokens) == N_REQUESTS,
            f"whisper: {len(tokens)} of {N_REQUESTS} finished")
    for rid, toks in tokens.items():
        require(len(toks) == NEW_TOKENS
                and all(0 <= t < cfg.vocab_size for t in toks),
                f"whisper: request {rid}: bad output {toks}")
    require(not plain, f"whisper: plain versions ran on the card: {plain}")
    require(len(passes) == WHISPER_INPUTS and all(
        p == {"spx_matmul": per_pass, "flash_attention": cfg.n_enc_layers}
        for p in passes), f"whisper: encoder passes {passes}")
    bad = [r for r in records
           if r[3].get("spx_matmul") != per_step
           or r[3].get("flash_attention") != cfg.n_layers]
    require(not bad, f"whisper: model steps without {per_step} spx_matmul "
                     f"and {cfg.n_layers} flash launches: {bad[:3]}")
    ticks = [r for r in records if r[0] == "encdec_paged_fused_step"]
    one_token = [r for r in records if r[0] == "encdec_paged_step"
                 and r[1] == 1]
    require(ticks and all(r[3].get("paged_decode_ragged") == cfg.n_layers
                          for r in ticks),
            "whisper: decode ticks without one ragged launch per layer")
    require(one_token and all(r[3].get("paged_attention") == cfg.n_layers
                              for r in one_token),
            "whisper: one-token chunks without one paged_attention launch "
            "per layer")
    cross = {k: m[k] for k in ("n_cross", "cross_lookups", "cross_hits",
                               "peak_cross", "cross_evictions",
                               "cross_bytes_per_entry")}
    require(cross["cross_hits"] >= N_REQUESTS - WHISPER_INPUTS
            and cross["peak_cross"] <= WHISPER_INPUTS
            and cross["cross_bytes_per_entry"] == 110_592_000,
            f"whisper: the cross region {cross}")

    ref_eng = ServeEngine(params, cfg, ServeConfig(), rt=Runtime(impl="ref"))
    ref_gaps = _record_gaps(np, ref_eng, E2E_RTOL)
    want, ref_launches, ref_plain, _ = _run_engine(torch, ref_eng, prompts,
                                                   frames=frames)
    del ref_eng
    _free(torch)
    require(not ref_launches and ref_plain,
            f"whisper: the plain run launched {ref_launches}")
    result = {"phase": "serve_whisper", "arch": cfg.name,
              "layers": cfg.n_layers, "encoder_layers": cfg.n_enc_layers,
              "d_model": cfg.d_model, "heads": cfg.n_heads,
              "head_dim": cfg.dh, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
              "encoder_frames": cfg.enc_seq_len, "reduced": {},
              "config": "ServeConfig()", "card": card,
              "page_size": m["page_size"], "batch_slots": 4,
              "prompt_lens": lens, "distinct_inputs": WHISPER_INPUTS,
              "requests_finished": len(tokens), "setup_s": setup_s,
              "tokens_per_s": m["tokens_per_s"],
              "ttft_p50_ms": m["ttft_p50_ms"],
              "latency_p50_ms": m["latency_p50_ms"], "wall_s": m["wall_s"],
              "model_calls": m["model_calls"], **cross,
              "peak_state_bytes": m["peak_state_bytes"],
              "peak_kv_bytes": m["peak_kv_bytes"],
              "max_memory_allocated_setup": peak_setup,
              "max_memory_allocated_serve": peak_serve,
              "launches": launches,
              "launches_per_encoder_pass": passes[0],
              "launches_per_model_step": {
                  "spx_matmul": per_step,
                  "flash_attention": cfg.n_layers,
                  "paged_decode_ragged_per_decode_tick": cfg.n_layers,
                  "paged_attention_per_one_token_chunk": cfg.n_layers},
              "model_steps": len(records),
              "tokens_vs_plain_versions": _near_tie_check(
                  "whisper kernels vs plain", tokens, want, ref_gaps),
              "near_tie_tol_rel": E2E_RTOL}
    for path, sc in (("dense", ServeConfig(kv_layout="dense")),
                     ("spec", ServeConfig(spec_decode=True, spec_k=4))):
        e = ServeEngine(params, cfg, sc)
        got, path_launches, path_plain, pm, _, _ = _serve_recorded(
            torch, np, e, prompts, checked, f"whisper {path}",
            frames=frames, steps=steps, module=encdec_mod)
        del e
        _free(torch)
        require(not path_plain, f"whisper {path}: plain versions ran")
        result[path] = {"launches": path_launches,
                        "model_calls": pm["model_calls"],
                        "tokens_per_s": pm["tokens_per_s"],
                        **_near_tie_check(f"whisper {path} vs paged", got,
                                          tokens, gaps)}
        if path == "spec":
            result[path]["draft_acceptance_rate"] = \
                pm["draft_acceptance_rate"]
    result["timing"] = _whisper_timing(torch, cfg, params)
    emit(result)

    # the same weights at shards=2: the encoder tensor-parallel, each
    # shard's cross K/V into its head-sharded cross region
    with _forced_shards(), _EncoderPasses() as s_passes:
        line, s_launches, s_eng = _serve_sharded_pair(
            torch, np, params, cfg, prompts, {}, Runtime(), checked,
            "serve_sharded whisper-small", card, per_call=per_step,
            n_attn=cfg.n_layers, base=(tokens, gaps, m), frames=frames,
            module=encdec_mod, recorded=SHARDED_OPS + ("flash_attention",))
    want_pass = {"spx_matmul": SHARDS * per_pass,
                 "flash_attention": SHARDS * cfg.n_enc_layers}
    require(len(s_passes) == WHISPER_INPUTS
            and all(p == want_pass for p in s_passes),
            f"whisper at shards={SHARDS}: encoder passes {s_passes}")
    h, sm = _shard_heads(cfg), s_eng.metrics()
    line.update(prompt_lens=lens, distinct_inputs=WHISPER_INPUTS,
                launches_per_encoder_pass=s_passes[0],
                cross={k: sm[k] for k in ("cross_hits", "peak_cross",
                                          "cross_bytes_per_entry")},
                timing=_whisper_timing(
                    torch, dataclasses.replace(cfg, n_heads=h["hq"],
                                               n_kv_heads=h["hkv"]),
                    s_eng.params[0]))
    for row in (line["timing"]["spx_matmul"],
                line["timing"]["paged_decode_ragged"],
                *line["timing"]["flash_attention"].values()):
        row["per"] = f"one shard of {SHARDS}: " + row["per"]
    del s_eng
    _free(torch)
    emit(line)
    wide = _whisper_wide(torch, np, params, cfg, prompts, lens, frames,
                         (tokens, gaps, m), per_step, per_pass, card,
                         checked)
    del params
    _free(torch)
    return {"launches": launches, "dense_launches": result["dense"]
            ["launches"], "timing": result["timing"],
            "sharded": {"launches": s_launches, "timing": line["timing"]},
            "wide": wide}


def _whisper_wide(torch, np, params, cfg, prompts, lens, frames, base,
                  per_step, per_pass, card, checked) -> dict:
    """whisper-small at WIDE's 8 shards on serve_whisper's weights and
    inputs, held to its shards=1 run (``base``): 12 heads as 2, 2, 2, 2,
    1, 1, 1, 1 a shard over the replicated KV heads; per encoder pass and
    per model step each shard launches its cut of every projection and
    one flash kernel per layer; the kernels of shard 0 (2 heads) and of
    shard 4 (1 head) timed. Returns the run's launches and timing."""
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.runtime import Runtime
    from repro_torch.runtime.planner import shard_heads

    n = WIDE["whisper-small"]
    with _forced_shards(n), _EncoderPasses() as passes:
        line, launches, eng = _serve_sharded_pair(
            torch, np, params, cfg, prompts, {}, Runtime(), checked,
            f"serve_wide whisper-small shards={n}", card, per_call=per_step,
            n_attn=cfg.n_layers, base=base, frames=frames,
            module=encdec_mod, recorded=SHARDED_OPS + ("flash_attention",),
            shards=n)
    want_pass = {"spx_matmul": n * per_pass,
                 "flash_attention": n * cfg.n_enc_layers}
    require(len(passes) == WHISPER_INPUTS
            and all(p == want_pass for p in passes),
            f"whisper at shards={n}: encoder passes {passes}")
    groups = shard_heads(cfg.n_heads, cfg.n_kv_heads, n)
    timing = {}
    for s in (0, n // 2):
        heads = groups[s].nq
        t = _whisper_timing(torch, dataclasses.replace(
            cfg, n_heads=heads, n_kv_heads=heads), eng.params[s])
        for row in (t["spx_matmul"], t["paged_decode_ragged"],
                    *t["flash_attention"].values()):
            row["per"] = f"shard {s} of {n} ({heads} heads): " + row["per"]
        timing[f"shard {s} ({heads} heads)"] = t
    line.update(phase="serve_wide", prompt_lens=lens,
                launches_per_encoder_pass=passes[0],
                head_groups=[g.nq for g in groups], timing=timing)
    del eng
    emit(line)
    return {"launches": launches, "timing": timing}


def _whisper_timing(torch, cfg, params) -> dict:
    """Per whisper step, on its weights: spx_matmul over one encoder pass
    (96 launches at M = 1500), the flash kernel over one encoder pass (12
    launches of 1500 x 1500) and over a decode tick's and a 32-token
    prefill chunk's cross-attention (12 launches over 1500 frames, 4
    slots), and kernel 2 over a decode tick (12 layers, 4 slots, 49
    tokens attended each, head_dim 64)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda
    from repro_torch.nn.layers import tree_index

    gen = torch.Generator(device="cuda").manual_seed(31)
    enc = cfg.enc_seq_len
    mats = []
    for name in ("wq", "wk", "wv", "wo"):
        qt = params["enc_stack"]["slots"][0]["attn"][name]["w"]
        mats += [qt[i] for i in range(cfg.n_enc_layers)]
    for name in ("up", "down"):
        qt = params["enc_stack"]["slots"][0]["mlp"][name]["w"]
        mats += [qt[i] for i in range(cfg.n_enc_layers)]
    for name in ("wk", "wv"):
        qt = params["dec_stack"]["slots"][0]["xattn"][name]["w"]
        mats += [qt[i] for i in range(cfg.n_layers)]
    lut = mats[0].lut()
    xs = {k: torch.randn((enc, k), generator=gen, device="cuda")
          for k in {qt.logical_shape[0] for qt in mats}}

    def tick(fn):
        def run():
            for qt in mats:
                k, n = qt.logical_shape
                fn(xs[k], qt.codes, qt.scale.reshape(1, n), lut,
                   packed=True)
        return run

    dense = [qt.dequantize() for qt in mats]

    def library():
        for w in dense:
            torch.matmul(xs[w.shape[0]], w)

    nbytes = flops = 0
    for qt in mats:
        k, n = qt.logical_shape
        nbytes += enc * k * 4 + k * n // 2 + n * 4 + 16 * 4 + enc * n * 4
        flops += 2 * enc * k * n
    spx = {"per": f"encoder pass: {len(mats)} launches, M={enc}",
           "ms": _time_ms(torch, tick(spx_matmul_cuda), reps=3),
           "device_ms": _device_ms(torch, tick(spx_matmul_cuda),
                                   ("spx_matmul_kernel",), reps=2),
           "plain_ms": _time_ms(torch, tick(ref.spx_matmul_ref), reps=1,
                                warmup=1),
           "library_ms": _time_ms(torch, library, reps=3),
           "library_device_ms": _device_ms(torch, library, ("",), reps=2),
           "library_call": "torch.matmul on pre-dequantized f32 weights",
           "f32_bound_ms": _f32_bound_ms(nbytes, flops)}
    spx["bound_ms"], spx["bound_by"] = _bound_ms(nbytes, flops)
    spx["share_of_bound"] = spx["bound_ms"] / spx["device_ms"] \
        if spx["device_ms"] else None
    del dense
    h, dh, L = cfg.n_heads, cfg.dh, cfg.n_layers
    flash = {
        "encoder": _flash_shape_timing(
            torch, gen, b=1, hq=h, hkv=h, sq=enc, skv=enc, dh=dh,
            causal=False, layers=cfg.n_enc_layers,
            per=f"encoder pass: {cfg.n_enc_layers} launches, {enc} frames "
                f"not causal, {h} heads of {dh}"),
        "cross_decode_tick": _flash_shape_timing(
            torch, gen, b=4, hq=h, hkv=h, sq=1, skv=enc, dh=dh,
            causal=False, layers=L,
            per=f"decode tick: {L} launches, 4 slots x 1 query over {enc} "
                "encoder frames"),
        "cross_prefill_chunk": _flash_shape_timing(
            torch, gen, b=4, hq=h, hkv=h, sq=32, skv=enc, dh=dh,
            causal=False, layers=L,
            per=f"prefill tick: {L} launches, 4 slots x 32 queries over "
                f"{enc} encoder frames")}
    ragged = _paged_dh_timing(torch, gen, hkv=cfg.n_kv_heads, rep=1, dh=dh,
                              layers=L)
    torch.cuda.empty_cache()
    return {"spx_matmul": spx, "flash_attention": flash,
            "paged_decode_ragged": ragged}


def _paged_dh_timing(torch, gen, *, hkv, rep, dh, layers, m=4,
                     ctx_tokens=48, max_seq=256) -> dict:
    """Kernel 2 over a decode tick: ``layers`` launches, ``m`` slots each
    ``ctx_tokens + 1`` tokens in, f32 pages of the planner's size; beside
    its plain version and SDPA over the pre-gathered K/V."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode_ragged_cuda
    from repro_torch.runtime import planner
    ps = planner.plan_kv_pages(dh).page_size
    mp = -(-max_seq // ps)
    n_pages = m * mp
    pools = [_rand_pools(torch, gen, n_pages, hkv, ps, dh)
             for _ in range(layers)]
    bt = torch.arange(n_pages, dtype=torch.int32,
                      device="cuda").reshape(m, mp)
    q = torch.randn((m, hkv, rep, dh), generator=gen, device="cuda")
    ctx = torch.full((m,), ctx_tokens, dtype=torch.int32, device="cuda")
    one = torch.ones((m,), dtype=torch.int32, device="cuda")
    attend = ctx_tokens + 1
    gathered = [(ref._gather(kp, bt)[:, :, :attend].repeat_interleave(rep, 1),
                 ref._gather(vp, bt)[:, :, :attend].repeat_interleave(rep, 1))
                for kp, vp in pools]
    q_sdpa = q.reshape(m, hkv * rep, 1, dh)

    def kernel():
        for kp, vp in pools:
            paged_decode_ragged_cuda(q, kp, vp, bt, ctx, one, w=1)

    def library():
        for k, v in gathered:
            F.scaled_dot_product_attention(q_sdpa, k, v)

    nbytes = layers * (m * hkv * attend * dh * 4 * 2
                       + 2 * m * hkv * rep * dh * 4 + m * (mp + 2) * 4)
    flops = layers * 4 * m * hkv * rep * dh * attend
    row = {"per": f"decode tick: {layers} launches, {m} slots, {attend} "
                  f"tokens attended each, {hkv} KV heads of {dh}, "
                  f"{ps}-token f32 pages",
           "ms": _time_ms(torch, kernel),
           "device_ms": _device_ms(torch, kernel, PAGED_KERNELS),
           "plain_ms": _time_ms(torch, lambda: [ref.paged_decode_ragged_ref(
               q, kp, vp, bt, ctx, one, w=1) for kp, vp in pools]),
           "library_ms": _time_ms(torch, library),
           "library_device_ms": _device_ms(torch, library, ("",)),
           "library_call": "scaled_dot_product_attention over pre-gathered "
                           "K/V",
           "f32_bound_ms": _f32_bound_ms(nbytes, flops)}
    row["bound_ms"], row["bound_by"] = _bound_ms(nbytes, flops)
    row["share_of_bound"] = row["bound_ms"] / row["device_ms"] \
        if row["device_ms"] else None
    return row


# -- phase 5: training the LM ------------------------------------------------

#: the gemma-2b training runs of the train phase: batch 2 x 256 tokens
TRAIN_ARGS = ("--arch", "gemma-2b", "--batch", "2", "--seq", "256")
#: the resumed step-3 loss against the unbroken run's: |a - b| <= this *
#: |b|. Both runs take the same batches from the same weights and moments
#: (the checkpoint holds them exactly); the kernels are bit-identical
#: across launches.
RESUME_RTOL = 1e-5
#: examples/train_llm.py's steps, batch and tokens (granite-100m)
TRAIN_LLM_STEPS, TRAIN_LLM_BATCH, TRAIN_LLM_SEQ = 300, 16, 256
#: the flash Function's gradients against plain autograd: |a - b| <= this
#: * max|b| per input (its backward is the plain version's recompute; its
#: forward the kernel's f32 sums in another order)
GRAD_RTOL = 1e-4



def _train_flash_shapes() -> tuple:
    """(run, (B, Hq, Hkv, Sq, Skv, dh, causal)) of every flash launch the
    train phase makes: gemma-2b and whisper-small at TRAIN_ARGS' batch and
    tokens (whisper's encoder over its 1500 frames, its decoder's causal
    self-attention, and its cross-attention from the tokens to the
    frames), and train_llm's granite-100m."""
    from repro_torch.configs import get_config
    from repro_torch.examples.train_llm import make_100m_cfg
    gemma, granite, whisper = (get_config("gemma-2b"), make_100m_cfg(),
                               _whisper_config())
    b, s = int(TRAIN_ARGS[3]), int(TRAIN_ARGS[5])
    enc, wh = whisper.enc_seq_len, (whisper.n_heads, whisper.n_kv_heads)
    return (("gemma-2b", (b, gemma.n_heads, gemma.n_kv_heads, s, s,
                          gemma.dh, True)),
            ("whisper encoder", (b, *wh, enc, enc, whisper.dh, False)),
            ("whisper decoder", (b, *wh, s, s, whisper.dh, True)),
            ("whisper cross", (b, *wh, s, enc, whisper.dh, False)),
            ("granite-100m", (TRAIN_LLM_BATCH, granite.n_heads,
                              granite.n_kv_heads, TRAIN_LLM_SEQ,
                              TRAIN_LLM_SEQ, granite.dh, True)))


def _train_flash_inputs(torch, gen, b, hq, hkv, sq, skv, dh):
    q = torch.randn((b, hq, sq, dh), generator=gen, device="cuda")
    k, v = (torch.randn((b, hkv, skv, dh), generator=gen, device="cuda")
            for _ in range(2))
    return q, k, v


def train_kernel_phase(torch, np) -> tuple[dict, set]:
    """Kernel 4's forward at every shape of ``_train_flash_shapes``, held
    against its plain version and bit-identical on a second launch, before
    the train phase launches it there (``_train_run`` requires it).
    Returns the worst errors and the checked launch keys."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device="cuda").manual_seed(47)
    checked: set = set()
    worst: dict = {}
    for name, (b, hq, hkv, sq, skv, dh, causal) in _train_flash_shapes():
        q, k, v = _train_flash_inputs(torch, gen, b, hq, hkv, sq, skv, dh)
        _, rec = _check_launch(torch, "flash_attention", flash_attention_cuda,
                               _flash_plain, (q, k, v), {"causal": causal},
                               checked, worst)
        emit({"phase": "kernel", "kernel": "flash_attention", "for": "train",
              "run": name, "B": b, "Hq": hq, "Hkv": hkv, "Sq": sq,
              "Skv": skv, "dh": dh, "causal": causal, **rec})
    return worst, checked


def _flash_function_checks(torch) -> dict:
    """``FlashAttentionFn`` with the kernel's forward against plain
    autograd through the plain version, at every shape of
    ``_train_flash_shapes``: the output is the kernel's, bit for bit, and
    each input's gradient within GRAD_RTOL of the plain one's largest."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_autograd,
                                                     flash_attention_cuda)
    gen = torch.Generator(device="cuda").manual_seed(37)
    out = {}
    for name, (b, hq, hkv, sq, skv, dh, causal) in _train_flash_shapes():
        q, k, v = _train_flash_inputs(torch, gen, b, hq, hkv, sq, skv, dh)
        g = torch.randn(q.shape, generator=gen, device="cuda")

        def run(fn):
            ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o = fn(*ts)
            return o.detach(), torch.autograd.grad(o, ts, g)
        got, got_g = run(lambda *t: flash_attention_autograd(
            *t, causal=causal, q_chunk=1024))
        want, want_g = run(lambda *t: ref.flash_attention_ref(
            *t, causal=causal, q_chunk=1024))
        torch.cuda.synchronize()
        errs = [((a - w).abs().max() / w.abs().max()).item()
                for a, w in zip(got_g, want_g)]
        same = bool(torch.equal(got, flash_attention_cuda(q, k, v,
                                                          causal=causal)))
        ok = same and _attn_ok(torch, got, want) \
            and max(errs) <= GRAD_RTOL
        out[name] = {"shape": [b, hq, hkv, sq, skv, dh], "causal": causal,
                     "forward_is_kernel": same,
                     "forward_max_abs_err": (got - want).abs().max().item(),
                     "grad_max_rel_err": dict(zip(("q", "k", "v"), errs)),
                     "tol_grad_rel": GRAD_RTOL, "ok": ok}
        require(ok, f"flash Function at {name}: {out[name]}")
    return out


def _train_run(torch, name, run, checked, *, killed=False) -> tuple:
    """Run ``run()`` (a training entry point) with every count set to 0
    just before and read just after; every flash launch must have gone
    through ``FlashAttentionFn`` (as many Function forwards as launches, as
    many backwards) at a shape the kernel phases held to the plain version
    (``checked``), and nothing else may launch or run a plain version.
    Returns (history or None when ``killed``, record)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import FUNCTION_CALLS
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_op_calls()
    FUNCTION_CALLS.clear()
    t0 = time.perf_counter()
    hist = None
    with _ShapeRecorder(torch) as keys:
        try:
            hist = run()
        except KeyboardInterrupt:
            require(killed, f"{name}: interrupted")
        else:
            require(not killed, f"{name}: the injected kill did not fire")
    torch.cuda.synchronize()
    launches, plain = ops.op_calls(), ops.ref_calls()
    fn = dict(FUNCTION_CALLS)
    require(launches == {"flash_attention": fn.get("forward", -1)}
            and fn.get("backward") == fn.get("forward") and not plain,
            f"{name}: launches {launches}, Function calls {fn}, plain "
            f"{plain}")
    unchecked = sorted(keys - checked)
    require(not unchecked, f"{name}: flash launches at shapes the kernel "
                           f"phases never held to the plain version: "
                           f"{unchecked}")
    rec = {"run": name, "wall_s": time.perf_counter() - t0,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches, "function_calls": fn,
           "launch_shapes": sorted(keys)}
    if hist is not None:
        losses = [h["loss"] for h in hist]
        require(all(math.isfinite(x) for x in losses),
                f"{name}: losses {losses}")
        rec.update(steps=[h["step"] for h in hist], losses=losses,
                   ms_per_step=[h["dt"] * 1e3 for h in hist])
    return hist, rec


def train_phase(torch, np, card: str, checked: set) -> dict:
    """Training through the port's entry points, on the card:

    * the flash Function's gradients against plain autograd at every
      training shape (``_flash_function_checks``);
    * ``repro_torch.launch.train.main`` on gemma-2b at its published width
      and depth (18 layers, d_model 2048, vocab 256000), nothing cut,
      batch 2 x 256 tokens: 3 steps of ``adamw_q8`` killed at step 2 after
      a checkpoint there and resumed from ``--ckpt-dir`` (the checkpoint
      goes under ``build/`` and is removed), then 3 unbroken steps: the
      resumed step-3 loss within RESUME_RTOL of the unbroken run's; one
      step of plain ``adamw``; losses, ms per step and
      ``max_memory_allocated`` of each;
    * whisper-small at full width: one step of ``launch.train`` (which
      feeds zero encoder frames, as the reference's does: at full depth their
      gradient overflows f32 after the first step in both packages, the
      layer norms' 1/sqrt(eps) gain on a zero input compounding over 25
      norms), then 3 steps of ``TrainLoop`` on frames from a seed: the
      encoder's non-causal flash kernel under autograd;
    * ``examples/train_llm.py`` (granite-100m, batch 16 x 256 tokens) for
      TRAIN_LLM_STEPS steps: its first and last 5-step mean loss against
      ln(8192).

    Every flash launch goes through ``FlashAttentionFn`` at a shape in
    ``checked`` (``_train_run``).
    Returns the launches by run and the Function's timing row."""
    import shutil
    from repro_torch.examples import train_llm
    from repro_torch.launch import train

    out = {"phase": "train", "card": card,
           "flash_function": _flash_function_checks(torch)}
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    out["ckpt_disk_free_bytes"] = shutil.disk_usage(ckpt).free
    q8 = TRAIN_ARGS + ("--steps", "3", "--optimizer", "adamw_q8")
    resume = q8 + ("--ckpt-dir", str(ckpt), "--ckpt-every", "2")
    runs = []
    try:
        for name, args, killed in (
                ("gemma-2b adamw_q8 killed at step 2",
                 resume + ("--kill-at-step", "2"), True),
                ("gemma-2b adamw_q8 resumed", resume, False),
                ("gemma-2b adamw_q8 unbroken", q8, False),
                ("gemma-2b adamw", TRAIN_ARGS + ("--steps", "1"), False),
                ("whisper-small adamw, zero frames",
                 ("--arch", "whisper-small", "--batch", "2", "--seq", "256",
                  "--steps", "1"), False)):
            hist, rec = _train_run(torch, name,
                                   lambda args=args: train.main(list(args)),
                                   checked, killed=killed)
            runs.append(rec)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    _, rec = _train_run(torch, "whisper-small adamw, seeded frames",
                        lambda: _whisper_train(torch), checked)
    runs.append(rec)
    by = {r["run"]: r for r in runs}
    resumed = by["gemma-2b adamw_q8 resumed"]
    unbroken = by["gemma-2b adamw_q8 unbroken"]
    a, b = resumed["losses"][0], unbroken["losses"][2]
    require(resumed["steps"] == [3] and abs(a - b) <= RESUME_RTOL * abs(b),
            f"resumed step-3 loss {a} against the unbroken run's {b}")
    out["resume"] = {"resumed_step3_loss": a, "unbroken_step3_loss": b,
                     "rel_diff": abs(a - b) / abs(b),
                     "tol_rel": RESUME_RTOL}
    hist, rec = _train_run(torch, "train_llm granite-100m", lambda: (
        train_llm.main(["--steps", str(TRAIN_LLM_STEPS), "--batch",
                        str(TRAIN_LLM_BATCH), "--seq", str(TRAIN_LLM_SEQ)])),
        checked)
    first = float(np.mean(rec["losses"][:5]))
    last = float(np.mean(rec["losses"][-5:]))
    require(len(hist) == TRAIN_LLM_STEPS and last < first,
            f"train_llm: loss {first} -> {last}")
    rec.update(first5_mean_loss=first, last5_mean_loss=last,
               uniform_loss=math.log(8192),
               ms_per_step_median=float(np.median(rec["ms_per_step"])))
    del rec["losses"], rec["ms_per_step"], rec["steps"]
    runs.append(rec)
    out["runs"] = runs
    out["timing"] = _train_flash_timing(torch)
    emit(out)
    return {"launches": {r["run"]: r["launches"] for r in runs},
            "timing": out["timing"]}


def _whisper_train(torch, steps: int = 3) -> list:
    """``steps`` AdamW steps of whisper-small at full width through
    ``TrainLoop`` and ``encdec_loss``, batch 2 x 256 tokens of the Markov
    stream, on encoder frames (2, 1500, 768) drawn from a seed. Returns
    the history."""
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import encdec
    from repro_torch.runtime import Runtime
    from repro_torch.training import TrainConfig, TrainLoop, make_optimizer
    cfg = _whisper_config()
    rt = Runtime(q_chunk=256)
    frames = torch.randn((2, cfg.enc_seq_len, cfg.d_model), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(43))
    data = TokenStream(cfg.vocab_size, 2, 256, seed=0)
    try:
        loop = TrainLoop(
            lambda p, b: encdec.encdec_loss(p, dict(b, frames=frames), cfg,
                                            rt),
            make_optimizer("adamw", lr=3e-3),
            lambda: encdec.encdec_init(
                torch.Generator(device="cuda").manual_seed(0), cfg,
                device="cuda"),
            iter(data), TrainConfig(max_steps=steps, log_every=1))
        return loop.run()[1]
    finally:
        data.close()


def _train_flash_timing(torch) -> dict:
    """The flash kernel's forward inside ``FlashAttentionFn`` over one
    gemma-2b training step (18 launches, 8 query heads over 1 KV head of
    256, causal, 2 x 256 tokens, inputs that require grad), beside its
    plain version, SDPA, the bounds, and the backward's plain recompute
    (the gradients of all 18 layers)."""
    from repro_torch.kernels.flash_attention import flash_attention_autograd
    gen = torch.Generator(device="cuda").manual_seed(41)
    row = _flash_shape_timing(
        torch, gen, b=2, hq=8, hkv=1, sq=256, skv=256, dh=256, causal=True,
        layers=18, grad=True,
        per="gemma-2b training step: 18 forward launches under "
            "FlashAttentionFn, causal, 2 x 256 tokens, 8 query heads over "
            "1 KV head of 256")
    qkv = [tuple(torch.randn(shape, generator=gen, device="cuda")
                 .requires_grad_(True)
                 for shape in ((2, 8, 256, 256), (2, 1, 256, 256),
                               (2, 1, 256, 256))) for _ in range(18)]
    outs = [flash_attention_autograd(q, k, v, causal=True, q_chunk=256)
            for q, k, v in qkv]
    g = torch.ones_like(outs[0])

    def backward():
        for (q, k, v), o in zip(qkv, outs):
            torch.autograd.grad(o, (q, k, v), g, retain_graph=True)
    row["backward_plain_recompute_ms"] = _time_ms(torch, backward, reps=3)
    return row


def _flash_shape_timing(torch, gen, *, b, hq, hkv, sq, skv, dh, causal,
                        layers, per, grad=False, q_offset=0) -> dict:
    """Kernel 4 over ``layers`` launches of q (b, hq, sq, dh) against k/v
    (b, hkv, skv, dh) (``grad``: inside ``FlashAttentionFn``, the inputs
    requiring grad; ``q_offset``: query row i at position q_offset + i
    under the causal mask), beside its plain version, SDPA over K/V
    repeated to the query heads (with an explicit mask of the same rows
    at an offset; its device kernels a call and their names, as the
    profiler saw them), and the two bounds: q read once, the keys and values
    the causal rows reach (the first q_offset + sq) read once, out written
    once; 4 * dh flops per (query, key) pair attended."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_autograd,
                                                     flash_attention_cuda)
    qkv = [(torch.randn((b, hq, sq, dh), generator=gen, device="cuda"),
            torch.randn((b, hkv, skv, dh), generator=gen, device="cuda"),
            torch.randn((b, hkv, skv, dh), generator=gen, device="cuda"))
           for _ in range(layers)]
    if grad:
        qkv = [tuple(t.requires_grad_(True) for t in x) for x in qkv]
    expanded = [(q.detach(), k.detach().repeat_interleave(hq // hkv, 1),
                 v.detach().repeat_interleave(hq // hkv, 1))
                for q, k, v in qkv]

    def kernel():
        with torch.enable_grad():
            for q, k, v in qkv:
                if grad:
                    flash_attention_autograd(q, k, v, causal=causal,
                                             q_chunk=1024)
                else:
                    flash_attention_cuda(q, k, v, causal=causal,
                                         q_offset=q_offset)

    def plain():
        with torch.no_grad():
            for q, k, v in qkv:
                ref.flash_attention_ref(q, k, v, causal=causal, q_chunk=1024,
                                        q_offset=q_offset)

    mask = None
    if causal and q_offset:
        mask = (torch.arange(skv, device="cuda")[None, :]
                <= q_offset + torch.arange(sq, device="cuda")[:, None])

    def library():
        for q, k, v in expanded:
            if mask is None:
                F.scaled_dot_product_attention(q, k, v, is_causal=causal)
            else:
                F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    pairs = (sum(min(q_offset + i + 1, skv) for i in range(sq)) if causal
             else sq * skv)
    keys = min(skv, q_offset + sq) if causal else skv
    nbytes = layers * 4 * dh * (2 * b * hq * sq + 2 * b * hkv * keys)
    flops = layers * 4 * b * hq * dh * pairs
    bound, by = _bound_ms(nbytes, flops)
    device_ms = _device_ms(torch, kernel, ("flash_attention_kernel",))
    per_call, _ = _kernels_per_call(torch, kernel, layers)
    lib_per_call, lib_names = _kernels_per_call(torch, library, layers)
    return {"name": "flash_attention", "per": per,
            "kernels_per_call": per_call,
            "library_kernels_per_call": lib_per_call,
            "library_kernel_names": lib_names,
            "ms": _time_ms(torch, kernel), "device_ms": device_ms,
            "plain_ms": _time_ms(torch, plain, reps=3),
            "library_ms": _time_ms(torch, library),
            "library_device_ms": _device_ms(torch, library, ("",)),
            "library_call": (f"scaled_dot_product_attention(is_causal="
                             f"{causal})" if mask is None else
                             "scaled_dot_product_attention(attn_mask= the "
                             "offset causal mask)")
            + ", K/V pre-repeated over the query heads",
            "bound_ms": bound, "bound_by": by,
            "f32_bound_ms": _f32_bound_ms(nbytes, flops),
            "share_of_bound": bound / device_ms if device_ms else None}


# -- phase 5: the train step under a (data, model) mesh ------------------------

#: the train_mesh cells: (name, global batch, build_train_step's knobs).
#: fsdp: 8 rows, one per device, AdamW; tp: 4 rows (they do not cover 8
#: devices): tensor-parallel over model, FSDP over data, AdamW-Q8 and 2
#: microbatches of 2 rows (one per data group) passed explicitly
TRAIN_MESH_CELLS = (("fsdp", 8, {}),
                    ("tp", 4, {"optimizer": "adamw_q8", "accum_steps": 2}))
TRAIN_MESH_SEQ, TRAIN_MESH_STEPS = 256, 2
#: train_mesh's limits against one device, each leaf's relative difference
#: in norm: the AdamW update after the steps (fsdp; 1.7e-3 to 4.6e-3
#: measured on an H100: AdamW's first steps turn f32-level gradient
#: differences into steps of either sign), and AdamW-Q8's per-row scales
#: after the first step (tp): from zero moments they are max |(1 - b1) g|
#: and max (1 - b2) g^2 of each row, so they hold the gradients of every
#: block to one device's (a block's own max instead of its row's, where
#: fsdp cuts the last dim 8 ways, parts by tens of percent)
TRAIN_MESH_UPDATE_RTOL = 2e-2
TRAIN_MESH_SCALE_RTOL = 1e-2


def _train_mesh_flash_shapes() -> tuple:
    """(what, (B, Hq, Hkv, S, dh)) of every flash launch of train_mesh
    (gemma-2b, causal, S = TRAIN_MESH_SEQ): one fsdp device's row, one tp
    shard's row of its 2 query heads over the one KV head (a data group's
    share of a 2-row microbatch), and the one-device steps beside them
    (8 rows; 2 rows per microbatch)."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma-2b")
    h, kv, s, dh = cfg.n_heads, cfg.n_kv_heads, TRAIN_MESH_SEQ, cfg.dh
    return (("fsdp device", (1, h, kv, s, dh)),
            ("fsdp one device", (8, h, kv, s, dh)),
            ("tp shard", (1, h // MESH[1], kv, s, dh)),
            ("tp one device", (2, h, kv, s, dh)))


def train_mesh_kernel_phase(torch, np) -> tuple[dict, set]:
    """Kernel 4's forward at every shape of ``_train_mesh_flash_shapes``
    against its plain version, twice (bit-identical), before train_mesh
    launches it there. Returns the worst errors and the checked keys."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device="cuda").manual_seed(53)
    checked: set = set()
    worst: dict = {}
    for what, (b, hq, hkv, s, dh) in _train_mesh_flash_shapes():
        q, k, v = _train_flash_inputs(torch, gen, b, hq, hkv, s, s, dh)
        _, rec = _check_launch(torch, "flash_attention", flash_attention_cuda,
                               _flash_plain, (q, k, v), {"causal": True},
                               checked, worst)
        emit({"phase": "kernel", "kernel": "flash_attention",
              "for": "train_mesh", "what": what, "B": b, "Hq": hq,
              "Hkv": hkv, "Sq": s, "Skv": s, "dh": dh, "causal": True,
              **rec})
    return worst, checked


def _tree_bytes(tree) -> int:
    """The bytes of a tree's tensors (a QuantizedTensor's codes and
    scale)."""
    from repro_torch.nn.layers import tree_leaves
    leaves = []
    for t in tree_leaves(tree):
        leaves += [t.codes, t.scale] if hasattr(t, "codes") else [t]
    return sum(t.numel() * t.element_size() for t in leaves
               if hasattr(t, "numel"))


def _train_mesh_batches(torch, vocab: int, b: int) -> list:
    gen = torch.Generator().manual_seed(61 + b)
    return [{k: torch.randint(0, vocab, (b, TRAIN_MESH_SEQ), generator=gen,
                              dtype=torch.int32) for k in ("tokens", "labels")}
            for _ in range(TRAIN_MESH_STEPS)]


def _counted_step(torch, name, run, checked) -> tuple:
    """One train step (``run()``) with the counts set to 0 just before
    and read just after: (its output, host ms, flash launches by shape,
    the collective counters by device); every launch through
    ``FlashAttentionFn`` (the period checkpoints recompute each forward
    once in the backward: as many Function forwards as launches, half as
    many backwards), at a shape a kernel phase checked, no plain version
    run."""
    from repro_torch import collectives
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import FUNCTION_CALLS
    rec = _ShapeRecorder(torch, ("flash_attention",))
    with rec:
        torch.cuda.synchronize()
        ops.reset_op_calls()
        FUNCTION_CALLS.clear()
        collectives.reset_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches, plain, fn = (ops.op_calls(), ops.ref_calls(),
                               dict(FUNCTION_CALLS))
        counts = collectives.counts()
    n = launches.get("flash_attention", 0)
    require(n > 0 and launches == {"flash_attention": n} and not plain
            and fn.get("forward") == n and 2 * fn.get("backward", 0) == n,
            f"{name}: launches {launches}, Function calls {fn}, plain "
            f"{plain}")
    unchecked = sorted(rec.keys - checked)
    require(not unchecked, f"{name}: flash launches at shapes the kernel "
                           f"phases never held to the plain version: "
                           f"{unchecked}")
    return out, ms, [[*k, c] for k, c in sorted(rec.counts.items())], counts


def train_mesh_phase(torch, np, card: str, checked: set) -> dict:
    """gemma-2b's train step at its published width and depth (18 layers,
    d_model 2048, vocab 256000; 2.51B params, so ``make_policy`` turns
    FSDP on) under a (data 2, model 4) mesh on the one card
    (``launch.steps.build_train_step``; ``REPRO_FORCE_DEVICE_COUNT`` = 8:
    eight devices run one after another, so this tests correctness and
    host cost, not speed), f32 weights from a seed, remat ``full``, in the
    TRAIN_MESH_CELLS, each beside the port's one-device step
    (``make_grad_accum_step`` over ``lm_loss``) from the same weights on
    the same batches, which runs first and is moved to the host and freed:
    TRAIN_MESH_STEPS steps; each step's loss within E2E_RTOL of the
    one-device step's; per leaf the relative difference of the update
    (the params after the steps less the initial ones), within
    TRAIN_MESH_UPDATE_RTOL under AdamW; AdamW-Q8's per-row scales and
    codes on every device against one device's after the first step (the
    scales within TRAIN_MESH_SCALE_RTOL) and after the last; host ms per
    step; max_memory_allocated; per-device bytes of params and optimizer
    state against one device's; flash launches per step by shape, each
    checked (``_counted_step``); the host's peak resident bytes. The host
    holds only one device's update (the weights are remade from their
    seed on the card where they are needed again)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.hostdev import device_list
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.lm import lm_loss
    from repro_torch.nn.layers import tree_at, tree_map
    from repro_torch.runtime import Runtime
    from repro_torch.training import make_grad_accum_step, make_optimizer

    cfg = get_config("gemma-2b")
    mesh = make_host_mesh(*MESH, device_list())
    out = {"launches": {}, "cells": {}}
    for cell, b, knobs in TRAIN_MESH_CELLS:
        t_cell = time.perf_counter()
        bundle = build_train_step(
            cfg, ShapeConfig("train_mesh", TRAIN_MESH_SEQ, b, "train"), mesh,
            dtype=torch.float32, **knobs)
        require(bundle.meta["parallelism"] == cell,
                f"train_mesh {cell}: meta {bundle.meta}")
        batches = _train_mesh_batches(torch, cfg.vocab_size, b)
        opt = make_optimizer(bundle.meta["optimizer"], lr=1e-4,
                             weight_decay=0.01)

        # the one-device step first; its update moves to the host
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        params = _train_mesh_params(torch, cfg)
        state = opt.init(params)
        one_bytes = _tree_bytes(params) + _tree_bytes(state)
        step = make_grad_accum_step(
            lambda p, bt, rt: lm_loss(p, bt, cfg, rt), opt,
            accum_steps=bundle.meta["accum_steps"], rt=Runtime())
        one, q8_first = [], None
        for bt in batches:
            params, state, _, m, ms = _timed(torch, lambda bt=bt: step(
                params, state, None, {k: v.cuda() for k, v in bt.items()}))
            one.append({"loss": float(m["loss"]), "host_ms": ms,
                        "gnorm": float(m["gnorm"])})
            if q8_first is None and bundle.meta["optimizer"] == "adamw_q8":
                q8_first = {(name,) + path: x.cpu()
                            for name in ("mu", "nu")
                            for path, x in _paths(state[name])}
        one_mem = torch.cuda.max_memory_allocated()
        init = _train_mesh_params(torch, cfg)
        delta_one = tree_map(lambda path, x: (x - tree_at(init, path)).cpu(),
                             params)
        scales_one = None
        if bundle.meta["optimizer"] == "adamw_q8":
            scales_one = {(name,) + path: q.cpu() for name in ("mu", "nu")
                          for path, q in _paths(state[name])
                          if path[-1] == "scale"}
        del params, state, step
        _free(torch)

        # the mesh step from the same weights
        grid, ostate = bundle.place(init)
        del init
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        per_device = [[_tree_bytes(p) + _tree_bytes(o)
                       for p, o in zip(prow, orow)]
                      for prow, orow in zip(grid, ostate)]
        steps = []
        for i, bt in enumerate(batches):
            (grid, ostate, m), ms, shapes, counts = _counted_step(
                torch, f"train_mesh {cell} step {i + 1}",
                lambda bt=bt: bundle.fn(grid, ostate, bt), checked)
            loss, want = float(m["loss"]), one[i]["loss"]
            require(math.isfinite(loss)
                    and abs(loss - want) <= E2E_RTOL * abs(want),
                    f"train_mesh {cell} step {i + 1}: loss {loss} against "
                    f"one device's {want}")
            steps.append({"loss": loss, "one_device_loss": want,
                          "rel_diff": abs(loss - want) / abs(want),
                          "host_ms": ms,
                          "one_device_host_ms": one[i]["host_ms"],
                          "gnorm": float(m["gnorm"]),
                          "one_device_gnorm": one[i]["gnorm"],
                          "flash_launches_by_shape": shapes,
                          "collectives": counts})
            if i == 0 and q8_first is not None:
                q8 = _q8_against(ostate, q8_first, bundle.specs["opt"],
                                 mesh.shape)
                del q8_first
                steps[0]["q8"] = q8
                require(q8["scale_rel_diff_max"] <= TRAIN_MESH_SCALE_RTOL,
                        f"train_mesh {cell} step 1: AdamW-Q8 scales "
                        f"{q8['scale_rel_diff_max']} from one device's "
                        f"(limit {TRAIN_MESH_SCALE_RTOL})")
        mesh_mem = torch.cuda.max_memory_allocated()
        whole, init = bundle.gather(grid, device="cuda"), \
            _train_mesh_params(torch, cfg)
        update = {}
        for path, got in _paths(whole):
            d_one = tree_at(delta_one, path).cuda()
            d_mesh = got - tree_at(init, path)
            update["/".join(map(str, path))] = float(
                (d_mesh - d_one).norm() / max(float(d_one.norm()), 1e-30))
        del whole, init
        if bundle.meta["optimizer"] == "adamw":
            require(max(update.values()) <= TRAIN_MESH_UPDATE_RTOL,
                    f"train_mesh {cell}: update {max(update.values())} "
                    f"from one device's (limit {TRAIN_MESH_UPDATE_RTOL})")
        rec = {"phase": "train_mesh", "cell": cell, "card": card,
               "arch": cfg.name, "mesh": list(MESH), "batch": b,
               "seq": TRAIN_MESH_SEQ, "meta": bundle.meta, "steps": steps,
               "update_rel_diff_by_leaf": update,
               "update_rel_diff_max": max(update.values()),
               "max_memory_allocated": mesh_mem,
               "one_device_max_memory_allocated": one_mem,
               "per_device_state_bytes": per_device,
               "one_device_state_bytes": one_bytes,
               "knobs": {k: v for k, v in knobs.items()},
               "per_device_share": max(max(r) for r in per_device)
               / one_bytes,
               "host_max_rss_bytes": resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss * 1024,
               "tol_loss_rel": E2E_RTOL,
               "tol_update_rel": TRAIN_MESH_UPDATE_RTOL,
               "tol_q8_scale_rel_step_1": TRAIN_MESH_SCALE_RTOL}
        if scales_one is not None:
            rec["q8_after_steps"] = _q8_against(ostate, scales_one,
                                                bundle.specs["opt"],
                                                mesh.shape)
        rec["seconds"] = time.perf_counter() - t_cell
        emit(rec)
        out["cells"][cell] = rec
        out["launches"][f"train_mesh {cell}"] = {
            "flash_attention": sum(c[-1] for s in steps
                                   for c in s["flash_launches_by_shape"])}
        del grid, ostate, delta_one
        _free(torch)
    out["timing"] = _train_mesh_flash_timing(torch)
    return out


def _q8_against(ostate, one: dict, layouts: dict, sizes: dict) -> dict:
    """AdamW-Q8's moments on every device (``ostate``: ``grid[d][m]``)
    against one device's (``one``: {("mu" | "nu", *path, "codes" |
    "scale"): the whole tensor on the host}), each distinct block once
    (by ``layouts``, the train step's own): per leaf the scales' relative
    difference in norm, their largest elementwise relative difference,
    and the share of the codes held in ``one`` that differ."""
    seen, sums, worst, flips, total = set(), {}, 0.0, 0, 0
    for d, row in enumerate(ostate):
        for m, o in enumerate(row):
            for name in ("mu", "nu"):
                for path, blk in _paths(o[name]):
                    key = (name,) + path
                    if key not in one:
                        continue
                    lay = layouts[key]
                    if (key, lay.block_key(d, m, sizes)) in seen:
                        continue
                    seen.add((key, lay.block_key(d, m, sizes)))
                    want = one[key][lay.index(d, m, sizes)].to(blk.device)
                    if path[-1] == "codes":
                        flips += int((blk != want).sum())
                        total += blk.numel()
                        continue
                    a, b = sums.get(key[:-1], (0.0, 0.0))
                    sums[key[:-1]] = (a + float(((blk - want) ** 2).sum()),
                                      b + float((want ** 2).sum()))
                    worst = max(worst, float(
                        ((blk - want).abs()
                         / want.abs().clamp(min=1e-30)).max()))
    by_leaf = {"/".join(map(str, k)): (a / max(b, 1e-60)) ** 0.5
               for k, (a, b) in sums.items()}
    out = {"scale_rel_diff_max": max(by_leaf.values()),
           "scale_elem_rel_diff_max": worst,
           "scale_rel_diff_by_leaf": by_leaf}
    if total:
        out["codes_differing_share"] = flips / total
    return out


def _train_mesh_params(torch, cfg):
    """train_mesh's initial weights, f32 on the card, from their seed."""
    from repro_torch.models.lm import lm_init
    return lm_init(torch.Generator(device="cuda").manual_seed(71), cfg,
                   device="cuda")


def _timed(torch, run):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    return (*res, (time.perf_counter() - t0) * 1e3)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


def _train_mesh_flash_timing(torch) -> dict:
    """The flash kernel at train_mesh's mesh shapes, 18 launches each
    (one device's forward over gemma-2b's layers) inside
    ``FlashAttentionFn``, beside its plain version, SDPA and the bounds."""
    gen = torch.Generator(device="cuda").manual_seed(67)
    out = {}
    for what, (b, hq, hkv, s, dh) in _train_mesh_flash_shapes():
        if "one device" in what:
            continue
        out[what] = _flash_shape_timing(
            torch, gen, b=b, hq=hq, hkv=hkv, sq=s, skv=s, dh=dh, causal=True,
            layers=18, grad=True,
            per=f"train_mesh {what}: 18 forward launches under "
                f"FlashAttentionFn, causal, {b} x {s} tokens, {hq} query "
                f"heads over {hkv} KV head of {dh}")
    return out


# -- phase 5: tensor-parallel serving, the replica router, the CLI ------------

#: the ops a sharded engine launches: kernels 1, 2, 3, 5 and 6
SHARDED_OPS = ("spx_matmul", "paged_decode_ragged", "paged_attention",
               "paged_decode_ragged_quant", "paged_attention_quant")
#: the tensor-parallel width of the sharded runs, on the one card
#: (REPRO_FORCE_DEVICE_COUNT lists it twice)
SHARDS = 2
#: the rows spx_matmul takes in the sharded runs: 4 slots x each padded
#: prefill chunk, a decode tick (W = 1) and a spec_k = 4 window (W = 5)
SHARD_MS = (4, 8, 16, 20, 32, 64, 128)


def _sharded_configs() -> dict:
    from repro_torch.configs import get_config
    return {name: get_config(name) for name in ("gemma-2b", "qwen2-vl-2b")}


#: the families of serve_families that also serve at shards=SHARDS there
#: (qwen2-vl-2b's pair runs in serve_sharded; jamba's in serve_jamba, at
#: its full width)
SHARDED_FAMILIES = ("olmoe-1b-7b", "xlstm-350m")


def _jamba_full_config() -> tuple:
    """jamba-1.5-large at one period (8 of its 72 layers) and its published
    width, and the cut from the published config: the period holds 4 MoE
    layers of 16 experts of 8192 x 24576 (38.6 GB each in f32, 4.8 GB in
    sp2_4 codes), and the whole is 26 GB in sp2_4."""
    from repro_torch.configs import get_config
    cfg = get_config("jamba-1.5-large-398b")
    return (dataclasses.replace(cfg, n_layers=len(cfg.pattern)),
            {"n_layers": f"{cfg.n_layers} -> {len(cfg.pattern)}"})


@contextlib.contextmanager
def _forced_shards(n: int = SHARDS):
    """``REPRO_FORCE_DEVICE_COUNT=n`` for the block (``launch.hostdev``
    lists the one card that many times); the earlier value restored."""
    saved = os.environ.get("REPRO_FORCE_DEVICE_COUNT")
    os.environ["REPRO_FORCE_DEVICE_COUNT"] = str(n)
    try:
        yield
    finally:
        if saved is None:
            del os.environ["REPRO_FORCE_DEVICE_COUNT"]
        else:
            os.environ["REPRO_FORCE_DEVICE_COUNT"] = saved


def _shard_projection_shapes(torch, cfg, shards: int = SHARDS) -> list:
    """(K, N) of one shard's ``spx_matmul`` projections at ``shards``:
    every leaf ``quantize_params`` quantizes that ``dense_apply``
    multiplies (a projection's ``w``; the MoE's expert stacks are
    dequantized instead, and the table and head stay plain products), cut
    as ``ShardingPolicy.serving_cut`` cuts it, every shard's slice (head
    groups, FFN columns and ``wo``/``down`` rows, uneven where a count
    does not divide), a recurrent mixer's projections whole. Built on the
    meta device: nothing is allocated."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.encdec import encdec_init
    from repro_torch.models.lm import lm_init
    from repro_torch.nn.layers import _NO_QUANT_KEYS, tree_map
    from repro_torch.sharding import ShardingPolicy

    init = encdec_init if cfg.enc_dec else lm_init
    tree = init(torch.Generator(), cfg, device="meta")
    policy = ShardingPolicy(cfg, make_serving_mesh(shards,
                                                   ["meta"] * shards))
    shapes = set()

    def visit(path, leaf):
        keys = [str(k) for k in path]
        if (keys[-1] == "w" and leaf.ndim >= 2 and leaf.numel() >= 4096
                and leaf.shape[-1] % 2 == 0
                and not set(path) & set(_NO_QUANT_KEYS)):
            cut = policy.serving_cut(keys, tuple(leaf.shape))
            for _, size in (cut[1] if cut else ((0, None),)):
                shape = list(leaf.shape)
                if cut:
                    shape[cut[0]] = size
                shapes.add(tuple(shape[-2:]))
        return leaf
    tree_map(visit, tree)
    return sorted(shapes)


def _shard_heads(cfg, shards: int = SHARDS) -> dict:
    """One shard's heads as ``sharding.shard_params`` cuts them: the query
    heads split evenly, the KV heads split where ``kv_heads_split`` says
    they do (qwen2-vl-2b's 2), else every shard holds them whole
    (gemma-2b's 1)."""
    from repro_torch.runtime.planner import kv_heads_split
    sharded = kv_heads_split(cfg.n_kv_heads, shards)
    hkv = cfg.n_kv_heads // shards if sharded else cfg.n_kv_heads
    hq = cfg.n_heads // shards
    return {"hq": hq, "hkv": hkv, "rep": max(hq // hkv, 1),
            "kv_sharded": sharded}


def _shard_kernel_heads(cfg, shards: int) -> list:
    """The (KV heads, query heads per KV head) the attention kernels see
    on each shard (``nn.attention.head_segments``: a shard's pieces over
    its cut of the pools, or over a view of the replicated pools), in
    shard order."""
    from repro_torch.nn.attention import head_segments
    return [sorted({(g, qn // g) for _, qn, _, g in head_segments(
        cfg.n_heads, cfg.n_kv_heads, shards, s)}) for s in range(shards)]


def _shard_spx_shapes(cfg) -> list:
    """(K, N) of one shard's projections: wq, wk/wv, wo, gate/up, down."""
    h = _shard_heads(cfg)
    d, dh, ff = cfg.d_model, cfg.dh, cfg.d_ff // SHARDS
    return sorted({(d, h["hq"] * dh), (d, h["hkv"] * dh), (h["hq"] * dh, d),
                   (d, ff), (ff, d)})


def _check_spx_shapes(torch, gen, tag: dict, shapes, ms, checked,
                      worst) -> None:
    """spx_matmul (sp2_4, packed) at every (K, N) of ``shapes`` and every
    M of ``ms`` against its plain version, twice (``_check_launch``); one
    line per (K, N), labelled with ``tag``."""
    from repro_torch.core import spx
    from repro_torch.kernels import ref
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda

    lut = spx.codebook(spx.scheme_levels("sp2_4"), device="cuda")
    for k, n in shapes:
        codes = torch.randint(0, 256, (k, n // 2), generator=gen,
                              device="cuda", dtype=torch.int32) \
            .to(torch.uint8)
        scale = torch.rand((1, n), generator=gen, device="cuda") * 0.05
        errs = {}
        for m in ms:
            x = torch.randn((m, k), generator=gen, device="cuda")
            _, rec = _check_launch(torch, "spx_matmul", spx_matmul_cuda,
                                   ref.spx_matmul_ref, (x, codes, scale, lut),
                                   {"packed": True}, checked, worst,
                                   SPX_RTOL)
            errs[m] = rec["max_rel_err"]
        emit({"phase": "kernel", "kernel": "spx_matmul", **tag, "K": k,
              "N": n, "max_rel_err_by_M": errs, "tol_rel": SPX_RTOL,
              "bit_identical_rerun": True, "ok": True})


def _check_paged_shapes(torch, gen, tag: dict, *, hkv, rep, dh, max_seqs,
                        ws, pages_kinds, checked, worst) -> None:
    """The paged kernels at one engine's heads (B = 4 slots, ``hkv`` KV
    heads of ``dh``, ``rep`` query heads each) on ``plan_kv_pages``'s page
    size, a block table as wide as each of ``max_seqs`` needs: kernel 2
    (f32 pages) or 3 (code pages) at every window ``w`` of ``ws``, and
    kernel 5 or 6 for one-token chunks, each against its plain version,
    twice; the ctx_len 0 row must come back exactly zero."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (
        paged_attention_cuda, paged_attention_quant_cuda,
        paged_decode_ragged_cuda, paged_decode_ragged_quant_cuda)
    from repro_torch.nn.attention import kv_lut, quantize_kv
    from repro_torch.runtime import planner

    b = 4
    kv_lut_ = kv_lut(KV_SCHEME, "cuda")
    for pages in pages_kinds:
        ps = planner.plan_kv_pages(
            dh, kv_scheme=KV_SCHEME if pages == "codes" else None).page_size
        for max_seq in max_seqs:
            mp = -(-max_seq // ps)
            n_pages = 1 + b * mp
            kp, vp = _rand_pools(torch, gen, n_pages, hkv, ps, dh)
            if pages == "codes":
                pools = (*quantize_kv(kp, KV_SCHEME),
                         *quantize_kv(vp, KV_SCHEME))
                cases = (("paged_decode_ragged_quant",
                          paged_decode_ragged_quant_cuda,
                          ref.paged_decode_ragged_quant_ref),
                         ("paged_attention_quant", paged_attention_quant_cuda,
                          ref.paged_attention_quant_ref))
                tail = (kv_lut_,)
            else:
                pools = (kp, vp)
                cases = (("paged_decode_ragged", paged_decode_ragged_cuda,
                          ref.paged_decode_ragged_ref),
                         ("paged_attention", paged_attention_cuda,
                          ref.paged_attention_ref))
                tail = ()
            bt = torch.randperm(n_pages - 1, generator=gen, device="cuda")[
                :b * mp].reshape(b, mp).to(torch.int32) + 1
            ctx = torch.tensor([ps - 1, ps, ps + 1, 3 * ps + 7],
                               dtype=torch.int32, device="cuda")
            ctx1 = torch.tensor([0, 1, ps, 2 * ps + 3], dtype=torch.int32,
                                device="cuda")
            errs = {}
            for w in ws:
                q = torch.randn((b, hkv, rep * w, dh), generator=gen,
                                device="cuda")
                qn = torch.tensor([0, 1, min(3, w), w], dtype=torch.int32,
                                  device="cuda")
                op, launch, plain = cases[0]
                _, rec = _check_launch(torch, op, launch, plain,
                                       (q, *pools, bt, ctx, qn, *tail),
                                       {"w": w}, checked, worst)
                errs[f"{op} w={w}"] = rec["max_abs_err"]
            q = torch.randn((b, hkv, rep, dh), generator=gen, device="cuda")
            op, launch, plain = cases[1]
            got, rec = _check_launch(torch, op, launch, plain,
                                     (q, *pools, bt, ctx1, *tail), {},
                                     checked, worst)
            errs[op] = rec["max_abs_err"]
            zeros = bool((got[0] == 0).all())
            emit({"phase": "kernel", **tag, "pages": pages, "hkv": hkv,
                  "rep": rep, "dh": dh, "page_size": ps, "max_seq": max_seq,
                  "max_pages": mp, "max_abs_err": errs,
                  "tol": f"{ATTN_TOL} * (1 + |plain|)",
                  "bit_identical_rerun": True,
                  "empty_row_exact_zero": zeros, "ok": zeros})
            require(zeros, f"{op} {tag}: the ctx_len 0 row is not zero")


def sharded_kernel_phase(torch, np) -> tuple[dict, set]:
    """Every launch shape of the shards=2 serve runs, held against its
    plain version before any of them launches it, twice (the second
    launch bit-identical): spx_matmul (sp2_4, packed) at one shard's
    (K, N) of gemma-2b and qwen2-vl-2b, column cuts of wq/wk/wv/gate/up and
    row cuts of wo/down, at every M of SHARD_MS; kernels 2 and 5 over f32
    pages and kernels 3 and 6 over code pages at one shard's heads
    (gemma-2b: 4 query heads over its one KV head of 256, which every
    shard holds; qwen2-vl-2b: 6 over one of its two KV heads of 128), w = 1
    and 5, on plan_kv_pages's page sizes and ServeConfig()'s max_seq 256.
    Then the families served at shards=2 (SHARDED_FAMILIES, at
    serve_families' configurations, whisper-small, and jamba at one period
    and full width, whose shards=1 run's shapes are new too): spx_matmul
    at every (K, N) of one shard's projections
    (``_shard_projection_shapes``: olmoe's attention, xlstm's and jamba's
    projections, the recurrent ones whole, whisper's encoder and decoder)
    at every M of SHARD_MS, and whisper's also at its encoder's M = 1500;
    kernels 2 and 5 (f32 pages, w = 1) at one shard's heads (olmoe 8 over
    8 of 128, jamba 32 over 4 of 128 and at shards=1 64 over 8, whisper 6
    over 6 of 64); flash attention at whisper's 6 heads per shard: the
    encoder (1500 frames, not causal) and the cross-attention of every
    paged chunk over 1500 frames. Returns the worst errors and the checked
    launch keys."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    gen = torch.Generator(device="cuda").manual_seed(19)
    checked: set = set()
    worst = {op: 0.0 for op in SHARDED_OPS}
    for name, cfg in _sharded_configs().items():
        tag = {"for": "serve_sharded", "arch": name, "shards": SHARDS}
        _check_spx_shapes(torch, gen, tag, _shard_spx_shapes(cfg), SHARD_MS,
                          checked, worst)
        h = _shard_heads(cfg)
        _check_paged_shapes(torch, gen, tag, hkv=h["hkv"], rep=h["rep"],
                            dh=cfg.dh, max_seqs=(256,), ws=(1, 5),
                            pages_kinds=("f32", "codes"), checked=checked,
                            worst=worst)
    families = {name: (cfg, (SHARDS,))
                for name, (cfg, _) in _family_configs().items()
                if name in SHARDED_FAMILIES}
    families["whisper-small"] = (_whisper_config(), (SHARDS,))
    jamba, _ = _jamba_full_config()
    families["jamba-1.5-large-398b"] = (jamba, (1, SHARDS))
    for name, (cfg, widths) in families.items():
        for n in widths:
            tag = {"for": "serve_sharded", "arch": name, "shards": n}
            ms = SHARD_MS + ((cfg.enc_seq_len,) if cfg.enc_dec else ())
            _check_spx_shapes(torch, gen, tag,
                              _shard_projection_shapes(torch, cfg, n), ms,
                              checked, worst)
            if any(s.split("+")[0] in ("attn", "xdec")
                   for s in cfg.pattern):
                h = _shard_heads(cfg, n)
                _check_paged_shapes(torch, gen, tag, hkv=h["hkv"],
                                    rep=h["rep"], dh=cfg.dh, max_seqs=(256,),
                                    ws=(1,), pages_kinds=("f32",),
                                    checked=checked, worst=worst)
    cfg = families["whisper-small"][0]
    h, dh, enc = _shard_heads(cfg), cfg.dh, cfg.enc_seq_len
    errs = {}
    for b, sq in [(1, enc)] + [(4, c) for c in WHISPER_CHUNKS]:
        q = torch.randn((b, h["hq"], sq, dh), generator=gen, device="cuda")
        kv = tuple(torch.randn((b, h["hkv"], enc, dh), generator=gen,
                               device="cuda") for _ in range(2))
        _, rec = _check_launch(torch, "flash_attention", flash_attention_cuda,
                               _flash_plain, (q, *kv), {"causal": False},
                               checked, worst)
        errs[f"{b}x{sq}"] = rec["max_abs_err"]
    emit({"phase": "kernel", "kernel": "flash_attention",
          "for": "serve_sharded", "arch": cfg.name, "shards": SHARDS,
          "hq": h["hq"], "hkv": h["hkv"], "dh": dh, "skv": enc,
          "causal": False, "max_abs_err_by_rows": errs,
          "tol": f"{ATTN_TOL} * (1 + |plain|)", "bit_identical_rerun": True,
          "ok": True})
    ops.reset_op_calls()
    return worst, checked


#: the rows spx_matmul takes in the router and CLI runs: 4 slots x each
#: padded prefill chunk (1 to 32 tokens) and the decode tick
TIER_MS = (4, 8, 16, 32, 64, 128)
#: the serving CLI's default max_seq (the router runs ServeConfig()'s 256)
CLI_MAX_SEQ = 128


def tier_kernel_phase(torch, np) -> tuple[dict, set]:
    """Every launch shape of the router and serve_cli runs (full-width
    gemma-2b, one shard, f32 pages), held against its plain version before
    those runs launch it, twice: spx_matmul at gemma-2b's (K, N) of
    wq/wo, wk/wv, gate/up and down at every M of TIER_MS, kernel 2
    (w = 1) and kernel 5 at its 8 query heads over one KV head of 256,
    with the block tables of max_seq 256 (the router) and CLI_MAX_SEQ (the
    CLI). Returns the worst errors and the checked launch keys."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    cfg = get_config("gemma-2b")
    gen = torch.Generator(device="cuda").manual_seed(23)
    checked: set = set()
    worst = {op: 0.0 for op in SHARDED_OPS}
    tag = {"for": "router, serve_cli", "arch": cfg.name}
    d, dh, ff = cfg.d_model, cfg.dh, cfg.d_ff
    _check_spx_shapes(torch, gen, tag, sorted({
        (d, cfg.n_heads * dh), (d, cfg.n_kv_heads * dh),
        (cfg.n_heads * dh, d), (d, ff), (ff, d)}), TIER_MS, checked, worst)
    _check_paged_shapes(torch, gen, tag, hkv=cfg.n_kv_heads,
                        rep=cfg.n_heads // cfg.n_kv_heads, dh=dh,
                        max_seqs=(256, CLI_MAX_SEQ), ws=(1,),
                        pages_kinds=("f32",), checked=checked, worst=worst)
    ops.reset_op_calls()
    return worst, checked


#: the widths the port refused before it cut heads unevenly: arch ->
#: shards (REPRO_FORCE_DEVICE_COUNT lists the one card that many times)
WIDE = {"qwen2-vl-2b": 4, "whisper-small": 8}


def wide_kernel_phase(torch, np) -> tuple[dict, set]:
    """Every launch shape of the wide runs (WIDE: qwen2-vl-2b at 4
    shards, 3 query heads each over one of its 2 KV heads, read as a view
    of the replicated pools; whisper-small at 8, head groups of 2, 2, 2,
    2, 1, 1, 1, 1 over its 12 replicated KV heads), held against its plain
    version before they launch, twice: spx_matmul at every shard's
    (K, N) (``_shard_projection_shapes``: the uneven head groups' columns
    and rows) at every M of SHARD_MS, whisper's also at its encoder's M =
    1500; kernels 2 and 5 over f32 pages at every shard's (KV heads, query
    heads per KV head) (``_shard_kernel_heads``), w = 1; and whisper's
    flash launches at every shard's heads: the encoder (1500 frames) and
    the cross-attention of every paged chunk. Returns the worst errors
    and the checked launch keys."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    gen = torch.Generator(device="cuda").manual_seed(29)
    checked: set = set()
    worst = {op: 0.0 for op in SHARDED_OPS}
    for name, n in WIDE.items():
        cfg = _whisper_config() if name == "whisper-small" \
            else get_config(name)
        tag = {"for": "serve_wide", "arch": name, "shards": n}
        ms = SHARD_MS + ((cfg.enc_seq_len,) if cfg.enc_dec else ())
        _check_spx_shapes(torch, gen, tag,
                          _shard_projection_shapes(torch, cfg, n), ms,
                          checked, worst)
        heads = sorted({h for per in _shard_kernel_heads(cfg, n)
                        for h in per})
        for hkv, rep in heads:
            _check_paged_shapes(torch, gen, tag, hkv=hkv, rep=rep,
                                dh=cfg.dh, max_seqs=(256,), ws=(1,),
                                pages_kinds=("f32",), checked=checked,
                                worst=worst)
        if not cfg.enc_dec:
            continue
        dh, enc = cfg.dh, cfg.enc_seq_len
        for hkv, rep in heads:
            errs = {}
            for b, sq in [(1, enc)] + [(4, c) for c in WHISPER_CHUNKS]:
                q = torch.randn((b, hkv * rep, sq, dh), generator=gen,
                                device="cuda")
                kv = tuple(torch.randn((b, hkv, enc, dh), generator=gen,
                                       device="cuda") for _ in range(2))
                _, rec = _check_launch(torch, "flash_attention",
                                       flash_attention_cuda, _flash_plain,
                                       (q, *kv), {"causal": False}, checked,
                                       worst)
                errs[f"{b}x{sq}"] = rec["max_abs_err"]
            emit({"phase": "kernel", "kernel": "flash_attention", **tag,
                  "hq": hkv * rep, "hkv": hkv, "dh": dh, "skv": enc,
                  "causal": False, "max_abs_err_by_rows": errs,
                  "tol": f"{ATTN_TOL} * (1 + |plain|)",
                  "bit_identical_rerun": True, "ok": True})
    ops.reset_op_calls()
    return worst, checked


#: the serve steps' mesh on the one card (REPRO_FORCE_DEVICE_COUNT = 8):
#: (data, model), and their batch and cache length (the reference's
#: prefill default turns context parallelism on at multiples of 16)
MESH = (2, 4)
MESH_BATCH, MESH_SEQ = 16, 512
#: decode: MESH_DECODE_STEPS tokens after a MESH_PROMPT-token prefill fill
#: the cache's last sequence block
MESH_DECODE_STEPS = 16
MESH_PROMPT = MESH_SEQ - MESH_DECODE_STEPS


def _cp_offsets() -> tuple:
    """The causal offsets of the context-parallel shards' rows."""
    rows = MESH_SEQ // MESH[1]
    return tuple(m * rows for m in range(MESH[1]))


def mesh_kernel_phase(torch, np) -> tuple[dict, set]:
    """Every launch shape of serve_mesh (full-width gemma-2b's serve steps
    at mesh (2, 4), batch 16, a 512-token cache, and the one-device steps
    beside them) held against its plain version first, twice: spx_matmul
    at one model shard's tensor-parallel cut at M = 8 (a data group's
    decode rows) and 4096 (its prefill rows), and at the whole weights at
    M = 1024 (a context-parallel shard's rows), 16, 7936 and 8192 (the
    one-device steps); flash attention causal at a tensor-parallel shard's
    2 query heads over 512 tokens, at the context-parallel shards' 128
    rows of 8 query heads over the 512 gathered keys with the causal
    offset of each shard (0, 128, 256, 384), and at the one-device
    prefills (496 and 512 tokens). Returns the worst errors and the
    checked launch keys."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    cfg = get_config("gemma-2b")
    gen = torch.Generator(device="cuda").manual_seed(41)
    checked: set = set()
    worst = {op: 0.0 for op in SHARDED_OPS}
    rows = MESH_BATCH // MESH[0]
    tag = {"for": "serve_mesh", "arch": cfg.name, "mesh": list(MESH)}
    _check_spx_shapes(torch, gen, dict(tag, weights="tensor-parallel cut"),
                      _shard_projection_shapes(torch, cfg, MESH[1]),
                      (rows, rows * MESH_SEQ), checked, worst)
    _check_spx_shapes(torch, gen, dict(tag, weights="whole"),
                      _shard_projection_shapes(torch, cfg, 1),
                      (MESH_BATCH, rows * MESH_SEQ // MESH[1],
                       MESH_BATCH * MESH_PROMPT, MESH_BATCH * MESH_SEQ),
                      checked, worst)
    dh, hq, hkv = cfg.dh, cfg.n_heads, cfg.n_kv_heads
    tp_heads = hq // MESH[1]
    cases = [("tensor-parallel shard", rows, tp_heads, MESH_SEQ, MESH_SEQ, 0)]
    cases += [("context-parallel shard", rows, hq, MESH_SEQ // MESH[1],
               MESH_SEQ, off) for off in _cp_offsets()]
    cases += [("one device", MESH_BATCH, hq, s, s, 0)
              for s in (MESH_PROMPT, MESH_SEQ)]
    for what, b, h, sq, skv, off in cases:
        q = torch.randn((b, h, sq, dh), generator=gen, device="cuda")
        kv = tuple(torch.randn((b, hkv, skv, dh), generator=gen,
                               device="cuda") for _ in range(2))
        _, rec = _check_launch(torch, "flash_attention", flash_attention_cuda,
                               _flash_plain, (q, *kv),
                               {"causal": True, "q_offset": off}, checked,
                               worst)
        emit({"phase": "kernel", "kernel": "flash_attention", **tag,
              "what": what, "b": b, "hq": h, "hkv": hkv, "sq": sq,
              "skv": skv, "dh": dh, "causal": True, "q_offset": off, **rec})
    _whisper_mesh_kernel_checks(torch, gen, checked, worst)
    ops.reset_op_calls()
    return worst, checked


#: whisper-small's serve steps at MESH: MESH_BATCH rows of its 1500
#: encoder frames and a 448-token decoder prompt (its text context,
#: arXiv:2212.04356): 375 and 112 rows a context-parallel shard
WHISPER_MESH_PROMPT = 448


def _whisper_mesh_kernel_checks(torch, gen, checked, worst) -> None:
    """Every launch shape of serve_mesh's whisper-small steps against its
    plain version, twice: spx_matmul at the whole weights at M = 8 x 375
    (a context-parallel shard's encoder rows and cross K/V), 8 x 112 (its
    decoder rows) and the one-device prefill's 16 x 1500 and 16 x 448,
    and at the 4-shard cut at a data group's 8 x 1500 and 8 x 448 (the
    tensor-parallel prefill); flash attention at 64 dims a head: the
    context-parallel encoder shard (12 heads, 375 queries over 1500
    frames, not causal, at each shard's offset: the kernel ignores it,
    its output bit-identical at every offset), the decoder shard (112
    queries over the 448 gathered keys at offsets 0, 112, 224, 336) and
    its cross-attention (112 over 1500 frames); a tensor-parallel shard's
    3 heads and the one-device prefill's 12 at the encoder, the decoder
    and the cross-attention."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    cfg = _whisper_config()
    rows = MESH_BATCH // MESH[0]
    enc, dec, n = cfg.enc_seq_len, WHISPER_MESH_PROMPT, MESH[1]
    tag = {"for": "serve_mesh", "arch": cfg.name, "mesh": list(MESH)}
    _check_spx_shapes(torch, gen, dict(tag, weights="whole"),
                      _shard_projection_shapes(torch, cfg, 1),
                      (rows * enc // n, rows * dec // n, MESH_BATCH * enc,
                       MESH_BATCH * dec), checked, worst)
    _check_spx_shapes(torch, gen, dict(tag, weights="tensor-parallel cut"),
                      _shard_projection_shapes(torch, cfg, n),
                      (rows * enc, rows * dec), checked, worst)
    h, dh = cfg.n_heads, cfg.dh
    cases = [("context-parallel encoder shard", rows, h, enc // n, enc,
              False, [m * enc // n for m in range(n)]),
             ("context-parallel decoder shard", rows, h, dec // n, dec,
              True, [m * dec // n for m in range(n)]),
             ("context-parallel cross-attention", rows, h, dec // n, enc,
              False, [0])]
    for what, hq, b in (("tensor-parallel shard", h // n, rows),
                        ("one device", h, MESH_BATCH)):
        cases += [(f"{what} encoder", b, hq, enc, enc, False, [0]),
                  (f"{what} decoder", b, hq, dec, dec, True, [0]),
                  (f"{what} cross-attention", b, hq, dec, enc, False, [0])]
    for what, b, hq, sq, skv, causal, offsets in cases:
        q = torch.randn((b, hq, sq, dh), generator=gen, device="cuda")
        kv = tuple(torch.randn((b, hq, skv, dh), generator=gen,
                               device="cuda") for _ in range(2))
        first = None
        for off in offsets:
            got, rec = _check_launch(
                torch, "flash_attention", flash_attention_cuda, _flash_plain,
                (q, *kv), {"causal": causal, "q_offset": off}, checked,
                worst)
            if first is None:
                first = got
            # not causal: the offset changes nothing, bit for bit
            same = causal or bool(torch.equal(got, first))
            require(same, f"flash_attention {what}: q_offset {off} changed "
                          "a non-causal output")
            emit({"phase": "kernel", "kernel": "flash_attention", **tag,
                  "what": what, "b": b, "hq": hq, "hkv": hq, "sq": sq,
                  "skv": skv, "dh": dh, "causal": causal, "q_offset": off,
                  "equal_to_offset_0": None if causal else same, **rec})
        del q, kv, first, got


def _mesh_run(torch, name, run, checked, counts=None) -> tuple:
    """One serve step (``run()``) with every launch recorded: (its
    output, host ms, max_memory_allocated, launches by op, launches by
    shape); every launch at a shape the kernel phases checked, no plain
    version run. ``counts``: a dict to fill with the collective counters
    by device, set to 0 just before the step and read just after."""
    from repro_torch import collectives
    from repro_torch.kernels import ops
    rec = _ShapeRecorder(torch, SHARDED_OPS + ("flash_attention",))
    with rec:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_op_calls()
        collectives.reset_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches, plain = ops.op_calls(), ops.ref_calls()
        if counts is not None:
            counts.update(collectives.counts())
    require(not plain, f"{name}: plain versions ran on the card: {plain}")
    unchecked = sorted(rec.keys - checked)
    require(not unchecked, f"{name}: launches at shapes the kernel phases "
                           f"never held to the plain version: {unchecked}")
    by_shape = [[*k, n] for k, n in sorted(rec.counts.items())]
    return out, ms, torch.cuda.max_memory_allocated(), launches, by_shape


def _serve_state_bytes(weights, caches) -> list:
    """[[device (d, m)'s bytes of its stored weights and cache blocks]]
    (a whole weight shared by the devices counted on each)."""
    return [[_tree_bytes(w) + _tree_bytes(c) for w, c in zip(wr, cr)]
            for wr, cr in zip(weights, caches)]


def _rel_err(torch, got, want) -> float:
    return ((got - want.to(got.device)).abs().max()
            / want.abs().max()).item()


def _caches_err(torch, got, want) -> float:
    from repro_torch.nn.layers import tree_leaves
    return max((g.float() - w.float().to(g.device)).abs().max().item()
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def serve_mesh_phase(torch, np, params, card: str, checked: set) -> dict:
    """gemma-2b's serve steps at full width under a (data=2, model=4)
    mesh on the one card (``launch.steps.build_serve_step``;
    ``REPRO_FORCE_DEVICE_COUNT`` = 8, set by the caller), on the serve
    phase's sp2_4 weights, f32 dense caches, 16 rows of 512 tokens: the
    tensor-parallel prefill, the context-parallel prefill (queries
    sequence-sharded, K/V gathered, the flash kernel's causal offset) and
    16 decode steps against the sequence-sharded cache filled to 496
    tokens, each beside the one-device step on the same inputs. Per step:
    host ms, max_memory_allocated, launches by kernel and by shape (every
    shape checked by ``mesh_kernel_phase``), the logits against the
    one-device step (within E2E_RTOL of their peak) and the caches
    reassembled from their blocks against the one-device caches. Returns
    the launches of each step kind."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import hostdev
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import lm as lm_mod
    from repro_torch.runtime import Runtime
    from repro_torch.sharding import shard_dense_caches

    cfg = get_config("gemma-2b")
    mesh = make_host_mesh(*MESH, hostdev.device_list())
    gen = torch.Generator(device="cuda").manual_seed(43)
    tokens = torch.randint(1, cfg.vocab_size, (MESH_BATCH, MESH_SEQ),
                           generator=gen, device="cuda")
    one_rt, f32 = Runtime(), torch.float32

    def one_prefill(n):
        caches = lm_mod.init_caches(cfg, MESH_BATCH, MESH_SEQ, dtype=f32)
        with torch.no_grad():
            return lm_mod.lm_prefill(params, tokens[:, :n], caches, cfg,
                                     one_rt)

    _free(torch)
    out = {"launches": {}}
    base = {"mesh": list(MESH), "devices": [str(d) for d in mesh.devices],
            "card": card, "arch": cfg.name, "batch": MESH_BATCH,
            "cache_tokens": MESH_SEQ, "cache_dtype": "float32",
            "weights": "sp2_4", "tol_rel": E2E_RTOL}
    (want, want_c), one_ms, one_mem, _, _ = _mesh_run(
        torch, "one-device prefill", lambda: one_prefill(MESH_SEQ), checked)
    for cp in (False, True):
        name = "prefill-cp" if cp else "prefill-tp"
        bundle = build_serve_step(
            cfg, ShapeConfig(name, MESH_SEQ, MESH_BATCH, "prefill"), mesh,
            prefill_cp=cp, dtype=f32)
        require(bundle.meta["context_parallel"] is cp,
                f"serve_mesh {name}: meta {bundle.meta}")
        args = bundle.place(params, tokens)
        # a prefill writes every position of its cache: the rerun may
        # reuse the blocks
        grid = bundle.init_caches()
        per_device = _serve_state_bytes(args[0], grid)
        counts: dict = {}
        runs = [_mesh_run(torch, f"serve_mesh {name}",
                          lambda: bundle.fn(*args, grid), checked,
                          counts if i == 0 else None)
                for i in range(2)]
        (got, grid), ms, mem, launches, by_shape = runs[1]
        require(torch.equal(runs[0][0][0], got),
                f"serve_mesh {name}: a rerun changed the logits")
        err = _rel_err(torch, got, want)
        c_err = _caches_err(torch, bundle.gather(grid, "cuda"),
                            want_c)
        offsets = sorted({r[4] for r in by_shape
                          if r[0] == "flash_attention"})
        line = dict(base, phase="serve_mesh", step=name, meta={
            k: v for k, v in bundle.meta.items() if k != "data_axes"},
            ms=ms, first_run_ms=runs[0][1], one_device_ms=one_ms,
            max_memory_allocated=mem, one_device_max_memory_allocated=one_mem,
            launches_per_step=launches, launches_by_shape=by_shape,
            flash_q_offsets=offsets, logits_max_rel_err=err,
            caches_max_abs_err=c_err, caches_peak=max(
                t.abs().max().item() for c in want_c for t in c.values()),
            bit_identical_rerun=True, per_device_state_bytes=per_device,
            collectives=counts)
        ok = err <= E2E_RTOL and c_err <= E2E_RTOL * line["caches_peak"]
        if cp:
            ok = ok and offsets == list(_cp_offsets())
        emit(dict(line, ok=ok))
        require(ok, f"serve_mesh {name}: logits {err}, caches {c_err}, "
                    f"flash offsets {offsets}")
        out["launches"][f"serve_mesh {name}"] = launches
        out[name] = {"per_device_state_bytes": per_device,
                     "collectives": counts, "max_memory_allocated": mem,
                     "prefill_cp": cp}
        del args, runs, grid, got, bundle
        _free(torch)
    del want, want_c
    _free(torch)

    # decode: the one-device prefill of MESH_PROMPT tokens, cut into the
    # mesh's blocks, then MESH_DECODE_STEPS steps on each side
    _, one_c = one_prefill(MESH_PROMPT)
    bundle = build_serve_step(
        cfg, ShapeConfig("decode", MESH_SEQ, MESH_BATCH, "decode"), mesh,
        dtype=f32)
    require(bundle.rt.decode_seq_axis == "model",
            "serve_mesh decode: the cache is not sequence-sharded")
    grid = shard_dense_caches(one_c, bundle.specs, mesh)
    placed, = bundle.place(params)
    per_device = _serve_state_bytes(placed, grid)
    steps, total, counts = [], {}, {}
    for i in range(MESH_DECODE_STEPS):
        pos = MESH_PROMPT + i
        tok = tokens[:, pos]
        (want, one_c), one_ms, _, _, _ = _mesh_run(
            torch, "one-device decode", lambda: lm_mod.lm_decode_step(
                params, tok, pos, one_c, cfg, one_rt), checked)
        (got, grid), ms, mem, launches, by_shape = _mesh_run(
            torch, "serve_mesh decode", lambda: bundle.fn(
                placed, tok, torch.tensor(pos), grid), checked,
            counts if i == 0 else None)
        steps.append({"pos": pos, "ms": ms, "one_device_ms": one_ms,
                      "max_memory_allocated": mem,
                      "logits_max_rel_err": _rel_err(torch, got, want)})
        for op, n in launches.items():
            total[op] = total.get(op, 0) + n
    c_err = _caches_err(torch, bundle.gather(grid, "cuda"), one_c)
    errs = [st["logits_max_rel_err"] for st in steps]
    ok = max(errs) <= E2E_RTOL and c_err <= E2E_RTOL * max(
        t.abs().max().item() for c in one_c for t in c.values())
    emit(dict(base, phase="serve_mesh", step="decode",
              meta={k: v for k, v in bundle.meta.items()
                    if k != "data_axes"},
              prompt_tokens=MESH_PROMPT, decode_steps=MESH_DECODE_STEPS,
              ms_per_step=sum(st["ms"] for st in steps[1:])
              / (len(steps) - 1),
              one_device_ms_per_step=sum(st["one_device_ms"]
                                         for st in steps[1:])
              / (len(steps) - 1),
              launches_per_step={op: n / MESH_DECODE_STEPS
                                 for op, n in total.items()},
              launches_by_shape_last_step=by_shape, steps=steps,
              logits_max_rel_err=max(errs), caches_max_abs_err=c_err,
              per_device_state_bytes=per_device, collectives_step_1=counts,
              ok=ok))
    require(ok, f"serve_mesh decode: logits {max(errs)}, caches {c_err}")
    out["launches"]["serve_mesh decode"] = total
    out["decode"] = {"per_device_state_bytes": per_device,
                     "collectives": counts,
                     "max_memory_allocated": max(st["max_memory_allocated"]
                                                 for st in steps)}
    del grid, placed, one_c, bundle
    _free(torch)
    whisper = _serve_mesh_whisper(torch, np, card, checked)
    out["launches"].update(whisper.pop("launches"))
    out.update(whisper)
    return out


def _serve_mesh_whisper(torch, np, card: str, checked: set) -> dict:
    """whisper-small at its published width and depth (12 + 12 layers,
    d_model 768, 12 heads of 64, 1500 encoder frames) in serve_mesh:
    sp2_4 weights from a seed, f32 dense caches, MESH_BATCH rows of 1500
    frames and a WHISPER_MESH_PROMPT-token prompt from a seed, at mesh
    MESH. Three prefills on the same inputs: the context-parallel step
    (``prefill_cp=True``: weights whole on every device, the encoder's
    1500 frames and the prompt each cut into 4 row blocks, the K/V
    gathered, the cross K/V of the encoder's blocks gathered for every
    decoder block), the tensor-parallel step (``prefill_cp`` None, the
    reference's default for an encoder-decoder) and the one-device
    ``encdec_prefill``. Per mesh step, run twice (the rerun
    bit-identical), then once traced (device busy ms and idle share, the
    one-device step's too): host ms, max_memory_allocated, per-device
    bytes of weights and cache blocks, the collective counters, launches
    by kernel and by shape (every shape checked), the logits within
    E2E_RTOL of the one-device step's peak and the caches reassembled
    from their blocks within E2E_RTOL of the one-device caches' peak.
    The context-parallel step launches flash 288 times (2 data groups x
    12 layers x 3 attentions x 4 row blocks) and spx_matmul 1536 times
    (2 x 12 x (6 encoder + 2 cross K/V projections on 4 encoder blocks, 8
    decoder projections on 4 decoder blocks)). Returns the launches of
    each step and, by step, what the dryrun phase holds."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import hostdev
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import encdec as ed
    from repro_torch.runtime import Runtime

    t_phase = time.perf_counter()
    cfg = _whisper_config()
    mesh = make_host_mesh(*MESH, hostdev.device_list())
    params = _whisper_params(torch, cfg, seed=47)
    gen = torch.Generator(device="cuda").manual_seed(53)
    frames = torch.randn((MESH_BATCH, cfg.enc_seq_len, cfg.d_model),
                         generator=gen, device="cuda")
    tokens = torch.randint(1, cfg.vocab_size,
                           (MESH_BATCH, WHISPER_MESH_PROMPT), generator=gen,
                           device="cuda")
    f32 = torch.float32

    def one_prefill():
        caches = ed.encdec_init_caches(cfg, MESH_BATCH, WHISPER_MESH_PROMPT,
                                       dtype=f32)
        with torch.no_grad():
            return ed.encdec_prefill(params, frames, tokens, caches, cfg,
                                     Runtime())

    def busy(run) -> dict:
        """One more run under the profiler: its device busy ms (the union
        of the kernel intervals) and the idle share of its wall time."""
        evs, wall = _device_events(torch, run, host_ops=False)
        b = _busy_us(evs) / 1e3
        return {"device_busy_ms": b if evs else None, "wall_ms": wall * 1e3,
                "device_idle_share": 1 - b / (wall * 1e3) if evs else None}

    _free(torch)
    (want, want_c), one_ms, one_mem, one_launches, _ = _mesh_run(
        torch, "whisper one-device prefill", one_prefill, checked)
    one_trace = busy(one_prefill)
    c_peak = max(t.abs().max().item() for c in want_c for t in c.values())
    base = {"phase": "serve_mesh", "mesh": list(MESH), "card": card,
            "arch": cfg.name, "batch": MESH_BATCH,
            "encoder_frames": cfg.enc_seq_len,
            "prompt_tokens": WHISPER_MESH_PROMPT, "cache_dtype": "float32",
            "weights": "sp2_4", "tol_rel": E2E_RTOL,
            "one_device_ms": one_ms,
            "one_device_max_memory_allocated": one_mem,
            "one_device_launches": one_launches, "one_device_trace": one_trace}
    blocks = MESH[1]
    want_cp = {"flash_attention": MESH[0] * cfg.n_layers * 3 * blocks,
               "spx_matmul": MESH[0] * cfg.n_layers * ((6 + 2) * blocks
                                                       + 8 * blocks)}
    out = {"launches": {}}
    for cp in (True, None):
        name = "prefill-cp" if cp else "prefill-tp"
        bundle = build_serve_step(
            cfg, ShapeConfig(name, WHISPER_MESH_PROMPT, MESH_BATCH,
                             "prefill"), mesh, prefill_cp=cp, dtype=f32)
        seqs = {"decoder": bool(cp), "encoder": bool(cp)}
        require(bundle.meta["cp_sequences"] == seqs,
                f"serve_mesh whisper {name}: meta {bundle.meta}")
        args = bundle.place(params, frames, tokens)
        grid = bundle.init_caches()
        per_device = _serve_state_bytes(args[0], grid)
        counts: dict = {}
        runs = [_mesh_run(torch, f"serve_mesh whisper {name}",
                          lambda: bundle.fn(*args, grid), checked,
                          counts if i == 0 else None)
                for i in range(2)]
        (got, grid), ms, mem, launches, by_shape = runs[1]
        require(torch.equal(runs[0][0][0], got),
                f"serve_mesh whisper {name}: a rerun changed the logits")
        err = _rel_err(torch, got, want)
        c_err = _caches_err(torch, bundle.gather(grid, "cuda"), want_c)
        offsets = sorted({(r[3], r[4]) for r in by_shape
                          if r[0] == "flash_attention"})
        line = dict(base, step=name, meta={
            k: v for k, v in bundle.meta.items() if k != "data_axes"},
            ms=ms, first_run_ms=runs[0][1], max_memory_allocated=mem,
            launches_per_step=launches, launches_by_shape=by_shape,
            flash_causal_and_q_offsets=offsets, logits_max_rel_err=err,
            caches_max_abs_err=c_err, caches_peak=c_peak,
            bit_identical_rerun=True, per_device_state_bytes=per_device,
            collectives=counts, trace=busy(lambda: bundle.fn(*args, grid)))
        ok = err <= E2E_RTOL and c_err <= E2E_RTOL * c_peak
        if cp:
            line["launches_expected"] = want_cp
            ok = ok and all(launches.get(op) == n
                            for op, n in want_cp.items())
        emit(dict(line, ok=ok))
        require(ok, f"serve_mesh whisper {name}: logits {err}, caches "
                    f"{c_err}, launches {launches}")
        out["launches"][f"serve_mesh whisper-small {name}"] = launches
        out[f"whisper-small {name}"] = {
            "per_device_state_bytes": per_device, "collectives": counts,
            "max_memory_allocated": mem, "prefill_cp": cp,
            "launches_by_shape": by_shape}
        del args, runs, grid, got, bundle
        _free(torch)
    del params, want, want_c
    _free(torch)
    emit({"phase": "serve_mesh", "arch": cfg.name, "step": "all",
          "seconds": time.perf_counter() - t_phase, "card": card})
    return out


#: the dry run's memory gate: its mesh peak of live storage within this
#: share of the card's max_memory_allocated on the train_mesh cells
DRYRUN_MEM_RTOL = 0.2
#: the dryrun phase's time limit, seconds
DRYRUN_SECONDS = 120


def dryrun_phase(torch, train_mesh: dict, serve_mesh: dict,
                 card: str) -> dict:
    """The dry run (``launch.dryrun.dry_report``, on ``meta``: no card)
    of every train_mesh cell and serve_mesh step of full-width gemma-2b,
    and of serve_mesh's context-parallel whisper-small prefill, at the
    same mesh, shape and knobs, held to what the card run measured:
    each device's params and optimizer state (serve: weights and cache
    blocks) equal to the card's ``per_device_state_bytes``; every
    device's collective counters equal to those read during the card's
    step (its first); for the train cells the mesh peak of live storage
    within DRYRUN_MEM_RTOL of the card's max_memory_allocated (the serve
    steps' plain ``spx_matmul`` dequantizes whole weights, which the
    kernel never holds: both numbers printed, no gate); each cell again
    by the class path (``classes=True``: one representative per
    symmetric class, what the production cells run), its per-device
    state and every device's collective counters equal to the card's too
    and its flops to the full run's (the memory gate stays on the full
    run's mesh-wide peak); the whole phase within DRYRUN_SECONDS."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import dry_report
    from repro_torch.launch.mesh import make_host_mesh

    cfg = get_config("gemma-2b")
    mesh = make_host_mesh(*MESH, ["meta"] * (MESH[0] * MESH[1]))
    t_phase = time.perf_counter()
    cells = []
    for cell, b, knobs in TRAIN_MESH_CELLS:
        rec = train_mesh["cells"][cell]
        cells.append((f"train_mesh {cell}", cfg, ShapeConfig(
            "train_mesh", TRAIN_MESH_SEQ, b, "train"),
            dict(knobs, dtype=torch.float32), ("params", "opt_state"),
            rec["per_device_state_bytes"], rec["steps"][0]["collectives"],
            rec["max_memory_allocated"], True))
    serve = ((cfg, "prefill-tp", "prefill", False, MESH_SEQ),
             (cfg, "prefill-cp", "prefill", True, MESH_SEQ),
             (cfg, "decode", "decode", None, MESH_SEQ),
             (_whisper_config(), "prefill-cp", "prefill", True,
              WHISPER_MESH_PROMPT))
    for c, step, kind, cp, seq in serve:
        key = step if c is cfg else f"{c.name} {step}"
        rec = serve_mesh[key]
        knobs = dict(dtype=torch.float32, param_dtype=torch.float32)
        if cp is not None:
            knobs["prefill_cp"] = cp
        cells.append((f"serve_mesh {key}", c, ShapeConfig(
            step, seq, MESH_BATCH, kind), knobs, ("params", "caches"),
            rec["per_device_state_bytes"], rec["collectives"],
            rec["max_memory_allocated"], False))
    out = {}

    def state_of(rep, parts):
        by_dev = rep["argument_by_device"]
        return [[sum(by_dev[p][d][m] for p in parts)
                 for m in range(MESH[1])] for d in range(MESH[0])]
    for (name, c, shape, knobs, parts, state, counts, card_mem,
         gate) in cells:
        t0 = time.perf_counter()
        rep = dry_report(c, shape, mesh, **knobs)
        dry_state = state_of(rep, parts)
        t_class = time.perf_counter()
        cls = dry_report(c, shape, mesh, classes=True, **knobs)
        cls_line = {"classes": [[k["representative"], k["units"]]
                                for k in cls["classes"]],
                    "state_equal": state_of(cls, parts) == state,
                    "collectives_equal": cls["collectives"]["by_device"]
                    == counts,
                    "flops_equal": cls["cost"] == rep["cost"],
                    "temp_bytes": cls["memory"]["temp_bytes"],
                    "temp_over": cls["memory"]["temp_over"],
                    "seconds": time.perf_counter() - t_class}
        peak = rep["memory"]["mesh_peak_bytes"]
        mem_rel = peak / card_mem - 1
        line = {"phase": "dryrun", "cell": name, "card": card,
                "arch": c.name, "mesh": list(MESH),
                "meta": {k: v for k, v in rep["meta"].items()},
                "per_device_state_bytes": dry_state,
                "card_per_device_state_bytes": state,
                "state_equal": dry_state == state,
                "collectives_busiest": rep["collectives"]["busiest"],
                "collectives_mean": rep["collectives"]["mean"],
                "collectives_equal": rep["collectives"]["by_device"]
                == counts,
                "mesh_peak_bytes": peak,
                "card_max_memory_allocated": card_mem,
                "mesh_peak_rel_to_card": mem_rel,
                "memory_gated": gate, "tol_mem_rel": DRYRUN_MEM_RTOL,
                "memory": rep["memory"], "flops": rep["cost"]["flops"],
                "departures": rep["departures"], "uneven": rep["uneven"],
                "build_s": rep["build_s"], "run_s": rep["run_s"],
                "class_path": cls_line,
                "seconds": time.perf_counter() - t0}
        emit(line)
        require(line["state_equal"],
                f"dryrun {name}: per-device state {dry_state} against the "
                f"card's {state}")
        require(line["collectives_equal"],
                f"dryrun {name}: collectives {rep['collectives']['by_device']}"
                f" against the card's {counts}")
        require(cls_line["state_equal"] and cls_line["collectives_equal"]
                and cls_line["flops_equal"],
                f"dryrun {name}: the class path's per-device state, "
                f"collectives {cls['collectives']['by_device']} or flops "
                f"{cls['cost']} against the card's and the full run's")
        if gate:
            require(abs(mem_rel) <= DRYRUN_MEM_RTOL,
                    f"dryrun {name}: mesh peak {peak} against the card's "
                    f"{card_mem} ({mem_rel:+.3f})")
        out[name] = line
    seconds = time.perf_counter() - t_phase
    emit({"phase": "dryrun", "cell": "all", "seconds": seconds,
          "limit_s": DRYRUN_SECONDS})
    require(seconds <= DRYRUN_SECONDS,
            f"dryrun: {seconds:.1f} s (limit {DRYRUN_SECONDS})")
    return out


def _step_launch_checks(name, records, per_call, n_attn, quant,
                        prefix="lm_") -> dict:
    """Launches per model step of a sharded run (the ``prefix`` model's
    steps): every step ``per_call`` spx_matmul launches (one per shard and
    projection), every decode tick (fused) and one-token step ``n_attn``
    paged kernels (one per shard and attention layer; none for a pageless
    pattern)."""
    ragged = "paged_decode_ragged_quant" if quant else "paged_decode_ragged"
    single = "paged_attention_quant" if quant else "paged_attention"
    fused = prefix + "paged_fused_step"
    bad = [r for r in records if r[3].get("spx_matmul", 0) != per_call]
    require(not bad, f"{name}: model steps without {per_call} spx_matmul "
                     f"launches: {bad[:3]}")
    ticks = [r for r in records if r[0] == fused]
    one = [r for r in records if r[0] != fused and r[1] == 1]
    if n_attn:
        require(all(r[3].get(ragged) == n_attn for r in ticks),
                f"{name}: decode ticks without {n_attn} {ragged} launches")
        require(one and all(r[3].get(single) == n_attn for r in one),
                f"{name}: one-token steps without {n_attn} {single} "
                "launches")
    else:
        require(not any({ragged, single} & set(r[3]) for r in records),
                f"{name}: paged kernels launched on a pageless pattern")
    return {"spx_matmul_per_model_step": per_call,
            f"{ragged}_per_decode_tick": n_attn if ticks else 0,
            f"{single}_per_one_token_step": n_attn,
            "decode_ticks": len(ticks), "one_token_steps": len(one),
            "model_steps": len(records)}


def _one_shard_base(torch, np, params, cfg, prompts, knobs, rt,
                    frames=None) -> tuple:
    """``ServeConfig(quantize=None, **knobs)`` at shards=1: (tokens, top-2
    gaps, metrics), what ``_serve_sharded_pair`` holds a sharded run to."""
    from repro_torch.serving import ServeConfig, ServeEngine
    _free(torch)
    one = ServeEngine(params, cfg, ServeConfig(quantize=None, **knobs),
                      rt=rt)
    gaps = _record_gaps(np, one, E2E_RTOL)
    want, _, _, bm = _run_engine(torch, one, prompts, frames=frames)
    del one
    _free(torch)
    return want, gaps, bm


def _serve_sharded_pair(torch, np, params, cfg, prompts, knobs, rt, checked,
                        name, card, *, per_call, n_attn, base=None,
                        frames=None, module=None,
                        recorded=SHARDED_OPS, shards=SHARDS) -> tuple:
    """``ServeConfig(quantize=None, **knobs)`` at shards=1 (or ``base``,
    that run's (tokens, top-2 gaps, metrics) taken by the caller), then
    at ``shards`` with every launch recorded (each at a checked shape)
    and every model step counted: ``per_call`` spx_matmul launches at
    shards=1, each shard launching its cut of every one, and ``n_attn``
    attention layers, one paged kernel per shard and layer.
    ``frames``: an enc-dec model's inputs (``module``: its step
    functions). The sharded tokens must be the one-shard engine's, a
    difference allowed only first where its top-2 gap is a near-tie
    (E2E_RTOL). Returns the emitted line, the sharded run's launches and
    its engine."""
    from repro_torch.serving import ServeConfig, ServeEngine

    _free(torch)
    want, gaps, bm = base or _one_shard_base(torch, np, params, cfg, prompts,
                                             knobs, rt, frames)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(params, cfg,
                      ServeConfig(quantize=None, shards=shards, **knobs),
                      rt=rt)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prefix = "encdec_" if cfg.enc_dec else "lm_"
    tokens, launches, plain, m, records, _ = _serve_recorded(
        torch, np, eng, prompts, checked, name, frames=frames,
        steps=tuple(prefix + f for f in ("paged_step", "paged_fused_step",
                                         "paged_verify")),
        module=module, recorded=recorded)
    peak = torch.cuda.max_memory_allocated()
    require(len(tokens) == N_REQUESTS,
            f"{name}: {len(tokens)} of {N_REQUESTS} finished")
    for rid, toks in tokens.items():
        require(len(toks) == NEW_TOKENS
                and all(0 <= t < cfg.vocab_size for t in toks),
                f"{name}: request {rid}: bad output {toks}")
    require(not plain, f"{name}: plain versions ran on the card: {plain}")
    require(m["shards"] == shards, f"{name}: shards {m['shards']}")
    if n_attn:
        h = _shard_heads(cfg, shards)
        require(m["kv_sharded"] == h["kv_sharded"]
                and m["kv_heads_per_shard"] == h["hkv"],
                f"{name}: shard metrics {m['kv_sharded']}, "
                f"{m['kv_heads_per_shard']}")
        if h["kv_sharded"]:
            require(m["peak_kv_bytes_per_shard"] * shards
                    == m["peak_kv_bytes"], f"{name}: per-shard KV bytes")
    per_step = _step_launch_checks(name, records, shards * per_call,
                                   shards * n_attn, bool(rt.kv_quant),
                                   prefix)
    line = {"phase": "serve_sharded", "arch": cfg.name, "path": name,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size,
            "config": f"ServeConfig(quantize=None, shards={shards}"
                      + "".join(f", {k}={v!r}" for k, v in knobs.items())
                      + ")" + (f", Runtime(kv_quant=True, kv_scheme="
                               f"'{KV_SCHEME}')" if rt.kv_quant else ""),
            "devices": [str(d) for d in eng.mesh.devices], "card": card,
            "shards": m["shards"],
            **{k: m[k] for k in ("kv_sharded", "kv_heads_per_shard",
                                 "peak_kv_bytes_per_shard",
                                 "pool_bytes_per_shard") if k in m},
            "peak_kv_bytes": m["peak_kv_bytes"],
            "peak_state_bytes": m["peak_state_bytes"],
            "peak_slabs": m["peak_slabs"],
            "requests_finished": len(tokens), "setup_s": setup_s,
            "tokens_per_s": m["tokens_per_s"],
            "ttft_p50_ms": m["ttft_p50_ms"],
            "latency_p50_ms": m["latency_p50_ms"], "wall_s": m["wall_s"],
            "model_calls": m["model_calls"],
            "max_memory_allocated": peak,
            "one_shard": {k: bm[k] for k in (
                "tokens_per_s", "ttft_p50_ms", "latency_p50_ms", "wall_s",
                "model_calls", "peak_kv_bytes", "peak_state_bytes")},
            "launches": launches, "launches_per_model_step": per_step,
            "tokens_vs_one_shard": _near_tie_check(
                f"{name} vs shards=1", tokens, want, gaps),
            "near_tie_tol_rel": E2E_RTOL}
    return line, launches, eng


def _sharded_family_timing(torch, cfg, shard, n_attn: int, shards=SHARDS,
                           s: int = 0) -> dict:
    """Shard ``s``'s kernels per decode tick at ``shards`` (4 slots): its
    spx_matmul launches and the MoE experts it holds (``_family_timing``
    on its cut weights), and kernel 2 at its (KV heads, query heads per KV
    head) over every attention layer."""
    out = _family_timing(torch, cfg, shard, 4)
    if n_attn:
        (hkv, rep), = _shard_kernel_heads(cfg, shards)[s]
        out["paged_decode_ragged"] = _paged_dh_timing(
            torch, torch.Generator(device="cuda").manual_seed(37),
            hkv=hkv, rep=rep, dh=cfg.dh, layers=n_attn)
    for row in out.values():
        row["per"] = f"shard {s} of {shards}: " + row["per"]
    torch.cuda.empty_cache()
    return out


def serve_sharded_phase(torch, np, params, card: str, checked: set) -> dict:
    """Tensor-parallel serving on the one card (``REPRO_FORCE_DEVICE_COUNT``
    = 2 lists it twice): full-width gemma-2b on the quantized weights of
    the serve phase at ``ServeConfig(quantize=None, shards=2)`` in four
    modes (the fused tick, the unfused tick, spec decoding with spec_k =
    4, and SPx-coded pages), then qwen2-vl-2b at full width (weights from
    a seed, quantized to sp2_4 one period at a time), whose two KV heads
    head-shard its pools. Each against the same config at shards=1
    (``_serve_sharded_pair``); gemma's one KV head replicates. Every launch
    at a shape the kernel phase's ``"for": "serve_sharded"`` checks
    covered; per model step one spx_matmul per shard and projection and
    one paged kernel per shard and layer. Also times the kernels at one
    shard's shapes. Returns each path's launches and the timing rows."""
    from repro_torch.runtime import Runtime

    cfg = _sharded_configs()["gemma-2b"]
    lens, prompts = _prompts(np, cfg)
    coded = Runtime(kv_quant=True, kv_scheme=KV_SCHEME)
    out = {"launches": {}}
    for mode, knobs, rt in (
            ("fused", {}, Runtime()),
            ("unfused", {"fused_decode": False}, Runtime()),
            ("spec", {"spec_decode": True, "spec_k": 4}, Runtime()),
            ("coded-kv", {}, coded)):
        line, launches, eng = _serve_sharded_pair(
            torch, np, params, cfg, prompts, knobs, rt, checked,
            f"serve_sharded {mode}", card, per_call=7 * cfg.n_layers,
            n_attn=cfg.n_layers)
        if mode == "fused":
            out["timing"] = _sharded_timing(torch, eng)
        elif mode == "coded-kv":
            out["timing_quant"] = _sharded_quant_timing(torch, eng)
        del eng
        line["prompt_lens"] = lens
        emit(line)
        out["launches"][f"serve_sharded {mode}"] = launches
    _free(torch)

    qwen = _sharded_configs()["qwen2-vl-2b"]
    t0 = time.perf_counter()
    qparams = _family_params(torch, qwen, seed=2)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    lens, prompts = _prompts(np, qwen)
    base = _one_shard_base(torch, np, qparams, qwen, prompts, {}, Runtime())
    line, launches, eng = _serve_sharded_pair(
        torch, np, qparams, qwen, prompts, {}, Runtime(), checked,
        "serve_sharded qwen2-vl-2b", card, per_call=7 * qwen.n_layers,
        n_attn=qwen.n_layers, base=base)
    require(line["kv_sharded"] is True,
            "qwen2-vl-2b: its two KV heads did not head-shard")
    del eng
    line.update(prompt_lens=lens, params_setup_s=setup_s)
    emit(line)
    out["launches"]["serve_sharded qwen2-vl-2b"] = launches
    # the width the port refused before: 3 query heads a shard over one
    # of the 2 replicated KV heads
    n = WIDE["qwen2-vl-2b"]
    with _forced_shards(n):
        line, launches, eng = _serve_sharded_pair(
            torch, np, qparams, qwen, prompts, {}, Runtime(), checked,
            f"serve_wide qwen2-vl-2b shards={n}", card,
            per_call=7 * qwen.n_layers, n_attn=qwen.n_layers, base=base,
            shards=n)
    require(line["kv_sharded"] is False and line["kv_heads_per_shard"]
            == qwen.n_kv_heads, "qwen2-vl-2b at 4 shards: its KV heads "
            "did not replicate")
    line.update(phase="serve_wide", prompt_lens=lens,
                timing=_sharded_family_timing(torch, qwen, eng.params[0],
                                              qwen.n_layers, shards=n))
    del eng, qparams
    emit(line)
    out["launches"][f"serve_wide qwen2-vl-2b shards={n}"] = launches
    out["wide"] = {f"qwen2-vl-2b shards={n}": line["timing"]}
    _free(torch)
    return out


def _sharded_timing(torch, eng) -> dict:
    """Kernels 1, 2 and 5 per decode tick at one shard's shapes, both
    shards' launches (gemma-2b, 4 slots, each 48 tokens into its
    sequence): spx_matmul over every shard's seven projections (the
    engine's own cut weights), the paged kernels over every shard's layer
    pools (random, f32). Each beside its plain version, its library call
    and its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_decode_ragged_cuda)
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda

    cfg, m = eng.cfg, eng.batch_slots
    gen = torch.Generator(device="cuda").manual_seed(29)
    mats = [qt for shard in eng.params for i in range(cfg.n_periods)
            for _, qt in _layer_weights(shard, i)]
    lut = mats[0].lut()
    xs = {k: torch.randn((m, k), generator=gen, device="cuda")
          for k in {qt.logical_shape[0] for qt in mats}}

    def spx_tick(fn):
        def run():
            for qt in mats:
                k, n = qt.logical_shape
                fn(xs[k], qt.codes, qt.scale.reshape(1, n), lut,
                   packed=True)
        return run

    dense = [qt.dequantize() for qt in mats]

    def spx_library():
        for w in dense:
            torch.matmul(xs[w.shape[0]], w)

    nbytes = flops = 0
    for qt in mats:
        k, n = qt.logical_shape
        nbytes += m * k * 4 + k * n // 2 + n * 4 + 16 * 4 + m * n * 4
        flops += 2 * m * k * n
    spx = {"per": f"decode tick at shards={SHARDS}: {len(mats)} launches "
                  f"({SHARDS} shards x 7 x {cfg.n_layers}), M={m}",
           "shapes": [f"{k}x{n}" for k, n in _shard_spx_shapes(cfg)],
           "ms": _time_ms(torch, spx_tick(spx_matmul_cuda)),
           "device_ms": _device_ms(torch, spx_tick(spx_matmul_cuda),
                                   ("spx_matmul_kernel",)),
           "plain_ms": _time_ms(torch, spx_tick(ref.spx_matmul_ref), reps=3),
           "library_ms": _time_ms(torch, spx_library),
           "library_device_ms": _device_ms(torch, spx_library, ("",)),
           "library_call": "torch.matmul on pre-dequantized f32 weights",
           "f32_bound_ms": _f32_bound_ms(nbytes, flops)}
    spx["bound_ms"], spx["bound_by"] = _bound_ms(nbytes, flops)
    del dense

    h, dh, ps, mp = _shard_heads(cfg), cfg.dh, eng.page_size, \
        eng.pages_per_seq
    layers = SHARDS * cfg.n_layers
    n_pages, ctx_tokens = m * mp, 48
    attend = ctx_tokens + 1
    pools = [_rand_pools(torch, gen, n_pages, h["hkv"], ps, dh)
             for _ in range(layers)]
    bt = torch.arange(n_pages, dtype=torch.int32,
                      device="cuda").reshape(m, mp)
    q = torch.randn((m, h["hkv"], h["rep"], dh), generator=gen,
                    device="cuda")
    ctx = torch.full((m,), ctx_tokens, dtype=torch.int32, device="cuda")
    one = torch.ones((m,), dtype=torch.int32, device="cuda")
    ctx1 = ctx + 1
    gathered = [
        tuple(ref._gather(p, bt)[:, :, :attend]
              .repeat_interleave(h["rep"], 1) for p in kv) for kv in pools]
    q_sdpa = q.reshape(m, h["hq"], 1, dh)

    def sdpa_tick():
        for k, v in gathered:
            F.scaled_dot_product_attention(q_sdpa, k, v)

    a_bytes = layers * (m * h["hkv"] * attend * dh * 4 * 2
                        + 2 * m * h["hq"] * dh * 4 + m * (mp + 2) * 4)
    a_flops = layers * 4 * m * h["hq"] * dh * attend
    lib = {"library_ms": _time_ms(torch, sdpa_tick),
           "library_device_ms": _device_ms(torch, sdpa_tick, ("",)),
           "library_call": "scaled_dot_product_attention over "
                           "pre-gathered K/V",
           "f32_bound_ms": _f32_bound_ms(a_bytes, a_flops)}
    lib["bound_ms"], lib["bound_by"] = _bound_ms(a_bytes, a_flops)

    def ragged(impl):
        fn = (paged_decode_ragged_cuda if impl == "cuda"
              else ref.paged_decode_ragged_ref)
        for kp, vp in pools:
            fn(q, kp, vp, bt, ctx, one, w=1)

    def single(impl):
        fn = (paged_attention_cuda if impl == "cuda"
              else ref.paged_attention_ref)
        for kp, vp in pools:
            fn(q, kp, vp, bt, ctx1)

    out = {"spx_matmul": spx}
    for name, fn, per in (("paged_decode_ragged", ragged, "decode tick"),
                          ("paged_attention", single,
                           "one-token prefill tick")):
        out[name] = {
            "per": f"{per} at shards={SHARDS}: {layers} launches "
                   f"({SHARDS} shards x {cfg.n_layers}), {m} slots, "
                   f"{h['hq']} query heads over {h['hkv']} KV head of {dh} "
                   f"per shard, {attend} tokens attended each",
            "ms": _time_ms(torch, lambda fn=fn: fn("cuda")),
            "device_ms": _device_ms(torch, lambda fn=fn: fn("cuda"),
                                    PAGED_KERNELS),
            "plain_ms": _time_ms(torch, lambda fn=fn: fn("ref")), **lib}
    del pools, gathered
    torch.cuda.empty_cache()
    return out


def _sharded_quant_timing(torch, eng) -> dict:
    """Kernels 3 and 6 per tick at one shard's heads over code pages, both
    shards' launches (``_quant_timing`` at the shard's query heads and
    twice the layers)."""
    cfg, m = eng.cfg, eng.batch_slots
    h = _shard_heads(cfg)
    scfg = dataclasses.replace(cfg, n_heads=h["hq"], n_kv_heads=h["hkv"],
                               n_layers=SHARDS * cfg.n_layers)
    gen = torch.Generator(device="cuda").manual_seed(31)
    q = torch.randn((m, h["hkv"], h["rep"], cfg.dh), generator=gen,
                    device="cuda")
    rows = _quant_timing(torch, gen, scfg, m, 48, q)
    torch.cuda.empty_cache()
    return {r.pop("name"): dict(r, per=f"{r['per']} (shards={SHARDS}: "
                                       f"{SHARDS} shards x {cfg.n_layers})")
            for r in rows}


def router_phase(torch, np, params, paged_tokens, card: str,
                 checked: set) -> dict:
    """``ReplicaRouter`` with ``ServeConfig(quantize=None, replicas=2)`` on
    the serve phase's quantized gemma-2b weights: both replicas share the
    card. The 8 requests must land ``[0, 1, 0, 1, ...]`` (least-loaded,
    lowest index on ties) and give the paged engine's tokens (a difference
    only at a near-tie, as ``_check_tokens``); every launch must be at a
    shape the kernel phases checked (``tier_kernel_phase``). Returns its
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving import (ReplicaRouter, Request, ServeConfig)

    cfg = get_config("gemma-2b")
    lens, prompts = _prompts(np, cfg)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    router = ReplicaRouter(params, cfg, ServeConfig(quantize=None,
                                                    replicas=2))
    with _ShapeRecorder(torch, SHARDED_OPS) as keys:
        ops.reset_op_calls()
        placements = [router.submit(Request(rid=i, prompt=p,
                                            max_new_tokens=NEW_TOKENS))
                      for i, p in enumerate(prompts)]
        done = router.run()
        torch.cuda.synchronize()
        launches, plain = ops.op_calls(), ops.ref_calls()
    unchecked = sorted(keys - checked)
    require(not unchecked, f"router: launches at shapes the kernel phases "
                           f"never held to the plain version: {unchecked}")
    m = router.metrics()
    tokens = {r.rid: list(r.output) for r in done}
    require(placements == [0, 1] * (N_REQUESTS // 2),
            f"router placements {placements}")
    require(len(tokens) == N_REQUESTS and m["requests_per_replica"]
            == [N_REQUESTS // 2] * 2, f"router finished {m}")
    require(not plain, f"router: plain versions ran on the card: {plain}")
    require(launches.get("spx_matmul") and launches.get(
        "paged_decode_ragged"), f"router launches {launches}")
    vs = _check_tokens(torch, np, "router", tokens, paged_tokens, params,
                       cfg, prompts)
    emit({"phase": "router", "arch": cfg.name, "layers": cfg.n_layers,
          "config": "ReplicaRouter(params, cfg, ServeConfig(quantize=None, "
                    "replicas=2))", "card": card, "replicas": m["replicas"],
          "shards": m["shards"], "placements": placements,
          "requests_per_replica": m["requests_per_replica"],
          "prompt_lens": lens, "tokens_per_s": m["tokens_per_s"],
          "ttft_p50_ms": m["ttft_p50_ms"],
          "latency_p50_ms": m["latency_p50_ms"], "wall_s": m["wall_s"],
          "model_calls": m["model_calls"],
          "engine_steps": m["engine_steps"],
          "peak_kv_bytes": m["peak_kv_bytes"],
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches, "launch_shapes": len(keys),
          "tokens_vs_one_engine": vs})
    del router
    _free(torch)
    return launches


#: the serving CLI's runs: its default flags (full-width gemma-2b, 16
#: requests of 16 new tokens, 4 slots, max_seq 128), the asyncio
#: front-end, and two replicas
CLI_RUNS = (("default", []), ("stream", ["--stream"]),
            ("replicas", ["--replicas", "2"]))


def serve_cli_phase(torch, np, card: str, checked: set) -> dict:
    """``python -m repro_torch.launch.serve`` through its ``main``, on the
    card: it builds full-width gemma-2b from ``--seed`` 0, quantizes it to
    sp2_4 and serves its request wave. Its ``[serve] metrics:`` line must
    parse, every request finish, no plain version run and every launch be
    at a shape the kernel phases checked (``tier_kernel_phase``). The
    ``--stream`` and ``--replicas 2`` runs serve the same wave on the same
    weights: their greedy tokens must be the default run's, a difference
    allowed only first where that run's top-2 gap is a near-tie
    (E2E_RTOL). Returns each run's launches."""
    import contextlib
    import io

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    out, want, noted_gaps = {}, None, []
    engine = serve.ServeEngine

    def noted(*args, **kw):
        # the default run's engine notes the top-2 gap of every token
        eng = engine(*args, **kw)
        noted_gaps.append(_record_gaps(np, eng, E2E_RTOL))
        return eng

    for name, argv in CLI_RUNS:
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        serve.ServeEngine = noted if want is None else engine
        try:
            with _ShapeRecorder(torch, SHARDED_OPS) as keys:
                ops.reset_op_calls()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    done = serve.main(argv)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches, plain = ops.op_calls(), ops.ref_calls()
        finally:
            serve.ServeEngine = engine
        unchecked = sorted(keys - checked)
        require(not unchecked, f"serve_cli {name}: launches at shapes the "
                               "kernel phases never held to the plain "
                               f"version: {unchecked}")
        lines = buf.getvalue().splitlines()
        prefix = "[serve] metrics: "
        require(lines and lines[-1].startswith(prefix),
                f"serve_cli {name}: no metrics line: {lines[-3:]}")
        m = json.loads(lines[-1][len(prefix):])
        require(m["requests_finished"] == 16
                and m["tokens_generated"] == 16 * 16,
                f"serve_cli {name}: {m['requests_finished']} requests, "
                f"{m['tokens_generated']} tokens")
        require(not plain, f"serve_cli {name}: plain versions ran: {plain}")
        require(launches.get("spx_matmul") and launches.get(
            "paged_decode_ragged"), f"serve_cli {name}: launches {launches}")
        tokens = {r.rid: list(r.output) for r in done}
        if want is None:
            want, vs = tokens, "the reference of the other runs"
        else:
            vs = _near_tie_check(f"serve_cli {name} vs default", tokens,
                                 want, noted_gaps[0])
        emit({"phase": "serve_cli", "run": name,
              "argv": ["python", "-m", "repro_torch.launch.serve", *argv],
              "card": card, "printed": lines[:-1],
              "replicas": m.get("replicas", 1),
              "tokens_per_s": m["tokens_per_s"],
              "ttft_p50_ms": m["ttft_p50_ms"],
              "latency_p50_ms": m["latency_p50_ms"],
              "model_calls": m["model_calls"], "seconds": seconds,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "launches": launches, "launch_shapes": len(keys),
              "metrics_keys": len(m), "tokens_vs_default_run": vs})
        out[f"serve_cli {name}"] = launches
    _free(torch)
    return out


# -- phase 6 -------------------------------------------------------------------

#: logits: |cuda - plain| <= E2E_RTOL * max|plain logits|. 18 layers of f32
#: sums taken in other orders (see SPX_RTOL, ATTN_TOL) compound.
E2E_RTOL = 1e-3


def _close(torch, name, got, want) -> None:
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= E2E_RTOL * peak
    emit({"phase": "e2e", "what": f"gemma-2b full width {name} logits",
          "shape": list(got.shape), "max_abs_err": err,
          "max_rel_err": err / peak, "tol_rel": E2E_RTOL, "ok": ok})
    require(ok, f"full-width {name} logits")


def e2e_phase(torch, np, eng) -> None:
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.quantized import QuantizedTensor
    from repro_torch.nn.layers import tree_map
    from repro_torch.models import lm as lm_mod
    from repro_torch.models.lm import lm_init
    from repro_torch.runtime import Runtime, planner
    from repro_torch.serving import Request, ServeConfig, ServeEngine

    cfg = eng.cfg
    b, c = eng.batch_slots, 32
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, c)),
                             device="cuda")
    n_pages = b * 4
    bt = torch.arange(n_pages, dtype=torch.int32,
                      device="cuda").reshape(b, 4)
    ctx0 = torch.zeros(b, dtype=torch.int32, device="cuda")
    nv = torch.tensor([32, 20, 1, 0][:b], dtype=torch.int32, device="cuda")
    act = (nv > 0).to(torch.int32)
    # (slab, cross) indices: the sentinels, no region of either kind
    sidx = torch.zeros((b, 2), dtype=torch.int32, device="cuda")
    # f32 pages: a prefill chunk, then a fused tick; coded pages: the same
    # and then a one-token chunk (the single-token quantized kernel). The
    # coded pages run on the dequantized weights: both arms then project
    # through the same torch.matmul and quantize identical K/V, where the
    # two spx_matmul arms' last-bit differences would flip codes at level
    # midpoints; what differs is the attention kernels alone
    dense_w = tree_map(lambda _, leaf: leaf.dequantize()
                       if isinstance(leaf, QuantizedTensor) else leaf,
                       eng.params)
    for pools, params, kv_quant, page_size in (
            ("", eng.params, False, eng.page_size),
            ("coded-page (dequantized weights) ", dense_w, True,
             planner.plan_kv_pages(cfg.dh, kv_scheme=KV_SCHEME).page_size)):
        out = {}
        for impl in ("cuda", "ref"):
            rt = Runtime(impl=impl, kv_quant=kv_quant, kv_scheme=KV_SCHEME)
            caches = lm_mod.paged_init_caches(cfg, n_pages, page_size,
                                              dtype=torch.float32,
                                              kv_quant=kv_quant,
                                              device="cuda")
            pre, caches = lm_mod.lm_paged_step(params, tokens, ctx0, bt,
                                               nv, sidx, caches, cfg, rt)
            nxt = pre.argmax(-1)[:, None]
            fused, caches = lm_mod.lm_paged_fused_step(
                params, nxt, nv, bt, act, sidx, caches, cfg, rt)
            out[impl] = [pre, fused]
            if kv_quant:
                one, _ = lm_mod.lm_paged_step(
                    params, fused.argmax(-1), nv + act, bt, act, sidx,
                    caches, cfg, rt)
                out[impl].append(one)
        torch.cuda.synchronize()
        for i, name in enumerate(("prefill_chunk", "fused_tick",
                                  "one_token_chunk")[:len(out["cuda"])]):
            _close(torch, pools + name, out["cuda"][i], out["ref"][i])
    del dense_w, out
    torch.cuda.empty_cache()

    # the dense layout: one whole-prompt prefill through the flash kernel
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 33)),
                             device="cuda")
    out = {}
    for impl in ("cuda", "ref"):
        caches = lm_mod.init_caches(cfg, 1, 64, dtype=torch.float32,
                                    device="cuda")
        out[impl], _ = lm_mod.lm_prefill(eng.params, prompt, caches, cfg,
                                         Runtime(impl=impl))
    torch.cuda.synchronize()
    _close(torch, "dense prefill (33 tokens)", out["cuda"], out["ref"])

    pinned = dataclasses.replace(reduced(get_config("gemma-2b"), vocab=32),
                                 head_dim=128)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = lm_init(gen, pinned, device="cuda")
    prng = np.random.default_rng(3)
    prompts = [prng.integers(0, pinned.vocab_size, n).astype(np.int32)
               for n in (33, 1, 12, 20, 5)]
    for path, layout, kv_quant in (("paged", "paged", False),
                                   ("quant", "paged", True),
                                   ("dense", "dense", False)):
        tokens_by_impl = {}
        for impl in ("cuda", "ref"):
            e = ServeEngine(params, pinned,
                            ServeConfig(batch_slots=2, max_seq=64,
                                        kv_layout=layout),
                            rt=Runtime(impl=impl, kv_quant=kv_quant,
                                       kv_scheme=KV_SCHEME))
            for i, p in enumerate(prompts):
                e.submit(Request(rid=i, prompt=p, max_new_tokens=8))
            tokens_by_impl[impl] = {r.rid: r.output for r in e.run()}
        same = tokens_by_impl["cuda"] == tokens_by_impl["ref"]
        emit({"phase": "e2e", "what": f"pinned config greedy tokens, {path} "
              "path, kernels vs plain versions",
              "tokens": tokens_by_impl["cuda"], "identical": same})
        require(same, f"pinned {path} greedy tokens differ: {tokens_by_impl}")
    # bf16 caches: the kernels round probabilities to bf16, the plain
    # versions do not, so a difference is allowed at a near-tie
    for path, knobs in (("paged-bf16", {}),
                        ("unfused-bf16", dict(fused_decode=False)),
                        ("dense-bf16", dict(kv_layout="dense"))):
        tokens_by_impl, gaps = {}, None
        for impl in ("cuda", "ref"):
            e = ServeEngine(params, pinned,
                            ServeConfig(batch_slots=2, max_seq=64,
                                        kv_cache_dtype="bfloat16", **knobs),
                            rt=Runtime(impl=impl))
            if impl == "ref":
                gaps = _record_gaps(np, e, BF16_E2E_RTOL)
            for i, p in enumerate(prompts):
                e.submit(Request(rid=i, prompt=p, max_new_tokens=8))
            tokens_by_impl[impl] = {r.rid: list(r.output) for r in e.run()}
        check = _near_tie_check(f"pinned {path}", tokens_by_impl["cuda"],
                                tokens_by_impl["ref"], gaps)
        emit({"phase": "e2e", "what": f"pinned config greedy tokens, {path} "
              "path, kernels vs plain versions",
              "tokens": tokens_by_impl["cuda"], **check})
    _pinned_modes(np, pinned, params, prompts)


def _pinned_modes(np, pinned, params, prompts) -> None:
    """The unfused tick, speculative decoding (fused and unfused) and the
    prefix cache on the pinned config: kernels against plain versions give
    identical greedy tokens, and each mode gives the plain paged engine's
    tokens on the same requests; speculation takes fewer model calls with
    some drafts accepted, the prefix cache hits and copies on write."""
    from repro_torch.runtime import Runtime
    from repro_torch.serving import Request, ServeConfig, ServeEngine

    def serve(sc, ps, impl):
        e = ServeEngine(params, pinned, sc, rt=Runtime(impl=impl))
        for i, p in enumerate(ps):
            e.submit(Request(rid=i, prompt=p, max_new_tokens=8))
        tokens = {r.rid: list(r.output) for r in e.run()}
        return tokens, e.metrics()

    tiled = _tiled_prompts(np, pinned.vocab_size, motif=4)
    shared = _shared_prompts(np, pinned.vocab_size)
    base = dict(batch_slots=2, max_seq=128)
    plain_paged = {"mixed": serve(ServeConfig(**base), prompts, "cuda"),
                   "tiled": serve(ServeConfig(**base), tiled, "cuda"),
                   "shared": serve(ServeConfig(**base), shared, "cuda")}
    for path, knobs, which, ps in (
            ("unfused", dict(fused_decode=False), "mixed", prompts),
            ("spec", dict(spec_k=4), "tiled", tiled),
            ("spec unfused", dict(spec_k=4, fused_decode=False), "tiled",
             tiled),
            ("prefix", dict(prefix_cache=True), "shared", shared)):
        sc = ServeConfig(**base, **knobs)
        (got, m), (plain, _) = serve(sc, ps, "cuda"), serve(sc, ps, "ref")
        want, m_paged = plain_paged[which]
        same = got == plain
        same_as_paged = got == want
        extra = {}
        if path.startswith("spec"):
            extra = {"draft_acceptance_rate": m["draft_acceptance_rate"],
                     "model_calls": m["model_calls"],
                     "paged_model_calls": m_paged["model_calls"]}
        if path == "prefix":
            extra = {"prefix_hits": m["prefix_hits"],
                     "cow_copies": m["cow_copies"],
                     "prefill_tokens_skipped": m["prefill_tokens_skipped"]}
        emit({"phase": "e2e", "what": f"pinned config greedy tokens, {path} "
              "path, kernels vs plain versions and vs the paged engine",
              "config": repr(knobs), "tokens": got, "identical": same,
              "identical_to_paged": same_as_paged, **extra})
        require(same, f"pinned {path} greedy tokens differ: {got} {plain}")
        require(same_as_paged, f"pinned {path} tokens differ from the paged "
                               f"engine's: {got} {want}")
        if path.startswith("spec"):
            require(m["draft_acceptance_rate"] > 0
                    and m["model_calls"] < m_paged["model_calls"],
                    f"pinned {path}: {extra}")
        if path == "prefix":
            require(m["prefix_hits"] >= 1 and m["cow_copies"] >= 1,
                    f"pinned prefix: {extra}")


# -- phases 7 and 8 ------------------------------------------------------------

def _time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_events(torch, fn, host_ops: bool = True):
    """(device kernel events, host wall seconds) of one ``fn()`` run under
    ``torch.profiler`` (``host_ops`` False: the device activity alone,
    for a run of tens of thousands of host ops)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if host_ops:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return evs, wall


def _kernels_per_call(torch, fn, calls: int, reps: int = 5):
    """Device kernels of any name per call of ``fn`` (which makes
    ``calls`` calls), and their names: the profiler can drop kernel events
    from a window (in a long process it has lost 2 of 90), and a window
    that lost some sees a fraction of a kernel a call; so windows of
    ``reps`` runs are traced until one sees a whole number a call (at
    most six), and the one that saw the most is kept."""
    fn()
    best, names = 0, set()
    for _ in range(6):
        evs, _ = _device_events(torch, lambda: [fn() for _ in range(reps)])
        if len(evs) > best:
            best = len(evs)
            names = {e.name.replace("(anonymous namespace)::", "")
                     .removeprefix("void ").split("<")[0].split("(")[0][-48:]
                     for e in evs}
        if best and best % (reps * calls) == 0:
            break
    if not best and reps < 50:
        # a window of a few microsecond launches can come back empty
        return _kernels_per_call(torch, fn, calls, reps=10 * reps)
    return best / (reps * calls), sorted(names)


def _device_ms(torch, fn, names: tuple, reps: int = 5):
    """Device time of the kernels whose names contain one of ``names``,
    per ``fn()`` call; None when the profiler saw no device time. The
    profiler can drop kernel events from a window, so the window is
    traced until two traces see the same number of matching kernels (at
    most three times), and the trace that saw the most is kept."""
    fn()
    best, counts = (0, 0.0), []
    for _ in range(3):
        evs, _ = _device_events(torch, lambda: [fn() for _ in range(reps)])
        hit = [e.time_range.elapsed_us() for e in evs
               if any(n in e.name for n in names)]
        best = max(best, (len(hit), sum(hit)))
        if len(hit) in counts:
            break
        counts.append(len(hit))
    if not best[1] and reps < 50:
        # a window of a few microsecond launches can come back empty:
        # once more over ten times the launches
        return _device_ms(torch, fn, names, reps=10 * reps)
    return best[1] / 1e3 / reps if best[1] else None


def _busy_us(evs) -> float:
    """The union of the device kernel events' intervals, microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def trace_phase(torch, np, eng) -> dict:
    """Device busy share and kernel time by name over a serving run of 4
    requests, traced with torch.profiler."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(2)
    base = 1000

    def serve():
        for i in range(4):
            eng.submit(Request(rid=base + i, max_new_tokens=NEW_TOKENS,
                               prompt=rng.integers(0, eng.cfg.vocab_size,
                                                   24).astype(np.int32)))
        eng.run()

    evs, wall = _device_events(torch, serve)
    busy = _busy_us(evs)
    by_name: dict[str, float] = {}
    for e in evs:
        key = e.name.replace("(anonymous namespace)::", "")
        key = key.removeprefix("void ").split("<")[0].split("(")[0][:60]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
    out = {"phase": "trace", "requests": 4, "new_tokens": NEW_TOKENS,
           "prompt_len": 24, "wall_ms": wall * 1e3,
           "device_busy_ms": busy / 1e3 if evs else None,
           "device_idle_share": 1 - busy / 1e3 / (wall * 1e3)
           if evs else None,
           "device_ms_by_kernel": top}
    emit(out)
    return out


def _bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take for the work: the bytes over the
    HBM rate or the flops over one bf16 tensor-core pass, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_TC_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _f32_bound_ms(nbytes: float, flops: float) -> float:
    """The same work's bound at the f32 FMA rate outside the tensor cores."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3


def timing_phase(torch, np, eng, launches, new_launches, worst,
                 mlp, families, whisper, training, sharded, mesh) -> list:
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_decode_ragged_cuda)
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda

    cfg = eng.cfg
    m = eng.batch_slots                          # decode rows per tick
    layers = [dict(_layer_weights(eng.params, i))
              for i in range(cfg.n_periods)]
    gen = torch.Generator(device="cuda").manual_seed(5)
    xs = {k: torch.randn((m, k), generator=gen, device="cuda")
          for k in {qt.logical_shape[0] for qt in layers[0].values()}}
    lut = eng.params["stack"]["slots"][0]["mlp"]["up"]["w"].lut()

    def spx_tick(impl):
        for lw in layers:
            for qt in lw.values():
                k, n = qt.logical_shape
                sc = qt.scale.reshape(1, n)
                if impl == "cuda":
                    spx_matmul_cuda(xs[k], qt.codes, sc, lut, packed=True)
                else:
                    ref.spx_matmul_ref(xs[k], qt.codes, sc, lut, packed=True)

    dense = [{name: qt.dequantize() for name, qt in lw.items()}
             for lw in layers]

    def spx_library():
        for lw in dense:
            for w in lw.values():
                torch.matmul(xs[w.shape[0]], w)

    nbytes = flops = 0
    for lw in layers:
        for qt in lw.values():
            k, n = qt.logical_shape
            nbytes += m * k * 4 + k * n // 2 + n * 4 + 16 * 4 + m * n * 4
            flops += 2 * m * k * n
    spx = {"name": "spx_matmul",
           "per": f"decode tick: {7 * cfg.n_layers} launches, M={m}",
           "ms": _time_ms(torch, lambda: spx_tick("cuda")),
           "plain_ms": _time_ms(torch, lambda: spx_tick("ref"), reps=3),
           "library_ms": _time_ms(torch, spx_library),
           "library_call": "torch.matmul on pre-dequantized f32 weights"}
    spx["bound_ms"], spx["bound_by"] = _bound_ms(nbytes, flops)
    spx["f32_bound_ms"] = _f32_bound_ms(nbytes, flops)
    spx["device_ms"] = _device_ms(torch, lambda: spx_tick("cuda"),
                                  ("spx_matmul_kernel",))
    spx["library_device_ms"] = _device_ms(torch, spx_library, ("",))
    # the prefill kernel (M > 8, tensor cores) per prefill tick: M = slots x
    # chunk = 128 rows (the default engine), 256 (8 slots), 2048 (one long
    # dense prompt)
    spx["prefill_by_M"] = {}
    for m_pre in (128, 256, 2048):
        xs_pre = {k: torch.randn((m_pre, k), generator=gen, device="cuda")
                  for k in xs}
        pre_bytes = pre_flops = 0
        for lw in layers:
            for qt in lw.values():
                k, n = qt.logical_shape
                pre_bytes += m_pre * k * 4 + k * n // 2 + n * 4 + 16 * 4 \
                    + m_pre * n * 4
                pre_flops += 2 * m_pre * k * n

        def spx_prefill():
            for lw in layers:
                for qt in lw.values():
                    k, n = qt.logical_shape
                    spx_matmul_cuda(xs_pre[k], qt.codes,
                                    qt.scale.reshape(1, n), lut, packed=True)

        def spx_prefill_library():
            for lw in dense:
                for w in lw.values():
                    torch.matmul(xs_pre[w.shape[0]], w)

        def spx_prefill_plain():
            for lw in layers:
                for qt in lw.values():
                    k, n = qt.logical_shape
                    ref.spx_matmul_ref(xs_pre[k], qt.codes,
                                       qt.scale.reshape(1, n), lut,
                                       packed=True)

        pre = {"per": f"prefill tick: {7 * cfg.n_layers} launches, "
                      f"M={m_pre}",
               "ms": _time_ms(torch, spx_prefill, reps=3),
               "plain_ms": _time_ms(torch, spx_prefill_plain, reps=1,
                                    warmup=1),
               "device_ms": _device_ms(torch, spx_prefill,
                                       ("spx_matmul_kernel",), reps=3),
               "library_ms": _time_ms(torch, spx_prefill_library, reps=3),
               "library_device_ms": _device_ms(torch, spx_prefill_library,
                                               ("",), reps=3),
               "f32_bound_ms": _f32_bound_ms(pre_bytes, pre_flops)}
        pre["bound_ms"], pre["bound_by"] = _bound_ms(pre_bytes, pre_flops)
        pre["share_of_bound"] = pre["bound_ms"] / pre["device_ms"] \
            if pre["device_ms"] else None
        spx["prefill_by_M"][f"M={m_pre}"] = pre
        del xs_pre

    def one_projection(name):
        for lw in layers:
            qt = lw[name]
            k, n = qt.logical_shape
            spx_matmul_cuda(xs[k], qt.codes, qt.scale.reshape(1, n), lut,
                            packed=True)

    spx["device_ms_by_projection"] = {
        f"{name} {qt.logical_shape[0]}x{qt.logical_shape[1]}": _device_ms(
            torch, lambda name=name: one_projection(name),
            ("spx_matmul_kernel",))
        for name, qt in layers[0].items()}
    del dense
    spx["paper_mlp_by_M"] = _paper_mlp_timing(torch, gen, mlp["params"])
    # the small-layer kernel's row: the paper MLP's forward at M = 1024,
    # every timed forward beside it, and the instance each §4 key runs
    small = dict(spx["paper_mlp_by_M"]["M=1024"], name="spx_matmul_small",
                 by_M=spx["paper_mlp_by_M"], instances=_small_instances(torch))
    # the families' decode ticks, timed in serve_families while each
    # family's weights were on the card
    spx["decode_tick_by_family"] = {
        name: f["timing"]["spx_matmul"] for name, f in families.items()}

    # attention at the decode shapes: 4 slots, gemma-2b heads, pools of
    # every layer, each slot 48 tokens into its sequence
    hkv, rep, dh, ps = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.dh, eng.page_size
    ctx_tokens = 48
    mp = eng.pages_per_seq
    n_pages = m * mp
    pools = [(torch.randn((n_pages, hkv, ps, dh), generator=gen,
                          device="cuda"),
              torch.randn((n_pages, hkv, ps, dh), generator=gen,
                          device="cuda")) for _ in range(cfg.n_layers)]
    bt = torch.arange(n_pages, dtype=torch.int32,
                      device="cuda").reshape(m, mp)
    q = torch.randn((m, hkv, rep, dh), generator=gen, device="cuda")
    ctx = torch.full((m,), ctx_tokens, dtype=torch.int32, device="cuda")
    one = torch.ones((m,), dtype=torch.int32, device="cuda")
    attend = ctx_tokens + 1
    gathered = [(ref._gather(kp, bt)[:, :, :attend].repeat_interleave(rep, 1),
                 ref._gather(vp, bt)[:, :, :attend].repeat_interleave(rep, 1))
                for kp, vp in pools]
    q_sdpa = q.reshape(m, hkv * rep, 1, dh)

    def sdpa_tick():
        for k, v in gathered:
            F.scaled_dot_product_attention(q_sdpa, k, v)

    a_bytes = cfg.n_layers * (m * hkv * attend * dh * 4 * 2
                              + 2 * m * hkv * rep * dh * 4
                              + m * (mp + 2) * 4)
    a_flops = cfg.n_layers * 4 * m * hkv * rep * dh * attend
    a_bound, a_by = _bound_ms(a_bytes, a_flops)
    a_f32 = _f32_bound_ms(a_bytes, a_flops)
    lib_ms = _time_ms(torch, sdpa_tick)
    def ragged_tick():
        for kp, vp in pools:
            paged_decode_ragged_cuda(q, kp, vp, bt, ctx, one, w=1)

    ctx1 = ctx + 1

    def paged_tick():
        for kp, vp in pools:
            paged_attention_cuda(q, kp, vp, bt, ctx1)

    lib_device_ms = _device_ms(torch, sdpa_tick, ("",))
    ragged = {"name": "paged_decode_ragged",
              "per": f"decode tick: {cfg.n_layers} launches, {m} slots, "
                     f"{attend} tokens attended each",
              "ms": _time_ms(torch, ragged_tick),
              "device_ms": _device_ms(torch, ragged_tick, PAGED_KERNELS),
              "plain_ms": _time_ms(torch, lambda: [ref.paged_decode_ragged_ref(
                  q, kp, vp, bt, ctx, one, w=1) for kp, vp in pools]),
              "library_ms": lib_ms, "library_device_ms": lib_device_ms,
              "library_call": "scaled_dot_product_attention over "
                              "pre-gathered K/V",
              "bound_ms": a_bound, "bound_by": a_by, "f32_bound_ms": a_f32}
    paged = {"name": "paged_attention",
             "per": f"one-token prefill tick: {cfg.n_layers} launches, {m} "
                    f"slots, {attend} tokens attended each",
             "ms": _time_ms(torch, paged_tick),
             "device_ms": _device_ms(torch, paged_tick, PAGED_KERNELS),
             "plain_ms": _time_ms(torch, lambda: [ref.paged_attention_ref(
                 q, kp, vp, bt, ctx1) for kp, vp in pools]),
             "library_ms": lib_ms, "library_device_ms": lib_device_ms,
             "library_call": "scaled_dot_product_attention over "
                             "pre-gathered K/V",
             "bound_ms": a_bound, "bound_by": a_by, "f32_bound_ms": a_f32}
    del pools, gathered
    quant, quant_one = _quant_timing(torch, gen, cfg, m, ctx_tokens, q)
    bf16, bf16_one = _half_timing(torch, gen, cfg, m, ctx_tokens, q,
                                  torch.bfloat16)
    f16, f16_one = _half_timing(torch, gen, cfg, m, ctx_tokens, q,
                                torch.float16)
    ragged.update(_long_ctx_timing(torch, gen, cfg, m, quant=False))
    ragged["verify_tick"] = _verify_timing(torch, gen, cfg, eng, m)
    quant.update(_long_ctx_timing(torch, gen, cfg, m, quant=True))
    flash = _flash_timing(torch, gen, cfg)
    flash["long_prompt"] = _flash_timing(torch, gen, cfg, s=LONG_CTX)
    # whisper's shapes and the training step's, timed in their phases
    flash["whisper"] = whisper["timing"]["flash_attention"]
    flash["train_function"] = training["timing"]
    flash["train_mesh"] = training["mesh"]["timing"]
    spx["whisper_encoder_pass"] = whisper["timing"]["spx_matmul"]
    ragged["whisper_decode_tick"] = whisper["timing"]["paged_decode_ragged"]
    # one shard's shapes at shards=2, timed in serve_sharded, with their
    # launches on the fused (kernels 1, 2, 5) or coded-page (3, 6) path
    for entry, timing, path in (
            (spx, sharded["timing"], "fused"),
            (ragged, sharded["timing"], "fused"),
            (paged, sharded["timing"], "fused"),
            (quant, sharded["timing_quant"], "coded-kv"),
            (quant_one, sharded["timing_quant"], "coded-kv")):
        entry[f"shards{SHARDS}"] = dict(
            timing[entry["name"]], path=f"serve_sharded {path}",
            launches=sharded["launches"][f"serve_sharded {path}"].get(
                entry["name"], 0))
    # one shard's kernels of the families, whisper-small and jamba at
    # shards=2, timed in their phases
    shard_families = sharded["families"]
    spx[f"shards{SHARDS}_by_family"] = {
        name: t["spx_matmul"] for name, t in shard_families.items()}
    ragged[f"shards{SHARDS}_by_family"] = {
        name: t["paged_decode_ragged"] for name, t in shard_families.items()
        if "paged_decode_ragged" in t}
    flash[f"shards{SHARDS}_whisper"] = \
        shard_families["whisper-small"]["flash_attention"]
    # the widths refused before (qwen2-vl-2b at 4 shards, whisper-small at
    # 8: one shard of each head-group size), timed in their phases
    wide = dict(sharded["wide"], **{
        f"whisper-small shards={WIDE['whisper-small']} {k}": t
        for k, t in whisper["wide"]["timing"].items()})
    spx["wide"] = {k: t["spx_matmul"] for k, t in wide.items()}
    ragged["wide"] = {k: t["paged_decode_ragged"] for k, t in wide.items()}
    flash["wide_whisper"] = {k: t["flash_attention"] for k, t in wide.items()
                             if "flash_attention" in t}
    # the context-parallel prefill's shards (serve_mesh): 128 rows of
    # gemma-2b's 8 query heads over the 512 gathered keys of its one KV
    # head, at the first and the last shard's causal offset
    rows = MESH_SEQ // MESH[1]
    flash["context_parallel"] = {
        f"q_offset={off}": _flash_shape_timing(
            torch, gen, b=MESH_BATCH // MESH[0], hq=cfg.n_heads,
            hkv=cfg.n_kv_heads, sq=rows, skv=MESH_SEQ, dh=cfg.dh,
            causal=True, layers=cfg.n_layers, q_offset=off,
            per=f"one context-parallel shard's prefill: {cfg.n_layers} "
                f"launches, {MESH_BATCH // MESH[0]} rows x {rows} queries "
                f"at offset {off} over {MESH_SEQ} keys")
        for off in (_cp_offsets()[0], _cp_offsets()[-1])}
    flash["whisper_context_parallel"] = _whisper_cp_flash_timing(
        torch, gen, mesh["whisper-small prefill-cp"]["launches_by_shape"])
    _emit_splits(torch, cfg, m, eng, layers)
    src = "src/repro_torch/kernels/csrc/"
    meta = {
        "spx_matmul": (src + "spx_matmul.cu",
                       "src/repro/kernels/spx_matmul.py:77"),
        "spx_matmul_small": (src + "spx_matmul.cu",
                             "src/repro/kernels/spx_matmul.py:77"),
        "paged_decode_ragged": (src + "paged_decode.cu",
                                "src/repro/kernels/paged_attention.py:247"),
        "paged_attention": (src + "paged_decode.cu",
                            "src/repro/kernels/paged_attention.py:354"),
        "paged_decode_ragged_quant": (
            src + "paged_decode.cu",
            "src/repro/kernels/paged_attention.py:298"),
        "flash_attention": (src + "flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:72"),
        "paged_attention_quant": (
            src + "paged_decode.cu",
            "src/repro/kernels/paged_attention.py:396"),
        "paged_decode_ragged_bf16": (
            src + "paged_decode.cu",
            "src/repro/kernels/paged_attention.py:247"),
        "paged_attention_bf16": (
            src + "paged_decode.cu",
            "src/repro/kernels/paged_attention.py:354"),
        "paged_decode_ragged_f16": (
            src + "paged_decode.cu",
            "src/repro/kernels/paged_attention.py:247"),
        "paged_attention_f16": (
            src + "paged_decode.cu",
            "src/repro/kernels/paged_attention.py:354"),
    }
    path_launches = {"spx_matmul_small": mlp["experiments"],
                     "paged_decode_ragged_quant": new_launches["quant"],
                     "paged_attention_quant": new_launches["quant"],
                     "flash_attention": new_launches["dense"],
                     "paged_decode_ragged_bf16": new_launches["paged-bf16"],
                     "paged_attention_bf16": new_launches["paged-bf16"],
                     "paged_decode_ragged_f16": new_launches["paged-f16"],
                     "paged_attention_f16": new_launches["paged-f16"]}
    # every serving path's run, the paper MLP's forward and the §4
    # experiments (counts set to 0 before each and read after it)
    by_path = {"paged": launches, **new_launches,
               "paper_mlp": {"spx_matmul": mlp["launches"],
                             "spx_matmul_small": mlp["small_launches"]},
               "paper_experiments": mlp["experiments"],
               **{f"serve_families {name}": f["launches"]
                  for name, f in families.items()},
               "serve_whisper": whisper["launches"],
               "serve_whisper dense": whisper["dense_launches"],

               **{f"train {run}": n
                  for run, n in training["launches"].items()},
               **training["mesh"]["launches"]}
    rows = []
    for entry in (spx, small, ragged, paged, quant, flash, quant_one, bf16,
                  bf16_one, f16, f16_one):
        name = entry["name"]
        source, replaces = meta[name]
        entry.update(route="cuda", source=source, replaces=replaces,
                     launches=path_launches.get(name, launches).get(name, 0),
                     launches_by_path={p: n[name] for p, n in by_path.items()
                                       if n.get(name)},
                     max_abs_err=worst[name],
                     share_of_bound=entry["bound_ms"] / entry["device_ms"]
                     if entry["device_ms"] else None)
        rows.append(entry)
    return rows


def _paper_mlp_timing(torch, gen, qparams) -> dict:
    """``spx_matmul`` over the paper MLP's two quantized layers, (784, 128)
    then (128, 10), at M = 1, 64 and 1024 rows, and over the Q-network's,
    (4, 64) then (64, 64) (sp2_4 codes from a seed), at M = 1, beside
    ``torch.matmul`` on the dequantized weights, the two bounds and each
    forward's kernel launches."""
    from repro_torch.core.quantized import quantize_weight
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda
    mlp = [qparams[f"l{i}"]["w"] for i in range(2)]
    qnet = [quantize_weight(torch.randn(shape, generator=gen, device="cuda")
                            * shape[0] ** -0.5, "sp2_4")
            for shape in ((4, 64), (64, 64))]
    out = {}
    for name, m, qts in (("M=1", 1, mlp), ("M=64", 64, mlp),
                         ("M=1024", 1024, mlp), ("Q-network M=1", 1, qnet)):
        dense = [qt.dequantize() for qt in qts]
        lut = qts[0].lut()
        xs = [torch.rand((m, qt.logical_shape[0]), generator=gen,
                         device="cuda") for qt in qts]

        def kernel(fn=spx_matmul_cuda):
            for x, qt in zip(xs, qts):
                fn(x, qt.codes, qt.scale.reshape(1, qt.logical_shape[1]),
                   lut, packed=qt.packed)

        def library():
            for x, w in zip(xs, dense):
                torch.matmul(x, w)

        nbytes = flops = 0
        for qt in qts:
            k, n = qt.logical_shape
            nbytes += m * k * 4 + qt.codes.numel() + n * 4 + 16 * 4 \
                + m * n * 4
            flops += 2 * m * k * n
        ops.reset_op_calls()
        kernel()
        torch.cuda.synchronize()
        shapes = " and ".join(str(qt.logical_shape) for qt in qts)
        row = {"per": f"forward: 2 launches, M={m}, (K, N) = {shapes}",
               "launches": ops.path_calls(),
               "ms": _time_ms(torch, kernel, reps=50, warmup=5),
               "device_ms": _device_ms(torch, kernel, ("spx_matmul_kernel",),
                                       reps=20),
               "plain_ms": _time_ms(torch, lambda: kernel(ref.spx_matmul_ref),
                                    reps=10),
               "library_ms": _time_ms(torch, library, reps=50, warmup=5),
               "library_device_ms": _device_ms(torch, library, ("",),
                                               reps=20),
               "f32_bound_ms": _f32_bound_ms(nbytes, flops)}
        row["bound_ms"], row["bound_by"] = _bound_ms(nbytes, flops)
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"] \
            if row["device_ms"] else None
        require(row["launches"] == {"spx_matmul_small": 2},
                f"paper_mlp_by_M {name}: kernels {row['launches']}")
        out[name] = row
        del dense
    ops.reset_op_calls()
    return out


def _small_instances(torch) -> dict:
    """The small-layer kernel's instance (tile rows, tile columns, 4-bit
    packed codes) and warps at each §4 launch key, as the planner picks
    them on this card."""
    from repro_torch.runtime import planner
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for _, packed, lut, m, k, n in sorted(PAPER_SPX_KEYS):
        p = planner.plan_spx_launch(m, k, n, packed, lut, sms)
        out[f"{'packed' if packed else 'unpacked'} lut {lut}, M={m}, "
            f"K={k}, N={n}"] = (f"spx_matmul_kernel_small<{p.tile_m // 8}, "
                                f"{p.tile_n // 16}, {str(packed).lower()}>, "
                                f"{p.warps} warps")
    return out


def _verify_timing(torch, gen, cfg, eng, m) -> dict:
    """Kernel 2 per speculative verify tick: ``m`` slots, a window of W = 5
    rows each, 44 tokens in the pages before it (49 attended by the last
    row), every layer's f32 pools; SDPA over the same K/V, pre-gathered,
    with the window's causal mask as the library call."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode_ragged_cuda

    hkv, rep, dh, ps = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.dh, eng.page_size
    w, ctx_tokens = 5, 44
    mp = eng.pages_per_seq
    n_pages = m * mp
    attend = ctx_tokens + w
    pools = [_rand_pools(torch, gen, n_pages, hkv, ps, dh)
             for _ in range(cfg.n_layers)]
    bt = torch.arange(n_pages, dtype=torch.int32,
                      device="cuda").reshape(m, mp)
    q = torch.randn((m, hkv, rep * w, dh), generator=gen, device="cuda")
    ctx = torch.full((m,), ctx_tokens, dtype=torch.int32, device="cuda")
    qn = torch.full((m,), w, dtype=torch.int32, device="cuda")

    def tick():
        for kp, vp in pools:
            paged_decode_ragged_cuda(q, kp, vp, bt, ctx, qn, w=w)

    # SDPA: (B, Hq, W, dh) queries, row i of each head attends <= ctx + i
    q_sdpa = q.reshape(m, hkv, rep, w, dh).reshape(m, hkv * rep, w, dh)
    gathered = [(ref._gather(kp, bt)[:, :, :attend].repeat_interleave(rep, 1),
                 ref._gather(vp, bt)[:, :, :attend].repeat_interleave(rep, 1))
                for kp, vp in pools]
    mask = (torch.arange(attend, device="cuda")[None, :]
            <= ctx_tokens + torch.arange(w, device="cuda")[:, None])

    def library():
        for k, v in gathered:
            F.scaled_dot_product_attention(q_sdpa, k, v, attn_mask=mask)

    nbytes = cfg.n_layers * (m * hkv * attend * dh * 4 * 2
                             + 2 * m * hkv * rep * w * dh * 4
                             + m * (mp + 2) * 4)
    flops = cfg.n_layers * 4 * m * hkv * rep * dh * sum(
        ctx_tokens + i + 1 for i in range(w))
    bound, by = _bound_ms(nbytes, flops)
    device_ms = _device_ms(torch, tick, PAGED_KERNELS)
    out = {"per": f"verify tick: {cfg.n_layers} launches, {m} slots, W = {w}, "
                  f"{attend} tokens attended by the last row",
           "ms": _time_ms(torch, tick),
           "device_ms": device_ms,
           "plain_ms": _time_ms(torch, lambda: [ref.paged_decode_ragged_ref(
               q, kp, vp, bt, ctx, qn, w=w) for kp, vp in pools]),
           "library_ms": _time_ms(torch, library),
           "library_device_ms": _device_ms(torch, library, ("",)),
           "library_call": "scaled_dot_product_attention over pre-gathered "
                           "K/V with the window's causal mask",
           "bound_ms": bound, "bound_by": by,
           "f32_bound_ms": _f32_bound_ms(nbytes, flops),
           "share_of_bound": bound / device_ms if device_ms else None}
    del pools, gathered
    return out


def _quant_timing(torch, gen, cfg, m, ctx_tokens, q):
    """Kernels 3 and 6 per tick at the decode shapes of the coded-page
    path: ``m`` slots, every layer's code + scale pools, each slot
    ``ctx_tokens`` into its sequence. The library call is SDPA over the
    same K/V, pre-dequantized and pre-gathered."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (
        paged_attention_quant_cuda, paged_decode_ragged_quant_cuda)
    from repro_torch.nn.attention import kv_lut, quantize_kv
    from repro_torch.runtime import planner

    hkv, rep, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.dh
    ps = planner.plan_kv_pages(dh, kv_scheme=KV_SCHEME).page_size
    mp = -(-256 // ps)                           # ServeConfig().max_seq
    n_pages = m * mp
    lut = kv_lut(KV_SCHEME, "cuda")
    pools = []
    for _ in range(cfg.n_layers):
        kc, ks = quantize_kv(torch.randn((n_pages, hkv, ps, dh),
                                         generator=gen, device="cuda"),
                             KV_SCHEME)
        vc, vs = quantize_kv(torch.randn((n_pages, hkv, ps, dh),
                                         generator=gen, device="cuda"),
                             KV_SCHEME)
        pools.append((kc, ks, vc, vs))
    bt = torch.arange(n_pages, dtype=torch.int32,
                      device="cuda").reshape(m, mp)
    ctx = torch.full((m,), ctx_tokens, dtype=torch.int32, device="cuda")
    one = torch.ones((m,), dtype=torch.int32, device="cuda")
    ctx1 = ctx + 1
    attend = ctx_tokens + 1
    # codes 1 byte and one f32 scale per attended token and side, q in,
    # out, tables and the LUT
    nbytes = cfg.n_layers * (m * hkv * attend * 2 * (dh + 4)
                             + 2 * m * hkv * rep * dh * 4
                             + m * (mp + 2) * 4 + lut.numel() * 4)
    flops = cfg.n_layers * 4 * m * hkv * rep * dh * attend
    bound, by = _bound_ms(nbytes, flops)

    def ragged(impl):
        for kc, ks, vc, vs in pools:
            if impl == "cuda":
                paged_decode_ragged_quant_cuda(q, kc, ks, vc, vs, bt, ctx,
                                               one, lut, w=1)
            else:
                ref.paged_decode_ragged_quant_ref(q, kc, ks, vc, vs, bt, ctx,
                                                  one, lut, w=1)

    def single(impl):
        for kc, ks, vc, vs in pools:
            if impl == "cuda":
                paged_attention_quant_cuda(q, kc, ks, vc, vs, bt, ctx1, lut)
            else:
                ref.paged_attention_quant_ref(q, kc, ks, vc, vs, bt, ctx1,
                                              lut)

    gathered = [
        tuple(ref._gather_dequant(c, sc, bt, lut)[:, :, :attend]
              .repeat_interleave(rep, 1) for c, sc in ((kc, ks), (vc, vs)))
        for kc, ks, vc, vs in pools]
    q_sdpa = q.reshape(m, hkv * rep, 1, dh)

    def sdpa_tick():
        for k, v in gathered:
            F.scaled_dot_product_attention(q_sdpa, k, v)

    lib = {"library_ms": _time_ms(torch, sdpa_tick),
           "library_device_ms": _device_ms(torch, sdpa_tick, ("",)),
           "library_call": "scaled_dot_product_attention over "
                           "pre-dequantized, pre-gathered K/V",
           "bound_ms": bound, "bound_by": by,
           "f32_bound_ms": _f32_bound_ms(nbytes, flops)}
    rows = []
    for name, fn, per in (
            ("paged_decode_ragged_quant", ragged, "decode tick"),
            ("paged_attention_quant", single, "one-token prefill tick")):
        rows.append({"name": name,
                     "per": f"{per}: {cfg.n_layers} launches, {m} slots, "
                            f"{attend} tokens attended each, {KV_SCHEME} "
                            f"codes, page size {ps}",
                     "ms": _time_ms(torch, lambda fn=fn: fn("cuda")),
                     "device_ms": _device_ms(torch, lambda fn=fn: fn("cuda"),
                                             PAGED_KERNELS),
                     "plain_ms": _time_ms(torch, lambda fn=fn: fn("ref")),
                     **lib})
    return rows


def _half_timing(torch, gen, cfg, m, ctx_tokens, q, dtype):
    """Kernels 2 and 5 over bf16 or f16 pages (``dtype``) per tick at the
    decode shapes of that path: ``m`` slots, every layer's pools at the
    half-width page size, each slot ``ctx_tokens`` into its sequence;
    kernel 2 also at ``m`` slots x ``LONG_CTX`` tokens. The library call
    is SDPA over the same K/V, pre-gathered, with q cast to ``dtype``. The
    byte bound counts half the f32 rows' K/V bytes. The profiler's device
    kernels per call of each wrapper at the decode tick must be one (the
    tensor-core kernel merges its cluster in the same launch)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (
        cluster_used, decode_cluster, paged_attention_cuda,
        paged_decode_ragged_cuda)
    from repro_torch.runtime import planner

    hkv, rep, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.dh
    ps = planner.plan_kv_pages(dh, act_bytes=2).page_size
    name = str(dtype).removeprefix("torch.")
    suffix = HALF_PAGES[name][0]
    rows = []
    for tokens in (ctx_tokens + 1, LONG_CTX):
        mp = -(-max(tokens, 256) // ps)          # ServeConfig().max_seq
        n_pages = m * mp
        pools = [tuple(t.to(dtype) for t in
                       _rand_pools(torch, gen, n_pages, hkv, ps, dh))
                 for _ in range(cfg.n_layers)]
        bt = torch.arange(n_pages, dtype=torch.int32,
                          device="cuda").reshape(m, mp)
        ctx = torch.full((m,), tokens - 1, dtype=torch.int32, device="cuda")
        one = torch.ones((m,), dtype=torch.int32, device="cuda")
        ctx1 = ctx + 1

        def ragged(impl):
            for kp, vp in pools:
                if impl == "cuda":
                    paged_decode_ragged_cuda(q, kp, vp, bt, ctx, one, w=1)
                else:
                    ref.paged_decode_ragged_ref(q, kp, vp, bt, ctx, one, w=1)

        def single(impl):
            for kp, vp in pools:
                if impl == "cuda":
                    paged_attention_cuda(q, kp, vp, bt, ctx1)
                else:
                    ref.paged_attention_ref(q, kp, vp, bt, ctx1)

        gathered = [tuple(ref._gather(p, bt)[:, :, :tokens]
                          .repeat_interleave(rep, 1) for p in pair)
                    for pair in pools]
        q_sdpa = q.reshape(m, hkv * rep, 1, dh).to(dtype)

        def sdpa_tick():
            for k, v in gathered:
                F.scaled_dot_product_attention(q_sdpa, k, v)

        # half-width K and V of every attended token, q in and out f32,
        # tables
        nbytes = cfg.n_layers * (m * hkv * tokens * dh * 2 * 2
                                 + 2 * m * hkv * rep * dh * 4
                                 + m * (mp + 2) * 4)
        flops = cfg.n_layers * 4 * m * hkv * rep * dh * tokens
        bound, by = _bound_ms(nbytes, flops)
        if tokens == LONG_CTX:
            dev = _device_ms(torch, lambda: ragged("cuda"), PAGED_KERNELS)
            rows[0].update({
                "long_ctx_per": f"decode tick: {cfg.n_layers} launches, "
                                f"{m} slots, {LONG_CTX} tokens attended "
                                f"each, {name} pages of {ps}",
                "long_ctx_device_ms": dev,
                "long_ctx_ms": _time_ms(torch, lambda: ragged("cuda")),
                "long_ctx_plain_ms": _time_ms(torch, lambda: ragged("ref"),
                                              reps=3),
                "long_ctx_library_ms": _time_ms(torch, sdpa_tick),
                "long_ctx_bound_ms": bound,
                "long_ctx_bound_by": by,
                "long_ctx_f32_bound_ms": _f32_bound_ms(nbytes, flops),
                "long_ctx_library_device_ms": _device_ms(torch, sdpa_tick,
                                                         ("",)),
                "long_ctx_share_of_bound": bound / dev if dev else None,
                "long_ctx_cluster": cluster_used(dtype, dh, decode_cluster(
                    m, hkv, rep, mp, ps, torch.cuda.get_device_properties(
                        0).multi_processor_count))})
        else:
            lib_per_call, lib_names = _kernels_per_call(
                torch, sdpa_tick, cfg.n_layers)
            lib = {"library_ms": _time_ms(torch, sdpa_tick),
                   "library_device_ms": _device_ms(torch, sdpa_tick, ("",)),
                   "library_call": "scaled_dot_product_attention over "
                                   f"pre-gathered {name} K/V (q cast to "
                                   f"{name})",
                   "library_kernels_per_call": lib_per_call,
                   "library_kernel_names": lib_names,
                   "bound_ms": bound, "bound_by": by,
                   "f32_bound_ms": _f32_bound_ms(nbytes, flops)}
            cluster = cluster_used(dtype, dh, decode_cluster(
                m, hkv, rep, mp, ps, torch.cuda.get_device_properties(
                    0).multi_processor_count))
            for row, fn, per in (
                    ("paged_decode_ragged" + suffix, ragged, "decode tick"),
                    ("paged_attention" + suffix, single,
                     "one-token prefill tick")):
                per_call, names = _kernels_per_call(
                    torch, lambda fn=fn: fn("cuda"), cfg.n_layers)
                require(per_call == 1, f"{row}: {per_call} device kernels "
                                       "per call")
                rows.append({
                    "name": row,
                    "per": f"{per}: {cfg.n_layers} launches, {m} slots, "
                           f"{tokens} tokens attended each, {name} pages "
                           f"of {ps}",
                    "ms": _time_ms(torch, lambda fn=fn: fn("cuda")),
                    "device_ms": _device_ms(torch, lambda fn=fn: fn("cuda"),
                                            PAGED_KERNELS),
                    "kernels_per_call": per_call, "kernel_names": names,
                    "cluster": cluster,
                    "plain_ms": _time_ms(torch, lambda fn=fn: fn("ref")),
                    **lib})
        del pools, gathered
        torch.cuda.empty_cache()
    return rows


#: kernel names of one paged-decode launch: over f32 and code pages the
#: split kernel and, with several splits, its merge; over bf16 and f16
#: pages the one tensor-core kernel
PAGED_KERNELS = ("paged_decode_kernel", "paged_decode_merge_kernel",
                 "paged_decode_mma_kernel")
#: the long context of the timing phase, tokens per slot
LONG_CTX = 2048


def _long_ctx_timing(torch, gen, cfg, m, *, quant: bool) -> dict:
    """Kernel 2 (f32 pages) or 3 (code pages) per decode tick at ``m``
    slots of ``LONG_CTX`` tokens each, every layer's pools, beside that
    shape's byte bound and SDPA's device time over the same K/V,
    pre-gathered (and pre-dequantized)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (
        paged_decode_ragged_cuda, paged_decode_ragged_quant_cuda)
    from repro_torch.nn.attention import kv_lut, quantize_kv
    from repro_torch.runtime import planner

    hkv, rep, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.dh
    ps = planner.plan_kv_pages(
        dh, kv_scheme=KV_SCHEME if quant else None).page_size
    mp = LONG_CTX // ps
    lut = kv_lut(KV_SCHEME, "cuda")
    bt = torch.arange(m * mp, dtype=torch.int32, device="cuda").reshape(m, mp)
    ctx = torch.full((m,), LONG_CTX - 1, dtype=torch.int32, device="cuda")
    one = torch.ones((m,), dtype=torch.int32, device="cuda")
    q = torch.randn((m, hkv, rep, dh), generator=gen, device="cuda")
    pools = []
    for _ in range(cfg.n_layers):
        k, v = _rand_pools(torch, gen, m * mp, hkv, ps, dh)
        pools.append((*quantize_kv(k, KV_SCHEME), *quantize_kv(v, KV_SCHEME))
                     if quant else (k, v))

    kernel, plain = ((paged_decode_ragged_quant_cuda,
                      ref.paged_decode_ragged_quant_ref) if quant
                     else (paged_decode_ragged_cuda,
                           ref.paged_decode_ragged_ref))
    extra = (lut,) if quant else ()

    def tick(fn=kernel):
        for p in pools:
            fn(q, *p, bt, ctx, one, *extra, w=1)

    token_bytes = 2 * (dh + 4) if quant else 2 * dh * 4
    nbytes = cfg.n_layers * (m * hkv * LONG_CTX * token_bytes
                             + 2 * m * hkv * rep * dh * 4 + m * (mp + 2) * 4
                             + (lut.numel() * 4 if quant else 0))
    flops = cfg.n_layers * 4 * m * hkv * rep * dh * LONG_CTX
    bound, by = _bound_ms(nbytes, flops)
    out = {"long_ctx_per": f"decode tick: {cfg.n_layers} launches, {m} "
                           f"slots, {LONG_CTX} tokens attended each, page "
                           f"size {ps}",
           "long_ctx_device_ms": _device_ms(torch, tick, PAGED_KERNELS),
           "long_ctx_ms": _time_ms(torch, tick),
           "long_ctx_plain_ms": _time_ms(torch, lambda: tick(plain), reps=3),
           "long_ctx_bound_ms": bound, "long_ctx_bound_by": by,
           "long_ctx_f32_bound_ms": _f32_bound_ms(nbytes, flops)}
    q_sdpa = q.reshape(m, hkv * rep, 1, dh)
    gathered = []
    for p in pools:
        if quant:
            k = ref._gather_dequant(p[0], p[1], bt, lut)
            v = ref._gather_dequant(p[2], p[3], bt, lut)
        else:
            k, v = ref._gather(p[0], bt), ref._gather(p[1], bt)
        gathered.append((k.repeat_interleave(rep, 1),
                         v.repeat_interleave(rep, 1)))
    del pools
    out["long_ctx_library_device_ms"] = _device_ms(
        torch, lambda: [F.scaled_dot_product_attention(q_sdpa, k, v)
                        for k, v in gathered], ("",))
    out["long_ctx_library_ms"] = _time_ms(
        torch, lambda: [F.scaled_dot_product_attention(q_sdpa, k, v)
                        for k, v in gathered])
    out["long_ctx_share_of_bound"] = bound / out["long_ctx_device_ms"] \
        if out["long_ctx_device_ms"] else None
    del gathered
    torch.cuda.empty_cache()
    return out


def _emit_splits(torch, cfg, m, eng, layers) -> None:
    """The split counts and the 16-bit kernel's cluster sizes the wrappers
    chose at the timing shapes."""
    from repro_torch.kernels import spx_matmul as spx_mod
    from repro_torch.kernels.paged_attention import (cluster_used,
                                                     decode_cluster,
                                                     decode_splits)
    from repro_torch.runtime import planner

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hkv, rep, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.dh
    qps = planner.plan_kv_pages(dh, kv_scheme=KV_SCHEME).page_size
    paged = {
        f"f32 pages, {eng.pages_per_seq} x {eng.page_size}":
            decode_splits(m, hkv, rep, eng.pages_per_seq, eng.page_size, sms),
        f"code pages, {-(-256 // qps)} x {qps}":
            decode_splits(m, hkv, rep, -(-256 // qps), qps, sms),
        f"f32 pages, {LONG_CTX // eng.page_size} x {eng.page_size}":
            decode_splits(m, hkv, rep, LONG_CTX // eng.page_size,
                          eng.page_size, sms),
        f"code pages, {LONG_CTX // qps} x {qps}":
            decode_splits(m, hkv, rep, LONG_CTX // qps, qps, sms)}
    hps = planner.plan_kv_pages(dh, act_bytes=2).page_size
    half = {f"{dtype} pages, {tokens // hps} x {hps}": cluster_used(
                getattr(torch, dtype), dh, decode_cluster(
                    m, hkv, rep, tokens // hps, hps, sms))
            for dtype in ("bfloat16", "float16") for tokens in (256,
                                                                LONG_CTX)}
    spx_splits = {}
    for name, qt in layers[0].items():
        k, n = qt.logical_shape
        for rows in (m, 128, 256, 2048):
            spx_splits[f"{name} {k}x{n} M={rows}"] = \
                spx_mod.library_splits(rows, k, n, sms)
    emit({"phase": "splits", "sms": sms, "slots": m,
          "paged_decode": paged, "paged_decode_mma_cluster": half,
          "spx_matmul": spx_splits})


def _whisper_cp_flash_timing(torch, gen, by_shape) -> dict:
    """Kernel 4 at the three shapes of one context-parallel shard of
    serve_mesh's whisper-small prefill, 12 launches each (one a layer):
    the encoder's 375 rows over 1500 frames (not causal), the decoder's
    112 rows over the 448 gathered keys at the first and the last causal
    offset, and the cross-attention's 112 rows over 1500 frames; each
    with its launches in that step (``by_shape``, the serve_mesh run's)."""
    cfg = _whisper_config()
    rows, n = MESH_BATCH // MESH[0], MESH[1]
    enc, dec, h, dh = (cfg.enc_seq_len, WHISPER_MESH_PROMPT, cfg.n_heads,
                       cfg.dh)
    counts = {tuple(r[:5]): r[5] for r in by_shape}
    out = {}
    for name, sq, skv, causal, off in (
            ("encoder", enc // n, enc, False, 0),
            ("decoder q_offset=0", dec // n, dec, True, 0),
            (f"decoder q_offset={dec - dec // n}", dec // n, dec, True,
             dec - dec // n),
            ("cross-attention", dec // n, enc, False, 0)):
        row = _flash_shape_timing(
            torch, gen, b=rows, hq=h, hkv=h, sq=sq, skv=skv, dh=dh,
            causal=causal, layers=cfg.n_layers, q_offset=off,
            per=f"whisper-small context-parallel shard, {name}: "
                f"{cfg.n_layers} launches, {rows} rows x {sq} queries over "
                f"{skv} keys, {h} heads of {dh}"
                + (f", causal at offset {off}" if causal else
                   ", not causal"))
        # every offset of a non-causal shape is the same launch
        key = ("flash_attention", (rows, h, sq, dh), (rows, h, skv, dh),
               causal)
        row["launches"] = sum(c for k, c in counts.items()
                              if k[:4] == key and (not causal or k[4] == off))
        out[name] = row
    return out


def _flash_timing(torch, gen, cfg, s: int = 33):
    """Kernel 4 per admitted request of the dense path: one launch per
    layer over the prompt (the 33-token prompt of the serve phase, or a
    long one)."""
    return _flash_shape_timing(
        torch, gen, b=1, hq=cfg.n_heads, hkv=cfg.n_kv_heads, sq=s, skv=s,
        dh=cfg.dh, causal=True, layers=cfg.n_layers,
        per=f"admitted request: {cfg.n_layers} launches, causal prefill of "
            f"{s} tokens, {cfg.n_heads} query heads over {cfg.n_kv_heads} "
            f"KV head(s) of {cfg.dh}")


def _layer_weights(params, i):
    """The seven quantized projections of period ``i``."""
    sp = params["stack"]["slots"][0]
    for name, w in (("wq", sp["attn"]["wq"]["w"]), ("wk", sp["attn"]["wk"]["w"]),
                    ("wv", sp["attn"]["wv"]["w"]), ("wo", sp["attn"]["wo"]["w"]),
                    ("gate", sp["mlp"]["gate"]["w"]),
                    ("up", sp["mlp"]["up"]["w"]),
                    ("down", sp["mlp"]["down"]["w"])):
        yield name, w[i]


def _sass_counts(cuda_lib) -> dict:
    """Warpgroup (HGMMA) and warp (HMMA) tensor-core instructions in each
    built library's SASS, by cuobjdump; the tensor-core kernels
    (spx_matmul's prefill: HGMMA, its small-layer kernel, flash, the
    16-bit paged decode: HMMA) must have them."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    counts = {}
    for name in ("spx_matmul", "flash_attention", "paged_decode"):
        if not tool.exists():
            counts[name] = "cuobjdump not found"
            continue
        sass = subprocess.run(
            [str(tool), "-sass", str(cuda_lib._lib_path(name))],
            capture_output=True, text=True, timeout=300).stdout
        counts[name] = {"HGMMA": sass.count("HGMMA"),
                        "HMMA": sass.count("HMMA")}
    if tool.exists():
        require(counts["spx_matmul"]["HGMMA"] > 0, "spx_matmul has no HGMMA")
        for name in ("spx_matmul", "flash_attention", "paged_decode"):
            require(counts[name]["HMMA"] > 0, f"{name} has no HMMA")
    return counts


# -- driver --------------------------------------------------------------------

def main() -> int:
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    def clock(after: str) -> None:
        """The seconds since the start, after a phase (where a run's time
        goes, against its limit)."""
        emit({"phase": "clock", "after": after,
              "seconds": time.perf_counter() - t_start})

    try:
        info = device_phase(torch)
        from repro_torch.kernels import cuda_lib
        emit({"phase": "build", "seconds": cuda_lib.build_all(),
              "dir": str(cuda_lib.build_dir()),
              "tensor_core_instructions": _sass_counts(cuda_lib)})
        worst, checked = kernel_phase(torch, np)
        for phase in (family_kernel_phase, whisper_kernel_phase,
                      train_kernel_phase, train_mesh_kernel_phase,
                      sharded_kernel_phase, tier_kernel_phase,
                      wide_kernel_phase, mesh_kernel_phase):
            more_worst, more_checked = phase(torch, np)
            for name, err in more_worst.items():
                worst[name] = max(worst[name], err)
            checked |= more_checked
        clock("kernel phases")
        families = serve_families_phase(torch, np, info["nvidia_smi"],
                                        checked)
        # the shards=2 runs of the families, whisper-small and full-width
        # jamba, each beside its shards=1 run
        shard_runs = {name: f.pop("sharded") for name, f in families.items()
                      if "sharded" in f}
        shard_runs["jamba-1.5-large-398b"] = serve_jamba_phase(
            torch, np, info["nvidia_smi"], checked)
        whisper = serve_whisper_phase(torch, np, info["nvidia_smi"], checked)
        shard_runs["whisper-small"] = whisper.pop("sharded")
        clock("serve_families, serve_jamba, serve_whisper")
        training = train_phase(torch, np, info["nvidia_smi"], checked)
        # the train step under a (data, model) mesh: eight devices, the one
        # card listed eight times
        with _forced_shards(MESH[0] * MESH[1]):
            training["mesh"] = train_mesh_phase(torch, np,
                                                info["nvidia_smi"], checked)
        clock("train, train_mesh")
        mlp = paper_mlp_phase(torch, np, info["nvidia_smi"])
        worst["spx_matmul"] = max(worst["spx_matmul"], mlp["max_abs_err"])
        mlp["experiments"] = paper_experiments_phase(
            torch, np, info["nvidia_smi"], checked)
        clock("paper_mlp, paper_experiments")
        eng, launches, paged_m, paged_tokens = serve_phase(torch, np)
        new_launches = serve_new_paths_phase(torch, np, eng.params)
        new_launches.update(serve_modes_phase(torch, np, eng.params,
                                              paged_tokens, paged_m))
        new_launches.update(serve_bf16_phase(torch, np, eng.params,
                                             paged_tokens))
        new_launches.update(serve_f16_phase(torch, np, eng.params))
        # the planner's knobs: measured autotuning and the tile pins
        tuned = autotune_phase(torch, np, eng.params, mlp["params"],
                               info["nvidia_smi"])
        clock("serve, its paths and page dtypes, autotune")
        # two shards on the one card: launch.hostdev lists it twice, for
        # the sharded runs only
        with _forced_shards():
            sharded = serve_sharded_phase(torch, np, eng.params,
                                          info["nvidia_smi"], checked)
        new_launches.update(sharded["launches"])
        new_launches.update({f"serve_sharded {name}": run["launches"]
                             for name, run in shard_runs.items()})
        new_launches[f"serve_wide whisper-small shards="
                     f"{WIDE['whisper-small']}"] = whisper["wide"]["launches"]
        # the serve steps under a (data, model) mesh: eight devices, the
        # one card listed eight times
        with _forced_shards(MESH[0] * MESH[1]):
            mesh = serve_mesh_phase(torch, np, eng.params,
                                    info["nvidia_smi"], checked)
        new_launches.update(mesh["launches"])
        clock("serve_sharded, serve_mesh")
        # the dry run of the same mesh steps on meta, held to the card's
        dryrun_phase(torch, training["mesh"], mesh, info["nvidia_smi"])
        sharded["families"] = {name: run["timing"]
                               for name, run in shard_runs.items()}
        new_launches["router"] = router_phase(torch, np, eng.params,
                                              paged_tokens,
                                              info["nvidia_smi"], checked)
        new_launches.update(serve_cli_phase(torch, np, info["nvidia_smi"],
                                            checked))
        e2e_phase(torch, np, eng)
        trace_phase(torch, np, eng)
        clock("dryrun, router, serve_cli, e2e, trace")
        rows = timing_phase(torch, np, eng, launches, new_launches, worst,
                            mlp, families, whisper, training, sharded, mesh)
        for row in rows:
            row.update(tuned.get(row["name"], {}))
    except Failed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(info["nvidia_smi"])
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
