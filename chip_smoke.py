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
              and 64, the ragged decode kernel at a w = 5 verify window
              that crosses a page boundary, kernels 2 and 5 over bf16 pages
              (page sizes 32 and 16, up to 2048 tokens, each slot within
              BF16_ATTN_RTOL of its own peak), flash attention up to 2048
              tokens; second launches bit-identical;
  4. paper_mlp the paper's 784-128-10 sigmoid MLP (§4.1), random weights
              from a seed quantized to sp2_4, on 1024 procedural digits:
              two spx_matmul launches per forward, outputs against the
              plain version, time per sample at batch 1, 64 and 1024 for
              the sp2_4 and the f32 torch.matmul arm;
     paper_experiments  the paper's §4 through the port's entry points:
              ``examples.quickstart`` (4 epochs of SGD, then test accuracy
              per scheme, held to tests/test_system.py's bars),
              ``benchmarks.table1`` (time and energy per sample, power
              from nvidia-smi), ``benchmarks.fig5`` (time per sample
              against batch, §3.1 margins on H100_SXM),
              ``benchmarks.quant_quality`` and ``examples.rl_qlearning``
              (120 episodes, returns per scheme); every quantized arm
              through spx_matmul, at shapes the kernel phase checked;
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
                        only at a near-tie (BF16_E2E_RTOL).
              Every kernel of each path must launch, as often per tick or
              per request as the path says, and no plain version may run;
              the last three give the paged engine's greedy tokens, or
              differ first where its top-2 logit gap is a near-tie;
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
              at the paper MLP's two layers (``paper_mlp_by_M``), the ragged
              kernel at a verify tick of W = 5 (``verify_tick``), kernels 2
              and 5 over bf16 pages (a decode tick and 4 slots x 2048
              tokens; SDPA over the bf16 K/V), and the split counts the
              wrappers chose (a ``splits`` line).

Exits non-zero on any failure, and when no CUDA device is visible or the
package is missing. The last line is the device record.
"""
from __future__ import annotations

import dataclasses
import json
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
    worst = {"spx_matmul": 0.0, "paged_decode_ragged": 0.0,
             "paged_attention": 0.0}
    # spx_matmul at the serving shapes: q/o (2048, 2048), k/v (2048, 256),
    # gate/up (2048, 16384), down (16384, 2048); decode M = slots, prefill
    # M = slots x chunk
    # and K, N that no tile divides; M over both kernels (decode M <= 8);
    # the paper MLP's layers (784, 128) and (128, 10) also at the batches
    # of its experiments, up to quickstart's 2048 test digits (K = 784 ends
    # in a ragged K step, N = 10 packs 5-byte rows); the Q-network's
    # quantized layers (4, 64) and (64, 64) at one state and at 64, also
    # under pot4's 5-bit codebook (32 LUT entries, unpacked). Every
    # (packed, LUT size, M, K, N) checked here is returned: the
    # paper_experiments phase launches no other
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
                got = spx_matmul_cuda(x, codes, scale, lut, packed=packed)
                again = spx_matmul_cuda(x, codes, scale, lut, packed=packed)
                want = ref.spx_matmul_ref(x, codes, scale, lut, packed=packed)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                peak = want.abs().max().item()
                same = bool(torch.equal(got, again))
                ok = bool(torch.isfinite(got).all()) \
                    and err <= SPX_RTOL * peak and same
                emit({"phase": "kernel", "kernel": "spx_matmul",
                      "scheme": scheme, "M": m, "K": k, "N": n,
                      "max_abs_err": err, "max_rel_err": err / peak,
                      "tol_rel": SPX_RTOL, "bit_identical_rerun": same,
                      "ok": ok})
                require(ok, f"spx_matmul {scheme} M={m} K={k} N={n}")
                worst["spx_matmul"] = max(worst["spx_matmul"], err)
                checked.add((packed, lut.numel(), m, k, n))

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
    worst.update(_bf16_kernel_checks(torch, gen))
    worst["flash_attention"] = _flash_kernel_checks(torch, gen)
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


def _bf16_kernel_checks(torch, gen) -> dict:
    """Kernels 2 and 5 over bf16 pages (the ``Bf16Page`` instance) at
    gemma-2b's heads (4 slots, 1 KV head of 256, rep 8), at the bf16
    engine's page size (32 tokens) and at 16: W = 1 and a W = 5 verify
    window that crosses a page boundary, an empty slot, and block tables
    of 256 and 2048 tokens (several splits). Each launch twice: the
    second must be bit-identical."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (
        decode_splits, paged_attention_cuda, paged_decode_ragged_cuda)
    from repro_torch.runtime import planner

    b, hkv, rep, dh = 4, 1, 8, 256
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = {"paged_decode_ragged_bf16": 0.0, "paged_attention_bf16": 0.0}
    bf16_ps = planner.plan_kv_pages(dh, act_bytes=2).page_size
    for ps in (bf16_ps, 16):
        for tokens in (256, 2048):
            mp = tokens // ps
            n_pages = 1 + b * mp
            kp, vp = (t.bfloat16() for t in
                      _rand_pools(torch, gen, n_pages, hkv, ps, dh))
            bt = (torch.randperm(n_pages - 1, generator=gen, device="cuda")[
                :b * mp].reshape(b, mp) + 1).to(torch.int32)
            for w, qlens, ctx_l in (
                    (1, [0, 1, 1, 1], [0, ps - 1, ps + 1, tokens - 1]),
                    (5, [0, 5, 3, 5], [0, ps - 2, 2 * ps - 3, tokens - 5])):
                q = torch.randn((b, hkv, rep * w, dh), generator=gen,
                                device="cuda")
                ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
                qn = torch.tensor(qlens, dtype=torch.int32, device="cuda")
                got = paged_decode_ragged_cuda(q, kp, vp, bt, ctx, qn, w=w)
                again = paged_decode_ragged_cuda(q, kp, vp, bt, ctx, qn, w=w)
                want = ref.paged_decode_ragged_ref(q, kp, vp, bt, ctx, qn,
                                                   w=w)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                peak = want.abs().max().item()
                rows_off = torch.arange(rep * w, device="cuda") % w \
                    >= qn[:, None]
                zeros = bool((got.permute(0, 2, 1, 3)[rows_off] == 0).all())
                same = bool(torch.equal(got, again))
                rel = _slot_rel_err(torch, got, want)
                ok = (bool(torch.isfinite(got).all()) and zeros and same
                      and rel <= BF16_ATTN_RTOL)
                emit({"phase": "kernel", "kernel": "paged_decode_ragged_bf16",
                      "w": w, "page_size": ps, "ctx_len": ctx_l,
                      "q_len": qlens,
                      "splits": decode_splits(b, hkv, rep * w, mp, ps, sms),
                      "max_abs_err": err, "max_rel_err": err / peak,
                      "max_slot_rel_err": rel,
                      "tol_slot_rel": BF16_ATTN_RTOL,
                      "masked_rows_exact_zero": zeros,
                      "bit_identical_rerun": same, "ok": ok})
                require(ok, f"paged_decode_ragged_bf16 ps={ps} "
                            f"tokens={tokens} w={w}")
                worst["paged_decode_ragged_bf16"] = max(
                    worst["paged_decode_ragged_bf16"], err)
            ctx_l = [0, 1, ps + 1, tokens]
            ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
            q = torch.randn((b, hkv, rep, dh), generator=gen, device="cuda")
            got = paged_attention_cuda(q, kp, vp, bt, ctx)
            again = paged_attention_cuda(q, kp, vp, bt, ctx)
            want = ref.paged_attention_ref(q, kp, vp, bt, ctx)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            peak = want.abs().max().item()
            zeros = bool((got[0] == 0).all())
            same = bool(torch.equal(got, again))
            rel = _slot_rel_err(torch, got, want)
            ok = (bool(torch.isfinite(got).all()) and zeros and same
                  and rel <= BF16_ATTN_RTOL)
            emit({"phase": "kernel", "kernel": "paged_attention_bf16",
                  "mode": "single-token", "page_size": ps, "ctx_len": ctx_l,
                  "splits": decode_splits(b, hkv, rep, mp, ps, sms),
                  "max_abs_err": err, "max_rel_err": err / peak,
                  "max_slot_rel_err": rel, "tol_slot_rel": BF16_ATTN_RTOL,
                  "ctx0_rows_exact_zero": zeros,
                  "bit_identical_rerun": same, "ok": ok})
            require(ok, f"paged_attention_bf16 ps={ps} tokens={tokens}")
            worst["paged_attention_bf16"] = max(
                worst["paged_attention_bf16"], err)
    return worst


def _flash_kernel_checks(torch, gen) -> float:
    """Kernel 4 at the dense prefill's lengths (ragged ones included),
    causal and not, at two head dims and two GQA groupings, and at a long
    prompt (2048 tokens, gemma-2b's heads, causal); a second launch must be
    bit-identical."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    worst = 0.0
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
                    got = flash_attention_cuda(q, k, v, causal=causal)
                    again = flash_attention_cuda(q, k, v, causal=causal)
                    want = ref.flash_attention_ref(q, k, v, causal=causal,
                                                   q_chunk=s)
                    torch.cuda.synchronize()
                    errs[s] = (got - want).abs().max().item()
                    require(_attn_ok(torch, got, want)
                            and bool(torch.equal(got, again)),
                            f"flash_attention dh={dh} rep={rep} "
                            f"causal={causal} S={s}")
                emit({"phase": "kernel", "kernel": "flash_attention",
                      "dh": dh, "rep": rep, "causal": causal,
                      "max_abs_err_by_len": errs,
                      "tol": f"{ATTN_TOL} * (1 + |plain|)",
                      "bit_identical_rerun": True, "ok": True})
                worst = max(worst, *errs.values())
    return worst


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


def _serve_ticks(torch, eng, prompts, watch=(), staged: int = 0):
    """Serve ``prompts`` through ``eng.step()`` until drained. The counts
    are set to 0 just before and read just after. ``staged``: submit the
    first prompt alone and step that many ticks before the others arrive.
    Returns (finished, launches, plain calls, {op: launches of each tick
    that launched it})."""
    from repro_torch.kernels import ops
    from repro_torch.serving import Request
    torch.cuda.reset_peak_memory_stats()
    ops.reset_op_calls()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
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
    require(launches == {"spx_matmul": 2},
            f"paper_mlp: launches per forward {launches}")
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
          "max_abs_err": err, "max_rel_err": err / peak, "tol_rel": SPX_RTOL,
          "argmax_identical": same_argmax,
          "argmax_agreement_with_f32_weights": float(
              (out.argmax(-1) == dense.argmax(-1)).float().mean()),
          "timing": timing, "ok": ok})
    require(ok, "paper_mlp: quantized forward disagrees with its plain "
                "version")
    ops.reset_op_calls()
    return {"params": qparams, "launches": launches["spx_matmul"],
            "max_abs_err": err}


#: the reference's defaults for the §4 experiments
PAPER_EPOCHS = 4
RL_EPISODES = 120
#: test_system.py's accuracy bars: f32 above 0.9, each scheme within its
#: tolerance of f32
ACC_FLOOR = 0.9
ACC_TOL = {"sp2_8": 0.01, "spx_8_x3": 0.01, "sp2_4": 0.02, "pot4": 0.03}


def paper_experiments_phase(torch, np, card: str, spx_checked: set) -> dict:
    """The paper's §4 experiments through the port's entry points, on the
    card: ``examples.quickstart`` (train the MLP for 4 epochs, then test
    accuracy per scheme), ``benchmarks.table1`` (time and energy per
    sample at batch 1 and 1024), ``benchmarks.fig5`` (time per sample
    against batch, and the §3.1 margins on H100_SXM),
    ``benchmarks.quant_quality`` and ``examples.rl_qlearning`` (120
    episodes, then the returns per scheme). Each is one run with the
    counts set to 0 just before and read just after: every quantized arm
    must launch ``spx_matmul`` and no plain version may run. Each launch's
    (packed, LUT size, M, K, N) is recorded, and each must be one that
    the kernel phase held against the plain version (``spx_checked``).
    Returns the launches of all five."""
    from repro_torch.benchmarks import fig5, quant_quality, table1
    from repro_torch.examples import quickstart, rl_qlearning
    from repro_torch.kernels import ops
    from repro_torch.runtime import registry

    total: dict[str, int] = {}
    _, kernel = registry.resolve("spx_matmul", "cuda", torch.device("cuda"))
    shapes = set()

    def recorded(x, codes, scale, lut, *, packed):
        shapes.add((packed, lut.numel(), *x.shape, scale.numel()))
        return kernel(x, codes, scale, lut, packed=packed)

    def run(name, fn):
        ops.reset_op_calls()
        shapes.clear()
        t0 = time.perf_counter()
        registry.register("spx_matmul", "cuda")(recorded)
        try:
            result = fn()
        finally:
            registry.register("spx_matmul", "cuda")(kernel)
        torch.cuda.synchronize()
        launches, plain = ops.op_calls(), ops.ref_calls()
        require(launches.get("spx_matmul", 0) > 0,
                f"{name}: spx_matmul never launched")
        require(not plain, f"{name}: plain versions ran on the card: "
                           f"{plain}")
        unchecked = sorted(shapes - spx_checked)
        require(not unchecked, f"{name}: spx_matmul launched at (packed, "
                               f"LUT size, M, K, N) {unchecked}, which the "
                               "kernel phase never held to the plain version")
        for op, n in launches.items():
            total[op] = total.get(op, 0) + n
        return result, {"launches": launches,
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


def _record_steps(torch, names):
    """Wrap the model-step functions ``names`` of ``repro_torch.models.lm``
    (the engine looks them up at each call): each call appends [name,
    window width, n_valid (its largest value once ``restore`` ran),
    launches by op during the call]. Returns (records, restore)."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm as lm_mod
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


def _run_engine(torch, eng, prompts, staged: int = 0):
    """``_serve_ticks`` without a watch: (tokens by rid, launches, plain
    calls, metrics)."""
    done, launches, plain, _ = _serve_ticks(torch, eng, prompts,
                                            staged=staged)
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
        eng = ServeEngine(params, cfg, sc)
        require(all(leaf.dtype == torch.bfloat16 for c in eng.caches
                    for leaf in c.values()),
                f"{path}: the caches are not bf16")
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
            require(all(n % layers == 0 for n in per_tick[op]),
                    f"{path}: {op} launches per tick {per_tick[op]}")
        if path == "dense-bf16":
            require(launches["flash_attention"] == layers * N_REQUESTS,
                    "dense-bf16: flash per request")
        require(m["kv_cache_dtype"] == "bfloat16",
                f"{path}: metrics say {m['kv_cache_dtype']}")
        del eng
        torch.cuda.empty_cache()

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
              "requests_finished": len(done),
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
                                               nv, caches, cfg, rt)
            nxt = pre.argmax(-1)[:, None]
            fused, caches = lm_mod.lm_paged_fused_step(
                params, nxt, nv, bt, act, caches, cfg, rt)
            out[impl] = [pre, fused]
            if kv_quant:
                one, _ = lm_mod.lm_paged_step(
                    params, fused.argmax(-1), nv + act, bt, act, caches,
                    cfg, rt)
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


def _device_events(torch, fn):
    """(device kernel events, host wall seconds) of one ``fn()`` run under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return evs, wall


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
    return best[1] / 1e3 / reps if best[1] else None


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
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:                    # union of the kernel intervals
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name: dict[str, float] = {}
    for e in evs:
        key = e.name.replace("(anonymous namespace)::", "")
        key = key.removeprefix("void ").split("<")[0].split("(")[0][:60]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
    out = {"phase": "trace", "requests": 4, "new_tokens": NEW_TOKENS,
           "prompt_len": 24, "wall_ms": wall * 1e3,
           "device_busy_ms": busy / 1e3 if spans else None,
           "device_idle_share": 1 - busy / 1e3 / (wall * 1e3)
           if spans else None,
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
                 mlp) -> list:
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
    bf16, bf16_one = _bf16_timing(torch, gen, cfg, m, ctx_tokens, q)
    ragged.update(_long_ctx_timing(torch, gen, cfg, m, quant=False))
    ragged["verify_tick"] = _verify_timing(torch, gen, cfg, eng, m)
    quant.update(_long_ctx_timing(torch, gen, cfg, m, quant=True))
    flash = _flash_timing(torch, gen, cfg)
    flash["long_prompt"] = _flash_timing(torch, gen, cfg, s=LONG_CTX)
    _emit_splits(torch, cfg, m, eng, layers)
    src = "src/repro_torch/kernels/csrc/"
    meta = {
        "spx_matmul": (src + "spx_matmul.cu",
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
    }
    path_launches = {"paged_decode_ragged_quant": new_launches["quant"],
                     "paged_attention_quant": new_launches["quant"],
                     "flash_attention": new_launches["dense"],
                     "paged_decode_ragged_bf16": new_launches["paged-bf16"],
                     "paged_attention_bf16": new_launches["paged-bf16"]}
    # every serving path's run, the paper MLP's forward and the §4
    # experiments (counts set to 0 before each and read after it)
    by_path = {"paged": launches, **new_launches,
               "paper_mlp": {"spx_matmul": mlp["launches"]},
               "paper_experiments": mlp["experiments"]}
    rows = []
    for entry in (spx, ragged, paged, quant, flash, quant_one, bf16,
                  bf16_one):
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
    then (128, 10), at M = 64 and 1024 rows, beside ``torch.matmul`` on the
    dequantized weights and the two bounds."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda
    qts = [qparams[f"l{i}"]["w"] for i in range(2)]
    dense = [qt.dequantize() for qt in qts]
    lut = qts[0].lut()
    out = {}
    for m in (64, 1024):
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
        row = {"per": f"forward: 2 launches, M={m}, (K, N) = (784, 128) "
                      "and (128, 10)",
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
        out[f"M={m}"] = row
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


def _bf16_timing(torch, gen, cfg, m, ctx_tokens, q):
    """Kernels 2 and 5 over bf16 pages per tick at the decode shapes of the
    bf16 path: ``m`` slots, every layer's bf16 pools at the bf16 page size,
    each slot ``ctx_tokens`` into its sequence; kernel 2 also at ``m``
    slots x ``LONG_CTX`` tokens. The library call is SDPA over the same
    bf16 K/V, pre-gathered, with q cast to bf16. The byte bound counts
    half the f32 rows' K/V bytes."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_decode_ragged_cuda)
    from repro_torch.runtime import planner

    hkv, rep, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.dh
    ps = planner.plan_kv_pages(dh, act_bytes=2).page_size
    rows = []
    for tokens in (ctx_tokens + 1, LONG_CTX):
        mp = -(-max(tokens, 256) // ps)          # ServeConfig().max_seq
        n_pages = m * mp
        pools = [tuple(t.bfloat16() for t in
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
        q_sdpa = q.reshape(m, hkv * rep, 1, dh).bfloat16()

        def sdpa_tick():
            for k, v in gathered:
                F.scaled_dot_product_attention(q_sdpa, k, v)

        # bf16 K and V of every attended token, q in and out f32, tables
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
                                f"each, bf16 pages of {ps}",
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
                "long_ctx_share_of_bound": bound / dev if dev else None})
        else:
            lib = {"library_ms": _time_ms(torch, sdpa_tick),
                   "library_device_ms": _device_ms(torch, sdpa_tick, ("",)),
                   "library_call": "scaled_dot_product_attention over "
                                   "pre-gathered bf16 K/V (q cast to bf16)",
                   "bound_ms": bound, "bound_by": by,
                   "f32_bound_ms": _f32_bound_ms(nbytes, flops)}
            for name, fn, per in (
                    ("paged_decode_ragged_bf16", ragged, "decode tick"),
                    ("paged_attention_bf16", single,
                     "one-token prefill tick")):
                rows.append({
                    "name": name,
                    "per": f"{per}: {cfg.n_layers} launches, {m} slots, "
                           f"{tokens} tokens attended each, bf16 pages of "
                           f"{ps}",
                    "ms": _time_ms(torch, lambda fn=fn: fn("cuda")),
                    "device_ms": _device_ms(torch, lambda fn=fn: fn("cuda"),
                                            PAGED_KERNELS),
                    "plain_ms": _time_ms(torch, lambda fn=fn: fn("ref")),
                    **lib})
        del pools, gathered
        torch.cuda.empty_cache()
    return rows


#: kernel names of one paged-decode launch: the split kernel and, with
#: several splits, its merge
PAGED_KERNELS = ("paged_decode_kernel", "paged_decode_merge_kernel")
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
    """The split counts the wrappers chose at the timing shapes."""
    from repro_torch.kernels import spx_matmul as spx_mod
    from repro_torch.kernels.paged_attention import decode_splits
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
    spx_splits = {}
    for name, qt in layers[0].items():
        k, n = qt.logical_shape
        for rows in (m, 128, 256, 2048):
            spx_splits[f"{name} {k}x{n} M={rows}"] = spx_mod._splits(
                rows, k, n, sms)
    emit({"phase": "splits", "sms": sms, "slots": m,
          "paged_decode": paged, "spx_matmul": spx_splits})


def _flash_timing(torch, gen, cfg, s: int = 33):
    """Kernel 4 per admitted request of the dense path: one launch per
    layer over the prompt (the 33-token prompt of the serve phase, or a
    long one)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    hkv, hq, dh = cfg.n_kv_heads, cfg.n_heads, cfg.dh
    qkv = [(torch.randn((1, hq, s, dh), generator=gen, device="cuda"),
            torch.randn((1, hkv, s, dh), generator=gen, device="cuda"),
            torch.randn((1, hkv, s, dh), generator=gen, device="cuda"))
           for _ in range(cfg.n_layers)]
    expanded = [(q, k.repeat_interleave(hq // hkv, 1),
                 v.repeat_interleave(hq // hkv, 1)) for q, k, v in qkv]

    def kernel():
        for q, k, v in qkv:
            flash_attention_cuda(q, k, v, causal=True)

    def plain():
        for q, k, v in qkv:
            ref.flash_attention_ref(q, k, v, causal=True, q_chunk=1024)

    def library():
        for q, k, v in expanded:
            F.scaled_dot_product_attention(q, k, v, is_causal=True)

    # q, k, v read once and out written once; the causal half of the
    # (query, key) pairs, 4 * dh flops each (QK^T and PV)
    nbytes = cfg.n_layers * 4 * dh * (2 * hq * s + 2 * hkv * s)
    flops = cfg.n_layers * 4 * hq * dh * (s * (s + 1) // 2)
    bound, by = _bound_ms(nbytes, flops)
    device_ms = _device_ms(torch, kernel, ("flash_attention_kernel",))
    return {"name": "flash_attention",
            "per": f"admitted request: {cfg.n_layers} launches, causal "
                   f"prefill of {s} tokens, {hq} query heads over {hkv} KV "
                   f"head(s) of {dh}",
            "ms": _time_ms(torch, kernel),
            "device_ms": device_ms,
            "plain_ms": _time_ms(torch, plain, reps=3),
            "library_ms": _time_ms(torch, library),
            "library_device_ms": _device_ms(torch, library, ("",)),
            "library_call": "scaled_dot_product_attention(is_causal=True), "
                            "K/V pre-repeated over the query heads",
            "bound_ms": bound, "bound_by": by,
            "f32_bound_ms": _f32_bound_ms(nbytes, flops),
            "share_of_bound": bound / device_ms if device_ms else None}


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
    built library's SASS, by cuobjdump; the two tensor-core kernels must
    have them."""
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
        require(counts["flash_attention"]["HMMA"] > 0,
                "flash_attention has no HMMA")
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
    try:
        info = device_phase(torch)
        from repro_torch.kernels import cuda_lib
        emit({"phase": "build", "seconds": cuda_lib.build_all(),
              "dir": str(cuda_lib.build_dir()),
              "tensor_core_instructions": _sass_counts(cuda_lib)})
        worst, spx_checked = kernel_phase(torch, np)
        mlp = paper_mlp_phase(torch, np, info["nvidia_smi"])
        worst["spx_matmul"] = max(worst["spx_matmul"], mlp["max_abs_err"])
        mlp["experiments"] = paper_experiments_phase(
            torch, np, info["nvidia_smi"], spx_checked)
        eng, launches, paged_m, paged_tokens = serve_phase(torch, np)
        new_launches = serve_new_paths_phase(torch, np, eng.params)
        new_launches.update(serve_modes_phase(torch, np, eng.params,
                                              paged_tokens, paged_m))
        new_launches.update(serve_bf16_phase(torch, np, eng.params,
                                             paged_tokens))
        e2e_phase(torch, np, eng)
        trace_phase(torch, np, eng)
        rows = timing_phase(torch, np, eng, launches, new_launches, worst,
                            mlp)
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
