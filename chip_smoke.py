#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing JSON lines:

  1. device   the card, ``nvidia-smi``'s name and power limit, TF32 off;
  2. build    nvcc builds every kernel from ``src/repro_torch/kernels/csrc``;
  3. kernels  each hand-written kernel against its plain PyTorch version on
              the card, at the shapes the serving path gives it;
  4. serve    full-width gemma-2b (18 layers, d_model 2048, vocab 256000,
              random weights from a seed, quantized to sp2_4) served by
              ``ServeEngine(params, cfg, ServeConfig())``: 8 greedy requests
              of 16 new tokens, one prompt of 33 tokens so that a one-token
              prefill chunk reaches ``paged_attention``. Every kernel must
              launch, and no plain version may run;
  5. e2e      logits of one prefill chunk and one fused tick, kernels against
              plain versions at full width; greedy tokens identical on the
              pinned config (reduced gemma-2b, vocab 32, head_dim 128, seed 3);
  6. trace    torch.profiler over a serving run of 4 requests: the device's
              busy time and idle share, and device time by kernel name;
  7. timing   each kernel per serving tick at the decode shapes (4 slots),
              with CUDA events (``ms``) and the profiler's device time
              (``device_ms``), beside its bound, its plain version and one
              PyTorch library call that computes the same function.

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
#: products over K, in another order (split-K partials and tile order
#: against cuBLAS's blocking); at K = 16384 the rounding of the two orders
#: differs by ~1e-6 of the largest output.
SPX_RTOL = 1e-4
#: paged attention: |kernel - plain| <= ATTN_TOL * (1 + |plain|). The
#: kernel's online softmax rescales per page and sums P @ V page by page;
#: the plain version takes one max and one sum over the whole context.
ATTN_TOL = 1e-4


def _rand_pools(torch, gen, n_pages, hkv, ps, dh):
    kp = torch.randn((n_pages, hkv, ps, dh), generator=gen, device="cuda")
    vp = torch.randn((n_pages, hkv, ps, dh), generator=gen, device="cuda")
    return kp, vp


def kernel_phase(torch, np) -> dict:
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
    for scheme, packed in (("sp2_4", True), ("sp2_8", False)):
        lut = spx.codebook(spx.scheme_levels(scheme), device="cuda")
        for k, n in ((2048, 2048), (2048, 256), (2048, 16384),
                     (16384, 2048)):
            ncode = n // 2 if packed else n
            top = 16 if packed else 256
            codes = torch.randint(0, top, (k, ncode), generator=gen,
                                  device="cuda", dtype=torch.int32)
            codes = codes.to(torch.uint8)
            scale = torch.rand((1, n), generator=gen, device="cuda") * 0.05
            for m in (1, 4, 37, 128):
                x = torch.randn((m, k), generator=gen, device="cuda")
                got = spx_matmul_cuda(x, codes, scale, lut, packed=packed)
                want = ref.spx_matmul_ref(x, codes, scale, lut, packed=packed)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                peak = want.abs().max().item()
                ok = bool(torch.isfinite(got).all()) and err <= SPX_RTOL * peak
                emit({"phase": "kernel", "kernel": "spx_matmul",
                      "scheme": scheme, "M": m, "K": k, "N": n,
                      "max_abs_err": err, "max_rel_err": err / peak,
                      "tol_rel": SPX_RTOL, "ok": ok})
                require(ok, f"spx_matmul {scheme} M={m} K={k} N={n}")
                worst["spx_matmul"] = max(worst["spx_matmul"], err)

    # ragged decode at gemma-2b's head shapes: B=4, Hkv=1, rep=8, dh=256
    ps = planner.plan_kv_pages(256).page_size
    b, hkv, rep, dh, mp = 4, 1, 8, 256, 8
    n_pages = 1 + b * mp
    kp, vp = _rand_pools(torch, gen, n_pages, hkv, ps, dh)
    bt = torch.randperm(n_pages - 1, generator=gen, device="cuda")[
        :b * mp].reshape(b, mp).to(torch.int32) + 1
    for w, qlens in ((1, [0, 1, 1, 1]), (5, [0, 1, 3, 5])):
        q = torch.randn((b, hkv, rep * w, dh), generator=gen, device="cuda")
        ctx = torch.tensor([ps - 1, ps, ps + 1, 3 * ps + 7],
                           dtype=torch.int32, device="cuda")
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
        require(ok, f"paged_decode_ragged w={w}")
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
    ops.reset_op_calls()
    return worst


# -- phase 4 -------------------------------------------------------------------

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
    rng = np.random.default_rng(0)
    lens = [33] + [int(n) for n in rng.integers(8, 33, N_REQUESTS - 1)]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
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
    return eng, launches, m


# -- phase 5 -------------------------------------------------------------------

#: logits: |cuda - plain| <= E2E_RTOL * max|plain logits|. 18 layers of f32
#: sums taken in other orders (see SPX_RTOL, ATTN_TOL) compound.
E2E_RTOL = 1e-3


def e2e_phase(torch, np, eng) -> None:
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm as lm_mod
    from repro_torch.models.lm import lm_init
    from repro_torch.runtime import Runtime
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
    out = {}
    for impl in ("cuda", "ref"):
        rt = Runtime(impl=impl)
        caches = lm_mod.paged_init_caches(cfg, n_pages, eng.page_size,
                                          device="cuda")
        pre, caches = lm_mod.lm_paged_step(eng.params, tokens, ctx0, bt, nv,
                                           caches, cfg, rt)
        nxt = pre.argmax(-1)[:, None]
        fused, _ = lm_mod.lm_paged_fused_step(
            eng.params, nxt, nv, bt, (nv > 0).to(torch.int32), caches, cfg,
            rt)
        out[impl] = (pre, fused)
    torch.cuda.synchronize()
    for name, i in (("prefill_chunk", 0), ("fused_tick", 1)):
        got, want = out["cuda"][i], out["ref"][i]
        err = (got - want).abs().max().item()
        peak = want.abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= E2E_RTOL * peak
        emit({"phase": "e2e", "what": f"gemma-2b full width {name} logits",
              "shape": list(got.shape), "max_abs_err": err,
              "max_rel_err": err / peak, "tol_rel": E2E_RTOL, "ok": ok})
        require(ok, f"full-width {name} logits")

    pinned = dataclasses.replace(reduced(get_config("gemma-2b"), vocab=32),
                                 head_dim=128)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = lm_init(gen, pinned, device="cuda")
    prng = np.random.default_rng(3)
    prompts = [prng.integers(0, pinned.vocab_size, n).astype(np.int32)
               for n in (33, 1, 12, 20, 5)]
    tokens_by_impl = {}
    for impl in ("cuda", "ref"):
        e = ServeEngine(params, pinned, ServeConfig(batch_slots=2, max_seq=64),
                        rt=Runtime(impl=impl))
        for i, p in enumerate(prompts):
            e.submit(Request(rid=i, prompt=p, max_new_tokens=8))
        tokens_by_impl[impl] = {r.rid: r.output for r in e.run()}
    same = tokens_by_impl["cuda"] == tokens_by_impl["ref"]
    emit({"phase": "e2e", "what": "pinned config greedy tokens, kernels vs "
          "plain versions", "tokens": tokens_by_impl["cuda"],
          "identical": same})
    require(same, f"pinned greedy tokens differ: {tokens_by_impl}")


# -- phase 6 -------------------------------------------------------------------

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
    per ``fn()`` call; None when the profiler saw no device time."""
    fn()
    evs, _ = _device_events(torch, lambda: [fn() for _ in range(reps)])
    us = sum(e.time_range.elapsed_us() for e in evs
             if any(n in e.name for n in names))
    return us / 1e3 / reps if us else None


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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing_phase(torch, np, eng, launches, worst) -> list:
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
    spx["device_ms"] = _device_ms(torch, lambda: spx_tick("cuda"),
                                  ("spx_matmul_kernel", "split_k_reduce"))
    spx["reduce_device_ms"] = _device_ms(torch, lambda: spx_tick("cuda"),
                                         ("split_k_reduce",))

    def one_projection(name):
        for lw in layers:
            qt = lw[name]
            k, n = qt.logical_shape
            spx_matmul_cuda(xs[k], qt.codes, qt.scale.reshape(1, n), lut,
                            packed=True)

    spx["device_ms_by_projection"] = {
        f"{name} {qt.logical_shape[0]}x{qt.logical_shape[1]}": _device_ms(
            torch, lambda name=name: one_projection(name),
            ("spx_matmul_kernel", "split_k_reduce"))
        for name, qt in layers[0].items()}
    del dense

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
    lib_ms = _time_ms(torch, sdpa_tick)
    def ragged_tick():
        for kp, vp in pools:
            paged_decode_ragged_cuda(q, kp, vp, bt, ctx, one, w=1)

    ctx1 = ctx + 1

    def paged_tick():
        for kp, vp in pools:
            paged_attention_cuda(q, kp, vp, bt, ctx1)

    ragged = {"name": "paged_decode_ragged",
              "per": f"decode tick: {cfg.n_layers} launches, {m} slots, "
                     f"{attend} tokens attended each",
              "ms": _time_ms(torch, ragged_tick),
              "device_ms": _device_ms(torch, ragged_tick,
                                      ("paged_decode_kernel",)),
              "plain_ms": _time_ms(torch, lambda: [ref.paged_decode_ragged_ref(
                  q, kp, vp, bt, ctx, one, w=1) for kp, vp in pools]),
              "library_ms": lib_ms,
              "library_call": "scaled_dot_product_attention over "
                              "pre-gathered K/V",
              "bound_ms": a_bound, "bound_by": a_by}
    paged = {"name": "paged_attention",
             "per": f"one-token prefill tick: {cfg.n_layers} launches, {m} "
                    f"slots, {attend} tokens attended each",
             "ms": _time_ms(torch, paged_tick),
             "device_ms": _device_ms(torch, paged_tick,
                                     ("paged_decode_kernel",)),
             "plain_ms": _time_ms(torch, lambda: [ref.paged_attention_ref(
                 q, kp, vp, bt, ctx1) for kp, vp in pools]),
             "library_ms": lib_ms,
             "library_call": "scaled_dot_product_attention over "
                             "pre-gathered K/V",
             "bound_ms": a_bound, "bound_by": a_by}
    src = "src/repro_torch/kernels/csrc/"
    meta = {
        "spx_matmul": (src + "spx_matmul.cu",
                       "src/repro/kernels/spx_matmul.py:77"),
        "paged_decode_ragged": (src + "paged_decode.cu",
                                "src/repro/kernels/paged_attention.py:247"),
        "paged_attention": (src + "paged_decode.cu",
                            "src/repro/kernels/paged_attention.py:354"),
    }
    rows = []
    for entry in (spx, ragged, paged):
        source, replaces = meta[entry["name"]]
        entry.update(route="cuda", source=source, replaces=replaces,
                     launches=launches.get(entry["name"], 0),
                     max_abs_err=worst[entry["name"]])
        rows.append(entry)
    return rows


def _layer_weights(params, i):
    """The seven quantized projections of period ``i``."""
    sp = params["stack"]["slots"][0]
    for name, w in (("wq", sp["attn"]["wq"]["w"]), ("wk", sp["attn"]["wk"]["w"]),
                    ("wv", sp["attn"]["wv"]["w"]), ("wo", sp["attn"]["wo"]["w"]),
                    ("gate", sp["mlp"]["gate"]["w"]),
                    ("up", sp["mlp"]["up"]["w"]),
                    ("down", sp["mlp"]["down"]["w"])):
        yield name, w[i]


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
              "dir": str(cuda_lib.build_dir())})
        worst = kernel_phase(torch, np)
        eng, launches, _ = serve_phase(torch, np)
        e2e_phase(torch, np, eng)
        trace_phase(torch, np, eng)
        rows = timing_phase(torch, np, eng, launches, worst)
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
