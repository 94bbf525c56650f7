#!/usr/bin/env python3
"""``spx_matmul`` at the paper's layers, timed on one CUDA card for one tree
of the port.

    python3 tools/spx_small_probe.py [--src TREE/src] [--label NAME]
                                     [--sweep]

Rows, each one JSON line after the card's ``nvidia-smi`` name and power
limit:

  * the 24 launch keys of the paper's §4 experiments (``PAPER_KEYS``:
    packed, LUT size, M, K, N), one launch each;
  * the paper MLP's forward, (784, 128) then (128, 10), sp2_4, at M = 1,
    64 and 1024 (two launches), and the Q-network's two quantized layers,
    (4, 64) then (64, 64), at M = 1;
  * gemma-2b's decode tick (7 projections x 18 layers, M = 4, 126
    launches) and prefill ticks at M = 128, 256 and 2048, sp2_4 codes;
  * the serving keys that ``plan_spx_launch`` also sends to the small
    kernel: whisper-small's 8-shard cuts (768, 128) and (768, 64) at
    M = 4, 128 and 1500.

Then the host's microseconds per call of the wrapper, of the op the models
call and of ``torch.matmul`` at M = 1. For each row, through the tree's
``spx_matmul_cuda``: the profiler's device ms
over the kernels whose names contain ``spx_matmul``, CUDA-event ms,
``torch.matmul`` on the dequantized f32 weights (device and event ms), the
byte bound (every input read once, the output written once, at 3.35
TB/s), the f32 bound (the larger of that and the flops at 67 TFLOP/s),
the largest error against the plain version over its largest |output|,
and the kernel the tree took (``ops.path_calls``; the parent has no such
count: its kernel is the decode one at M <= 8, else the prefill one).
``--sweep`` (a tree with the small kernel) also times every tile and warp
count of the small kernel at each §4 key by calling the library
directly. To compare two trees, run it once per tree in one call (parent,
change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PAPER_KEYS = tuple(
    [(True, 16, m, k, n) for k, n in ((784, 128), (128, 10))
     for m in (1, 8, 64, 256, 1024, 2048)]
    + [(True, 16, 1, 4, 64), (True, 16, 1, 64, 64)]
    + [(False, lut, m, k, n) for lut in (32, 256)
       for k, n in ((784, 128), (128, 10)) for m in (1024, 2048)]
    + [(False, 256, 1, 4, 64), (False, 256, 1, 64, 64)])
SCHEMES = {16: "sp2_4", 32: "pot4", 256: "sp2_8"}
GEMMA = ((2048, 2048), (2048, 256), (2048, 256), (2048, 2048),
         (2048, 16384), (2048, 16384), (16384, 2048))
GEMMA_LAYERS = 18
WHISPER_KEYS = tuple((True, 16, m, 768, n) for n in (128, 64)
                     for m in (4, 128, 1500))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("spx_small_probe: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import spx
    from repro_torch.kernels import cuda_lib, ops, ref
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda

    cs.device_phase(torch)
    cuda_lib.build_all()
    gen = torch.Generator(device="cuda").manual_seed(25)
    luts = {n: spx.codebook(spx.scheme_levels(s), device="cuda")
            for n, s in SCHEMES.items()}

    def weight(packed, lut_size, k, n):
        codes = torch.randint(0, 256 if packed else lut_size,
                              (k, n // 2 if packed else n), generator=gen,
                              device="cuda", dtype=torch.int32)
        scale = torch.rand((1, n), generator=gen, device="cuda") * 0.05
        return codes.to(torch.uint8), scale

    def kernels_of(calls):
        """The tree's kernel counts over ``calls()``, where it has them."""
        if not hasattr(ops, "path_calls"):
            return None
        ops.reset_op_calls()
        calls()
        torch.cuda.synchronize()
        return ops.path_calls()

    def row(name, launches, *, rows_m):
        """Time the launches [(x, codes, scale, lut, packed)] as one call."""
        def kernel(fn=spx_matmul_cuda):
            return [fn(x, c, s, lut, packed=p) for x, c, s, lut, p in launches]

        dense = [lut[(spx.unpack_int4(c) if p else c).long()] * s
                 for _, c, s, lut, p in launches]

        def library():
            for (x, *_), w in zip(launches, dense):
                torch.matmul(x, w)

        got, want = kernel(), kernel(ref.spx_matmul_ref)
        again = kernel()
        torch.cuda.synchronize()
        err = max(((g - w).abs().max() / w.abs().max()).item()
                  for g, w in zip(got, want))
        nbytes = flops = 0
        for x, c, s, lut, _ in launches:
            m, k = x.shape
            n = s.numel()
            nbytes += 4 * m * k + c.numel() + 4 * n + 4 * lut.numel() \
                + 4 * m * n
            flops += 2 * m * k * n
        out = {"label": args.label, "row": name, "launches": len(launches),
               "M": rows_m,
               "device_ms": cs._device_ms(torch, kernel, ("spx_matmul",)),
               "ms": cs._time_ms(torch, kernel, reps=20, warmup=3),
               "library_device_ms": cs._device_ms(torch, library, ("",)),
               "library_ms": cs._time_ms(torch, library, reps=20, warmup=3),
               "library_call": "torch.matmul on the dequantized f32 weights",
               "byte_bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
               "f32_bound_ms": cs._f32_bound_ms(nbytes, flops),
               "max_rel_err": err,
               "bit_identical_rerun": all(torch.equal(a, b)
                                          for a, b in zip(got, again)),
               "kernels": kernels_of(kernel)}
        out["bound_ms"], out["bound_by"] = cs._bound_ms(nbytes, flops)
        print(json.dumps(out), flush=True)
        del dense
        return out

    def host_cost(launch, calls=2000):
        """Host microseconds per call at M = 1, where the card outpaces
        the host: the wrapper, the op the models call (``ops.spx_matmul``
        on a QuantizedTensor) and ``torch.matmul`` on the dequantized
        weight, each over ``calls`` calls and one synchronize."""
        import time
        from repro_torch.core.quantized import QuantizedTensor
        x, c, s, lut, p = launch
        qt = QuantizedTensor(codes=c, scale=s, scheme="sp2_4", packed=p)
        w = lut[spx.unpack_int4(c).long()] * s
        out = {"label": args.label, "row": "host us per call, M=1, (784, "
               "128)", "calls": calls}
        for name, fn in (("spx_matmul_cuda", lambda: spx_matmul_cuda(
                             x, c, s, lut, packed=p)),
                         ("ops.spx_matmul", lambda: ops.spx_matmul(x, qt)),
                         ("torch.matmul", lambda: torch.matmul(x, w))):
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) / calls * 1e6
        print(json.dumps(out), flush=True)

    def key_launch(key, m=None):
        packed, lut_size, mm, k, n = key
        codes, scale = weight(packed, lut_size, k, n)
        x = torch.rand((m or mm, k), generator=gen, device="cuda")
        return (x, codes, scale, luts[lut_size], packed)

    for key in PAPER_KEYS:
        row(f"paper key {list(key)}", [key_launch(key)], rows_m=key[2])
    for m in (1, 64, 1024):
        row(f"paper MLP forward, M={m}",
            [key_launch((True, 16, m, 784, 128)),
             key_launch((True, 16, m, 128, 10))], rows_m=m)
    row("Q-network forward, M=1",
        [key_launch((True, 16, 1, 4, 64)), key_launch((True, 16, 1, 64, 64))],
        rows_m=1)
    for key in WHISPER_KEYS:
        row(f"whisper-small shards=8 key {list(key)}", [key_launch(key)],
            rows_m=key[2])
    host_cost(key_launch((True, 16, 1, 784, 128)))

    # gemma-2b: every layer's own codes, so that the tick reads them from
    # device memory as serving does
    layers = [[weight(True, 16, k, n) for k, n in GEMMA]
              for _ in range(GEMMA_LAYERS)]
    for m in (4, 128, 256, 2048):
        xs = {k: torch.randn((m, k), generator=gen, device="cuda")
              for k in (2048, 16384)}
        tick = [(xs[k], c, s, luts[16], True)
                for lw in layers for (k, _), (c, s) in zip(GEMMA, lw)]
        name = "decode tick" if m <= 8 else "prefill tick"
        row(f"gemma-2b {name}, M={m}", tick, rows_m=m)
        del xs, tick
    del layers
    torch.cuda.empty_cache()

    if args.sweep:
        from repro_torch.kernels.spx_matmul import PATH_IDS
        from repro_torch.runtime import planner
        lib = cuda_lib.library("spx_matmul")
        stream = torch.cuda.current_stream().cuda_stream
        sms = cuda_lib.sm_count(0)
        for key in PAPER_KEYS + WHISPER_KEYS:
            packed, lut_size, m, k, n = key
            x, codes, scale, lut, _ = key_launch(key)
            out = torch.empty((m, n), device="cuda")
            chosen = planner.plan_spx_launch(m, k, n, packed, lut_size, sms)
            times = {}
            for tm in (8, 16, 32):
                for tn in (16, 32, 64):
                    if (tm > 8 and tm // 2 >= m) or (tn > 16 and tn // 2 >= n):
                        continue
                    for w in (1, 2, 4, 8, 16):
                        if w > min(-(-k // 16), planner.spx_small_max_warps(
                                tm, tn)) or planner.spx_small_smem_bytes(
                                tm, tn, k, packed, w) > 232448:
                            continue

                        def launch(tm=tm, tn=tn, w=w):
                            cuda_lib.check(lib, lib.spx_matmul_f32(
                                x.data_ptr(), codes.data_ptr(),
                                scale.data_ptr(), lut.data_ptr(),
                                out.data_ptr(), m, k, n, int(packed),
                                lut.numel(), PATH_IDS["small"], 1, tm, tn, w,
                                stream), "sweep")

                        times[f"{tm}x{tn} w{w}"] = cs._device_ms(
                            torch, launch, ("spx_matmul",), reps=20)
            best = min((t, c) for c, t in times.items() if t)
            print(json.dumps({
                "label": args.label, "sweep": list(key),
                "chosen": f"{chosen.tile_m}x{chosen.tile_n} w{chosen.warps}",
                "chosen_ms": times.get(f"{chosen.tile_m}x{chosen.tile_n} "
                                       f"w{chosen.warps}"),
                "best": best[1], "best_ms": best[0], "device_ms": times}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
