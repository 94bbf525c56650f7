#!/usr/bin/env python3
"""Kernels 2 and 5 over bf16 and f16 pages, timed on one CUDA card at
gemma-2b's decode shapes, for one tree of the port.

    python3 tools/paged_decode_probe.py [--src TREE/src] [--label NAME]
                                        [--clusters] [--check]

For each pool dtype (bf16, f16) and shape (a decode tick: 18 launches, 4
slots x 49 attended tokens of a 256-token table of 32-token pages; the
long context: 4 slots x 2048 tokens), through the tree's wrappers
(``paged_decode_ragged_cuda`` and, at the decode tick,
``paged_attention_cuda``): the profiler's device ms per tick over the
kernels whose names contain ``paged_decode``, CUDA-event ms, device
kernels per call, SDPA's device ms over the same K/V pre-gathered (q cast
to the page dtype), the byte bound (3.35 TB/s) and the largest per-slot
error against the plain version. ``--clusters`` (a tree whose 16-bit
kernel takes a cluster size) also times the ragged kernel at each
cluster size 1 to 16 by calling the library directly; ``--check`` first
runs chip_smoke's checks of the 16-bit kernels against their plain
versions (``_half_kernel_checks``). Prints the card's
``nvidia-smi`` name and power limit, then one JSON line per row. To
compare two trees, run it once per tree in one call (parent, change,
change, parent).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

LAYERS, SLOTS, HKV, REP, DH, PAGE = 18, 4, 1, 8, 256, 32


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--clusters", action="store_true")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("paged_decode_probe: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib, ref
    from repro_torch.kernels import paged_attention as pa

    cs.device_phase(torch)
    cuda_lib.build_all()
    gen = torch.Generator(device="cuda").manual_seed(5)
    if args.check:
        for dtype in (torch.bfloat16, torch.float16):
            cs._half_kernel_checks(torch, gen, dtype)
    q = torch.randn((SLOTS, HKV, REP, DH), generator=gen, device="cuda")
    one = torch.ones((SLOTS,), dtype=torch.int32, device="cuda")
    for dtype, tol in ((torch.bfloat16, cs.BF16_ATTN_RTOL),
                       (torch.float16, cs.F16_ATTN_RTOL)):
        name = str(dtype).removeprefix("torch.")
        for tokens in (49, cs.LONG_CTX):
            mp = -(-max(tokens, 256) // PAGE)
            pools = [tuple(t.to(dtype) for t in cs._rand_pools(
                torch, gen, SLOTS * mp, HKV, PAGE, DH))
                for _ in range(LAYERS)]
            bt = torch.arange(SLOTS * mp, dtype=torch.int32,
                              device="cuda").reshape(SLOTS, mp)
            ctx = torch.full((SLOTS,), tokens - 1, dtype=torch.int32,
                             device="cuda")
            ctx1 = ctx + 1

            def ragged(kernel=pa.paged_decode_ragged_cuda):
                for kp, vp in pools:
                    kernel(q, kp, vp, bt, ctx, one, w=1)

            def single():
                for kp, vp in pools:
                    pa.paged_attention_cuda(q, kp, vp, bt, ctx1)

            err = max(cs._slot_rel_err(
                torch, pa.paged_decode_ragged_cuda(q, kp, vp, bt, ctx, one,
                                                   w=1),
                ref.paged_decode_ragged_ref(q, kp, vp, bt, ctx, one, w=1))
                for kp, vp in pools[:2])
            gathered = [tuple(ref._gather(p, bt)[:, :, :tokens]
                              .repeat_interleave(REP, 1) for p in pair)
                        for pair in pools]
            q_sdpa = q.reshape(SLOTS, HKV * REP, 1, DH).to(dtype)

            def sdpa():
                for k, v in gathered:
                    F.scaled_dot_product_attention(q_sdpa, k, v)

            nbytes = LAYERS * (SLOTS * HKV * tokens * DH * 2 * 2
                               + 2 * SLOTS * HKV * REP * DH * 4
                               + SLOTS * (mp + 2) * 4)
            row = {"label": args.label, "pages": name, "tokens": tokens,
                   "per": f"{LAYERS} launches, {SLOTS} slots, {tokens} "
                          f"tokens attended each, pages of {PAGE}",
                   "max_slot_rel_err": err, "tol_slot_rel": tol,
                   "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
                   "sdpa_device_ms": cs._device_ms(torch, sdpa, ("",))}
            for mode, fn in (("ragged", ragged), ("single", single)):
                if mode == "single" and tokens != 49:
                    continue
                per_call, names = cs._kernels_per_call(torch, fn, LAYERS)
                row[mode] = {
                    "device_ms": cs._device_ms(torch, fn, ("paged_decode",)),
                    "ms": cs._time_ms(torch, fn),
                    "kernels_per_call": per_call, "kernel_names": names}
            if args.clusters:
                lib = cuda_lib.library("paged_decode")
                entry = getattr(lib, {torch.bfloat16: "paged_decode_ragged_bf16",
                                      torch.float16: "paged_decode_ragged_f16"}[dtype])
                out = torch.empty_like(q)
                stream = torch.cuda.current_stream().cuda_stream
                by = {}
                for c in (1, 2, 4, 8, 16):
                    def tick(c=c):
                        for kp, vp in pools:
                            cuda_lib.check(lib, entry(
                                q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                                bt.data_ptr(), ctx.data_ptr(), one.data_ptr(),
                                out.data_ptr(), SLOTS, HKV, REP, DH, 1, 0,
                                PAGE, mp, c, DH ** -0.5, stream), "probe")
                    by[c] = {"used": pa.cluster_used(dtype, DH, c),
                             "device_ms": cs._device_ms(
                                 torch, tick, ("paged_decode",))}
                row["ragged_by_cluster"] = by
            print(json.dumps(row), flush=True)
            del pools, gathered
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
