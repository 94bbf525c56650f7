#!/usr/bin/env python3
"""Where the time of the port's tensor-core kernels goes, by ablation.

    python3 tools/kernel_ablation.py [KERNEL ...]

Runs on one CUDA card. Builds copies of ``spx_matmul.cu``,
``flash_attention.cu`` and ``paged_decode.cu`` with one stage of the
kernel removed (the results of those copies are wrong by design), times
each beside the full kernel with the profiler's device time at the
serving path's shapes, and prints one JSON line per variant after the
card's ``nvidia-smi`` name and power limit:

  * ``spx_matmul`` prefill tick: gemma-2b's seven projections of 18
    layers, sp2_4 codes (random, from a seed), M = 128 rows; variants
    without the MMAs, without the code decode of every step after the
    first, without the split of x into bf16 planes;
  * ``flash_attention`` per admitted request: 18 launches, causal, 33
    tokens, 8 query heads over one KV head of 256; variants without the
    Q K^T MMAs, without the P V MMAs, without the split of each K/V tile;
  * ``paged_decode_mma_kernel`` (kernels 2 and 5 on bf16 pages) per
    decode tick: 18 launches, 4 slots x 1 KV head of 256 x 8 rows,
    32-token pages, 49 tokens of a 256-token table at clusters of 1 and
    4, and 2048 tokens at 8 and 16; variants without the K/V copies,
    without the MMAs, with q's first plane alone in Q K^T, without the
    softmax's exponentials, without the output's stores (a cluster of
    one), without any merge, without the cluster ranks' merge after their
    barrier, with nothing after q's planes (the set-up), and with nothing
    at all (the launch).

  * ``spx_small``: the paper MLP's forward, (784, 128) then (128, 10),
    sp2_4 codes, at M = 1, 64 and 1024, on the decode or prefill kernel
    (the path the parent tree took) and on the small-layer kernel (the
    path ``plan_spx_launch`` takes): the old kernels with nothing done
    (an empty launch), without the MMAs, the decode or the split of x;
    the small kernel with nothing done, with the staging alone, without
    the MMAs, without the LUT lookups, without staging x or the codes,
    without the warps' sums and the stores; also the first layer alone.

``KERNEL`` names limit the run to those kernels. Each variant is timed twice, in the order full, variants, variants
reversed, full, so drift between the first and last rounds shows.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

SPX_CUTS = {
    "no_mma": ("      for (int p = 0; p < 3; ++p) "
               "wgmma_m64n256k16(acc, a[p][j], d_b + 2 * j);", ""),
    "no_decode": ("      if (more) decode(u + 1, j);\n", ""),
    "no_x_split": ("  hi = bf16x2_bits(h);\n  mid = bf16x2_bits(m);\n"
                   "  lo = bf16x2_bits(__floats2bfloat162_rn(r.x - mf.x, "
                   "r.y - mf.y));",
                   "  hi = __float_as_uint(v.x);\n  mid = hi;\n  lo = hi;"),
}
OLD_SPX_CUTS = {
    "mma_empty": ("  cg::cluster_group cluster = cg::this_cluster();\n"
                  "  // two buffers of W's planes",
                  "  cg::cluster_group cluster = cg::this_cluster();\n"
                  "  return;\n  // two buffers of W's planes"),
    "skinny_empty": ("  __shared__ float s_sum[MT * kBlockN];                "
                     "// the block's sums\n",
                     "  __shared__ float s_sum[MT * kBlockN];\n  return;\n"),
}
SMALL_CUTS = {
    "small_empty": ("  extern __shared__ __align__(16) uint8_t "
                    "smem_small[];\n",
                    "  extern __shared__ __align__(16) uint8_t "
                    "smem_small[];\n  return;\n"),
    "small_stage_only": ("  __syncwarp();               // the warp's stage "
                         "has landed\n",
                         "  __syncwarp();\n  return;\n"),
    "small_no_mma": ("          mma16816(acc[i][j], a, b[p][i][0], "
                     "b[p][i][1]);",
                     "          acc[i][j][p] += __uint_as_float(a[0] ^ a[1] ^ "
                     "a[2] ^ a[3] ^ b[p][i][0] ^ b[p][i][1]);"),
    "small_no_lookup": ("        const uint2 e0 = lookup4(t_hi, q0), e1 = "
                        "lookup4(t_hi, q1);",
                        "        const uint2 e0 = make_uint2(q0, q1), e1 = "
                        "make_uint2(c, q0 ^ q1);"),
    "small_no_x_stage": ("        cp_async16(dst, src, 16);",
                         "        (void)src;"),
    "small_no_code_stage": ("          cp_async_ca<S::kCopy>(dst + piece * "
                            "S::kCopy,\n                                codes "
                            "+ (size_t)r * row_bytes + b0);",
                            "          (void)dst;"),
    "small_no_epilogue": (
        "  __syncthreads();            // every warp is done with the staged "
        "tiles\n",
        "  float z = 0.f;\n#pragma unroll\n  for (int i = 0; i < I; ++i)\n"
        "#pragma unroll\n    for (int j = 0; j < J; ++j)\n      z += "
        "acc[i][j][0] + acc[i][j][1] + acc[i][j][2] + acc[i][j][3];\n"
        "  if (z == 1.2345f) out[0] = z;\n  return;\n"),
}
FLASH_CUTS = {
    "no_qk_mma": ("        mma3(s[2 * jp], ah, al, kh[0], kh[1], kl[0], "
                  "kl[1]);\n        mma3(s[2 * jp + 1], ah, al, kh[2], "
                  "kh[3], kl[2], kl[3]);\n", ""),
    "no_pv_mma": ("        mma3(o[2 * dp], ph, pl, vh[0], vh[1], vl[0], "
                  "vl[1]);\n        mma3(o[2 * dp + 1], ph, pl, vh[2], "
                  "vh[3], vl[2], vl[3]);\n", ""),
    "no_kv_split": ("    split_rows<T, DH>(stage, kv_pl, kPlane, kBkv);\n"
                    "    split_rows<T, DH>(stage + kBkv * DH, kv_pl + 2 * "
                    "kPlane, kPlane, kBkv);\n", ""),
}
PAGED_CUTS = {
    "no_loads": ("    cp_async16(ks + t * ROWB + c * 16, kp + src, bytes);\n"
                 "    cp_async16(vs + t * ROWB + c * 16, vp + src, bytes);\n",
                 ""),
    "no_mma": [("        H::mma(sp[p][0], ka[kc & 1][0], qb[kc & 1][p][0], "
                "qb[kc & 1][p][1]);\n        H::mma(sp[p][1], ka[kc & 1][1], "
                "qb[kc & 1][p][2], qb[kc & 1][p][3]);\n", ""),
               ("      H::mma(o[mt], va[mt & 1], b0, b1);\n", "")],
    "one_plane": ("      for (int p = 0; p < H::kPlanes; ++p) {\n"
                  "        H::mma(sp[p][0]",
                  "      for (int p = 0; p < 1; ++p) {\n        H::mma(sp[p][0]"),
    "no_exp": [("      corr[k] = exp2f(m_run[k] - m_new);",
                "      corr[k] = 1.f;"),
               ("      p[e] = ok ? exp2f(s[e] - m_run[e & 1]) : 0.f;",
                "      p[e] = ok ? s[e] : 0.f;")],
    "no_store": ("        *reinterpret_cast<float4*>(out + (qrow0 + row0 + n) * DH "
                 "+ d) =\n            make_float4(a.x / l, a.y / l, a.z / l, "
                 "a.w / l);\n",
                 "        if (a.x == -12345.f) out[0] = l;\n"),
    "no_merge": ("  // each warp's (m, l, O) into its own stages (its copies "
                 "have landed),\n", "  return;\n"),
    "no_cluster_merge": ("  cluster.sync();\n  const int quads",
                         "  cluster.sync();\n  return;\n  const int quads"),
    "setup_only": ("  __syncthreads();                  // q's planes and row "
                   "factors are written\n",
                   "  __syncthreads();\n  cp_async_wait<0>();\n  return;\n"),
    "empty": ("  cg::cluster_group cluster = cg::this_cluster();\n",
              "  cg::cluster_group cluster = cg::this_cluster();\n  return;\n"),
}


def build(name: str, cuts: dict, out_dir: Path) -> dict:
    """Compile the full source and each cut of it in parallel; returns
    {variant: loaded library}."""
    from repro_torch.kernels import cuda_lib
    src = (CSRC / f"{name}.cu").read_text()
    texts = {"full": src}
    for tag, cut in cuts.items():
        text = src
        for old, new in cut if isinstance(cut, list) else [cut]:
            if old not in text:
                raise SystemExit(f"{name}.cu: the {tag} cut no longer "
                                 "matches")
            text = text.replace(old, new)
        texts[tag] = text
    procs = {}
    for tag, text in texts.items():
        cu = out_dir / f"{name}_{tag}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[tag] = (subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for tag, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name} {tag}:\n{log}")
        libs[tag] = ctypes.CDLL(str(so))
    return libs


def device_ms(torch, fn, key: str, reps: int = 3) -> float:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and key in e.name)
    return us / 1e3 / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.core import spx
    from repro_torch.kernels import cuda_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = cuda_lib.build_dir() / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)

    only = sys.argv[1:]
    spx_cuts = {}
    if not only or "spx_matmul" in only:
        spx_cuts.update(SPX_CUTS)
    if not only or "spx_small" in only:
        spx_cuts.update(OLD_SPX_CUTS, **SMALL_CUTS, **SPX_CUTS)
    spx_all = build("spx_matmul", spx_cuts, out_dir) if spx_cuts else {}
    spx_libs = {t: spx_all[t] for t in ("full", *SPX_CUTS) if t in spx_all}
    flash_libs = (build("flash_attention", FLASH_CUTS, out_dir)
                  if not only or "flash_attention" in only else {})

    # spx_matmul: the prefill tick of gemma-2b, M = 128
    m = 128
    shapes = [(2048, 2048), (2048, 256), (2048, 256), (2048, 2048),
              (2048, 16384), (2048, 16384), (16384, 2048)]
    lut = spx.codebook(spx.scheme_levels("sp2_4"), device="cuda")
    layers = [[(torch.randint(0, 16, (k, n // 2), generator=gen,
                              device="cuda", dtype=torch.int32)
                .to(torch.uint8),
                torch.rand((1, n), generator=gen, device="cuda"))
               for k, n in shapes] for _ in range(18)]
    xs = {k: torch.randn((m, k), generator=gen, device="cuda")
          for k in (2048, 16384)}
    outs = {n: torch.empty((m, n), device="cuda") for n in (256, 2048, 16384)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def spx_tick(lib):
        lib.spx_matmul_splits.argtypes = [I] * 4
        lib.spx_matmul_f32.argtypes = [P] * 5 + [I] * 10 + [P]
        splits = {s: lib.spx_matmul_splits(m, *s, sms) for s in shapes}

        def run():
            for lw in layers:
                for (k, n), (codes, scale) in zip(shapes, lw):
                    lib.spx_matmul_f32(xs[k].data_ptr(), codes.data_ptr(),
                                       scale.data_ptr(), lut.data_ptr(),
                                       outs[n].data_ptr(), m, k, n, 1,
                                       lut.numel(), 1, splits[(k, n)], 0, 0,
                                       0, stream)
        return run

    # flash_attention: one admitted request of the dense path
    s, hq, dh = 33, 8, 256
    qkv = [(torch.randn((1, hq, s, dh), generator=gen, device="cuda"),
            torch.randn((1, 1, s, dh), generator=gen, device="cuda"),
            torch.randn((1, 1, s, dh), generator=gen, device="cuda"))
           for _ in range(18)]
    o = torch.empty((1, hq, s, dh), device="cuda")

    def flash_request(lib):
        lib.flash_attention_f32.argtypes = [P] * 4 + [I] * 10 + [
            ctypes.c_float, P]

        def run():
            for q, k, v in qkv:
                lib.flash_attention_f32(q.data_ptr(), k.data_ptr(),
                                        v.data_ptr(), o.data_ptr(), 1, hq,
                                        hq, s, s, dh, 1, 0, 64, 32,
                                        dh ** -0.5, stream)
        return run

    # the 16-bit paged decode kernel: gemma-2b's decode tick on bf16 pages
    paged_libs = (build("paged_decode", PAGED_CUTS, out_dir)
                  if not only or "paged_decode_mma_kernel" in only else {})
    slots, dh, rep, ps = 4, 256, 8, 32
    q8 = torch.randn((slots, 1, rep, dh), generator=gen, device="cuda")
    one = torch.ones((slots,), dtype=torch.int32, device="cuda")
    o8 = torch.empty_like(q8)
    paged_cases = {}
    for tokens, clusters in ((49, (1, 4)), (2048, (8, 16))):
        mp = max(tokens, 256) // ps
        pools = [tuple(torch.randn((slots * mp, 1, ps, dh), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(2)) for _ in range(18)]
        bt = torch.arange(slots * mp, dtype=torch.int32,
                          device="cuda").reshape(slots, mp)
        ctx = torch.full((slots,), tokens - 1, dtype=torch.int32,
                         device="cuda")
        for c in clusters:
            paged_cases[(tokens, c)] = (pools, bt, ctx, mp)

    def paged_tick(tokens, c):
        pools, bt, ctx, mp = paged_cases[(tokens, c)]

        def make(lib):
            lib.paged_decode_ragged_bf16.argtypes = [P] * 7 + [I] * 9 + [
                ctypes.c_float, P]

            def run():
                for kp, vp in pools:
                    lib.paged_decode_ragged_bf16(
                        q8.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                        bt.data_ptr(), ctx.data_ptr(), one.data_ptr(),
                        o8.data_ptr(), slots, 1, rep, dh, 1, 0, ps, mp, c,
                        dh ** -0.5, stream)
            return run
        return make

    runs = [("spx_matmul", spx_libs, "prefill tick: 126 launches, M=128",
             spx_tick, "spx_matmul_kernel"),
            ("flash_attention", flash_libs,
             "admitted request: 18 launches, causal 33 tokens", flash_request,
             "flash_attention_kernel")]
    runs += [("paged_decode_mma_kernel", paged_libs,
              f"decode tick: 18 launches, 4 slots x {tokens} tokens, bf16 "
              f"pages of {ps}, cluster {c}", paged_tick(tokens, c),
              "paged_decode_mma_kernel") for tokens, c in paged_cases]
    # the paper MLP's two layers on the old kernels and the small one
    from repro_torch.runtime import planner
    from repro_torch.kernels.spx_matmul import PATH_IDS
    paper = [(784, 128), (128, 10)]
    paper_w = [(torch.randint(0, 256, (k, n // 2), generator=gen,
                              device="cuda", dtype=torch.int32)
                .to(torch.uint8),
                torch.rand((1, n), generator=gen, device="cuda"))
               for k, n in paper]

    def paper_forward(m, small, layers=2):
        xs_p = [torch.rand((m, k), generator=gen, device="cuda")
                for k, _ in paper[:layers]]
        outs_p = [torch.empty((m, n), device="cuda")
                  for _, n in paper[:layers]]

        def make(lib):
            lib.spx_matmul_splits.argtypes = [I] * 4
            lib.spx_matmul_f32.argtypes = [P] * 5 + [I] * 10 + [P]
            plans = []
            for k, n in paper[:layers]:
                if small:
                    p = planner.plan_spx_launch(m, k, n, True, 16, sms)
                    plans.append((PATH_IDS["small"], 1, p.tile_m, p.tile_n,
                                  p.warps))
                else:
                    plans.append((PATH_IDS["skinny" if m <= 8 else "mma"],
                                  lib.spx_matmul_splits(m, k, n, sms), 0, 0,
                                  0))

            def run():
                for (k, n), (codes, scale), x, o, plan in zip(
                        paper, paper_w, xs_p, outs_p, plans):
                    err = lib.spx_matmul_f32(
                        x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                        lut.data_ptr(), o.data_ptr(), m, k, n, 1,
                        lut.numel(), *plan, stream)
                    if err:
                        raise SystemExit(f"spx_small: CUDA error {err} at "
                                         f"{(m, k, n, plan)}")
            return run
        return make

    if spx_all and (not only or "spx_small" in only):
        old_tags = ("full", *OLD_SPX_CUTS, *SPX_CUTS)
        small_tags = ("full", *SMALL_CUTS)
        for m in (1, 64, 1024):
            runs.append(("spx_small", {t: spx_all[t] for t in old_tags},
                         f"paper MLP forward, M={m}, "
                         f"{'skinny' if m <= 8 else 'mma'} kernel (parent's "
                         "path)", paper_forward(m, False), "spx_matmul"))
            runs.append(("spx_small", {t: spx_all[t] for t in small_tags},
                         f"paper MLP forward, M={m}, small kernel",
                         paper_forward(m, True), "spx_matmul"))
            runs.append(("spx_small", {t: spx_all[t] for t in small_tags},
                         f"paper MLP layer (784, 128) alone, M={m}, small "
                         "kernel", paper_forward(m, True, 1), "spx_matmul"))
    for kernel, libs, per, make, key in runs:
        if only and kernel not in only:
            continue
        order = list(libs) + list(libs)[::-1]
        times: dict[str, list] = {tag: [] for tag in libs}
        for tag in order:
            times[tag].append(device_ms(torch, make(libs[tag]), key))
        for tag, t in times.items():
            print(json.dumps({"kernel": kernel, "per": per, "variant": tag,
                              "device_ms": t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
