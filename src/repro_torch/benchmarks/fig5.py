"""The paper's Figure 5 on the port's device: time per sample of the
784-128-10 MLP against batch size, for the dense arm (``torch.matmul``)
and the sp2_4 arm (``spx_matmul``), timed with CUDA events on the card
(the host clock on the CPU). The paper's figure shows fixed costs
amortized over the batch.

Then the §3.1 pipeline-feasibility margin from ``core.pipeline``'s
``plan_matmul_blocks`` on ``H100_SXM`` for the same three products as the
reference's figure, at 16- and 4-bit weights: whether the copy of the
next tile hides behind the tensor cores' work on the current one, and
whether the planner had to fall back to one ``mxu_dim`` tile because no
candidate tile fits a block's shared memory.

    python -m repro_torch.benchmarks.fig5 [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.benchmarks.timing import (card_line, device_label,
                                           time_per_call)
from repro_torch.core.pipeline import H100_SXM, plan_matmul_blocks
from repro_torch.data import make_dataset
from repro_torch.models.mlp_mnist import paper_mlp_apply, paper_mlp_init
from repro_torch.nn.layers import quantize_params
from repro_torch.runtime import Runtime, resolve_device

__all__ = ["run", "BATCHES", "SHAPES"]

BATCHES = (1, 8, 64, 256, 1024)
#: (m, n, k) of the feasibility table: the paper MLP's first layer at
#: batch 1024, and two LM-sized products
SHAPES = ((1024, 128, 784), (4096, 4096, 4096), (8192, 12800, 4096))


def run(csv_rows: list, device=None, *, iters: int = 30) -> list:
    """Append ``(name, value, extra)`` rows to ``csv_rows`` and return
    them: ``fig5/{arm}_b{B}`` (us/sample, B) and
    ``fig5/pipe_{m}x{n}x{k}_w{bits}`` (margin, 1.0 if pipelined)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = paper_mlp_init(gen, device=device)
    qparams = quantize_params(params, "sp2_4", min_size=1024)
    rt = Runtime(device=str(device))
    x_np, _ = make_dataset(max(BATCHES), seed=9)
    x_all = torch.as_tensor(x_np, device=device)

    label = device_label(device)
    print(f"\n== Fig. 5: us/sample against batch on {label} "
          f"({card_line(device) or 'no card'}) ==")
    for b in BATCHES:
        x = x_all[:b].contiguous()
        for name, p in (("fp32", params), ("sp2_4", qparams)):
            t = time_per_call(lambda p=p: paper_mlp_apply(p, x, rt), device,
                              iters=iters) / b
            print(f"  B={b:5d} {name:6s}: {t * 1e6:10.4f} us/sample")
            csv_rows.append((f"fig5/{name}_b{b}", t * 1e6, b))

    hw = H100_SXM
    print(f"\n== §3.1 pipeline feasibility on {hw.name} (model) ==")
    for m, n, k in SHAPES:
        for bits in (16, 4):
            plan = plan_matmul_blocks(m, n, k, weight_bits=bits, hw=hw)
            fallback = (plan.bm, plan.bn, plan.bk) == (hw.mxu_dim,) * 3
            state = "pipelined" if plan.pipelined else "LOAD-BOUND"
            print(f"  {m}x{n}x{k} w{bits}: blocks ({plan.bm},{plan.bn},"
                  f"{plan.bk}) {plan.vmem_bytes} B margin "
                  f"{plan.margin:6.3f}x -> {state}"
                  + (" (no candidate fits: one mxu_dim tile)"
                     if fallback else ""))
            csv_rows.append((f"fig5/pipe_{m}x{n}x{k}_w{bits}", plan.margin,
                             1.0 if plan.pipelined else 0.0))
    return csv_rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    return run([], device=args.device)


if __name__ == "__main__":
    main()
