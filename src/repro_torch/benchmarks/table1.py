"""The paper's Table 1 on the device the port runs on: time and energy per
sample of the 784-128-10 MLP.

The paper measured a CPU (2.6 ms/sample, 47.2 W), a GPU (0.3 ms, 115.2 W)
and its FPGA (1.6 us, 10 W). Here, on the port's device:

* ``fp32``: the dense forward (``torch.matmul``);
* ``sp2_4``: both layers quantized (``quantize_params(..., "sp2_4",
  min_size=1024)``), each through ``spx_matmul`` (the hand-written kernel
  on the card);

each at batch 1 and 1024, timed with CUDA events after a warm-up (the host
clock on the CPU). Energy per sample is the time per sample x the power
``nvidia-smi`` reads (``power.draw``) during the timed loop; without a
reading the row takes the card's ``power.limit`` and says it is a bound.
On the CPU no power is read and energy is None. The paper's three rows
follow, labelled as the paper's.

    python -m repro_torch.benchmarks.table1 [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.benchmarks.timing import (PowerSampler, card_line,
                                           device_label, time_per_call)
from repro_torch.data import make_dataset
from repro_torch.models.mlp_mnist import paper_mlp_apply, paper_mlp_init
from repro_torch.nn.layers import quantize_params
from repro_torch.runtime import Runtime, resolve_device

__all__ = ["run", "PAPER_ROWS", "BATCHES"]

BATCHES = (1, 1024)
#: the paper's Table 1: (row, seconds per sample, watts)
PAPER_ROWS = (("paper_cpu", 2.6e-3, 47.2), ("paper_gpu", 3e-4, 115.2),
              ("paper_fpga", 1.6e-6, 10.0))


def run(csv_rows: list, device=None, *, iters: int = 30,
        min_seconds: float = 1.0) -> list:
    """Measure the two arms at each batch; append ``(name, us/sample,
    uJ/sample)`` to ``csv_rows`` and return the rows, each a dict with the
    device, the power source and the numbers."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = paper_mlp_init(gen, device=device)
    qparams = quantize_params(params, "sp2_4", min_size=1024)
    rt = Runtime(device=str(device))
    x_np, _ = make_dataset(max(BATCHES), seed=7)
    x_all = torch.as_tensor(x_np, device=device)
    label = device_label(device)
    rows = []
    for batch in BATCHES:
        x = x_all[:batch].contiguous()
        for arm, p in (("fp32", params), ("sp2_4", qparams)):
            with PowerSampler(device) as power:
                t = time_per_call(lambda p=p: paper_mlp_apply(p, x, rt),
                                  device, iters=iters,
                                  min_seconds=min_seconds) / batch
            watts, source = power.watts(), "power.draw"
            if watts is None:
                watts = power.limit_watts()
                source = "power.limit (a bound)" if watts else None
            rows.append({"name": f"{arm}_b{batch}", "device": label,
                         "s_per_sample": t, "watts": watts,
                         "power_source": source,
                         "j_per_sample": t * watts if watts else None})
    for name, t, watts in PAPER_ROWS:
        rows.append({"name": name, "device": "the paper's measurement",
                     "s_per_sample": t, "watts": watts,
                     "power_source": "the paper", "j_per_sample": t * watts})
    print(f"\n== Table 1: time/sample and energy/sample on {label} "
          f"({card_line(device) or 'no card'}) ==")
    for r in rows:
        e = r["j_per_sample"]
        print(f"  {r['name']:12s} {r['device']:26s} "
              f"{r['s_per_sample'] * 1e6:12.4f} us/sample "
              + (f"{e * 1e6:12.6f} uJ/sample ({r['watts']:.1f} W, "
                 f"{r['power_source']})" if e is not None
                 else "energy not measured"))
        csv_rows.append((f"table1/{r['name']}", r["s_per_sample"] * 1e6,
                         e * 1e6 if e is not None else None))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    return run([], device=args.device)


if __name__ == "__main__":
    main()
