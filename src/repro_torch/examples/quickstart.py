"""Quickstart: the paper's §4.1 experiment end to end, on the port.

Trains the 784-128-10 sigmoid MLP (MSE loss, SGD, B = 64, eta = 0.5:
Eq. 4.4-4.6) on the procedural MNIST-like digits under autograd, then
deploys it through the SPx-quantized matmul (``quantize_params(...,
min_size=1024)``, each quantized layer through ``spx_matmul``: the
hand-written kernel on the card) and compares test accuracy across
quantization schemes (the §3.2 story: PoT collapses at the tails, SP2/SPx
recover).

    python -m repro_torch.examples.quickstart [--epochs 4] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.benchmarks.timing import device_label, time_per_call
from repro_torch.core import spx
from repro_torch.data import SynthDigits
from repro_torch.models.mlp_mnist import (paper_mlp_init, paper_mlp_loss,
                                          paper_mlp_predict)
from repro_torch.nn.layers import quantize_params
from repro_torch.runtime import Runtime, resolve_device
from repro_torch.training import make_optimizer, value_and_grad

__all__ = ["main", "accuracy", "train_steps", "SCHEMES"]

SCHEMES = ("uniform4", "pot4", "sp2_4", "uniform8", "sp2_8", "spx_8_x3")


def accuracy(params, x: torch.Tensor, y: torch.Tensor,
             rt: Runtime | None = None) -> float:
    return float((paper_mlp_predict(params, x, rt) == y).float().mean())


def train_steps(params, opt, state, batches, device):
    """One SGD step of the paper MLP's loss (Eq. 4.4-4.6, autograd on dense
    f32 params) per ``(x, y)`` of ``batches``. Returns ``(params, state,
    losses)``."""
    losses = []
    for x, y in batches:
        loss, grads = value_and_grad(
            paper_mlp_loss, params, torch.as_tensor(x, device=device),
            torch.as_tensor(y, device=device))
        params, state = opt.update(params, grads, state)
        losses.append(loss)
    return params, state, losses


def main(argv=None, device=None) -> dict:
    """Train, then evaluate every scheme. Returns ``{"float32": acc,
    scheme: acc, ...}``. ``device``: ``cuda`` unless given (here or as
    ``--device``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=64)     # paper: B=64
    ap.add_argument("--lr", type=float, default=0.5)     # paper: eta=0.5
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(device if device is not None else args.device)
    rt = Runtime(device=str(device))

    data = SynthDigits(n_train=8192, n_test=2048, batch_size=args.batch)
    params = paper_mlp_init(torch.Generator(device=device).manual_seed(0),
                            device=device)
    opt = make_optimizer("sgd", lr=args.lr)
    state = opt.init(params)
    x_test = torch.as_tensor(data.x_test, device=device)
    y_test = torch.as_tensor(data.y_test, device=device)

    print(f"== training {args.epochs} epochs (SGD lr={args.lr} "
          f"B={args.batch}, MSE loss: paper Eq. 4.4-4.6) on "
          f"{device_label(device)} ==")
    for epoch in range(args.epochs):
        params, state, losses = train_steps(params, opt, state,
                                            data.batches(), device)
        acc = accuracy(params, x_test, y_test)
        print(f"epoch {epoch + 1}: loss "
              f"{float(torch.stack(losses).mean()):.4f} test acc {acc:.4f}")

    print("\n== quantized inference (paper §3.2 schemes) ==")
    fp_acc = accuracy(params, x_test, y_test, rt)
    results = {"float32": fp_acc}
    for scheme in SCHEMES:
        qp = quantize_params(params, scheme, min_size=1024)
        acc = accuracy(qp, x_test, y_test, rt)
        width = spx.code_width(spx.scheme_levels(scheme))
        results[scheme] = acc
        print(f"  {scheme:10s} ({width}-bit): acc {acc:.4f} "
              f"(drop {fp_acc - acc:+.4f})")

    t = time_per_call(lambda: paper_mlp_predict(params, x_test, rt), device,
                      iters=20) / len(x_test)
    print(f"\nper-sample inference ({device_label(device)}, fp32, batch "
          f"{len(x_test)}): {t * 1e6:.4f} us")
    print("(Table 1 and Fig. 5 on this device: "
          "python -m repro_torch.benchmarks.table1, ...fig5)")
    return results


if __name__ == "__main__":
    main()
