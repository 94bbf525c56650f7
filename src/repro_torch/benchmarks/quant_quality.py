"""Quantization-quality table (the paper's §3.2 claims, made
quantitative), on the port's device:

* per-scheme weight-quantization SNR on Gaussian and heavy-tailed weights
  (PoT collapses at the tails; SP2/SPx recover: Eq. 3.3/3.4's point);
* the tail-region level density per scheme;
* end-task accuracy of the trained paper MLP under each scheme, each
  quantized layer through ``spx_matmul``.

The MLP trains with the port's SGD (lr 0.5, B = 64) under autograd on
dense f32 params, as the reference trains it.

    python -m repro_torch.benchmarks.quant_quality [--device cpu]
"""
from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from repro_torch.benchmarks.timing import device_label
from repro_torch.core import spx
from repro_torch.core.quantized import dequantize, quantize_weight
from repro_torch.data import SynthDigits
from repro_torch.examples.quickstart import SCHEMES, accuracy, train_steps
from repro_torch.models.mlp_mnist import paper_mlp_init
from repro_torch.nn.layers import quantize_params
from repro_torch.runtime import Runtime, resolve_device
from repro_torch.training import make_optimizer

__all__ = ["run", "SCHEMES", "weight_snr"]


def weight_snr(scheme: str, w: torch.Tensor) -> float:
    """20 log10(|w| / |w - dequant(quant(w))|), in dB."""
    wh = dequantize(quantize_weight(w, scheme, pack=False), torch.float32)
    err = torch.linalg.norm(wh - w)
    return float(20 * torch.log10(torch.linalg.norm(w) / (err + 1e-12)))


def _train_mlp(device, steps: int):
    data = SynthDigits(n_train=4096, n_test=1024, batch_size=64)
    params = paper_mlp_init(torch.Generator(device=device).manual_seed(0),
                            device=device)
    opt = make_optimizer("sgd", lr=0.5)
    params, _, _ = train_steps(params, opt, opt.init(params),
                               itertools.islice(data.batches(epochs=100),
                                                steps), device)
    return params, data


def run(csv_rows: list, device=None, *, steps: int = 400) -> list:
    """Append ``(name, value, extra)`` rows to ``csv_rows`` and return
    them: the f32 accuracy, and per scheme its Gaussian SNR (with the tail
    density) and its accuracy (with the drop from f32)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    gauss = torch.as_tensor(rng.standard_normal((256, 256)) * 0.04,
                            dtype=torch.float32, device=device)
    heavy = torch.as_tensor(rng.standard_t(3, (256, 256)) * 0.04,
                            dtype=torch.float32, device=device)
    rt = Runtime(device=str(device))

    print(f"\n== quantization quality on {device_label(device)} (weight "
          "SNR dB / tail density / MLP accuracy) ==")
    params, data = _train_mlp(device, steps)
    x_test = torch.as_tensor(data.x_test, device=device)
    y_test = torch.as_tensor(data.y_test, device=device)
    base_acc = accuracy(params, x_test, y_test, rt)
    print(f"  float32: MLP acc {base_acc:.4f} ({steps} SGD steps)")
    csv_rows.append(("quant/float32_acc", base_acc, 0.0))
    for scheme in SCHEMES:
        lv = spx.scheme_levels(scheme)
        width = spx.code_width(lv)
        tail = float(np.sum((lv >= 0.5) & (lv <= 1.0)) / len(lv))
        snr_g = weight_snr(scheme, gauss)
        snr_h = weight_snr(scheme, heavy)
        acc = accuracy(quantize_params(params, scheme, min_size=1024),
                        x_test, y_test, rt)
        print(f"  {scheme:10s} ({width}b): snr_gauss {snr_g:6.2f}dB "
              f"snr_heavy {snr_h:6.2f}dB tail {tail:.3f} acc {acc:.4f} "
              f"(d {acc - base_acc:+.4f})")
        csv_rows.append((f"quant/{scheme}_snr_gauss", snr_g, tail))
        csv_rows.append((f"quant/{scheme}_snr_heavy", snr_h, tail))
        csv_rows.append((f"quant/{scheme}_acc", acc, acc - base_acc))
    return csv_rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    return run([], device=args.device)


if __name__ == "__main__":
    main()
