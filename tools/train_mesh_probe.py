"""Time the train step under a (data 2, model 4) mesh on one card, from a
given source tree, so that two trees can be compared in one run on the
same card.

gemma-2b at its published width and depth, f32 weights from a seed,
remat ``full``, 256-token rows: the cells of ``chip_smoke.py``'s
``train_mesh`` phase (``fsdp``: 8 rows, AdamW; ``tp``: 4 rows, AdamW-Q8,
2 microbatches), eight mesh devices on the one card
(``REPRO_FORCE_DEVICE_COUNT=8``, set here). For each cell it prints one
JSON line: the host milliseconds of each step (the first warms up),
``max_memory_allocated`` over the steps, and with ``--profile`` the
functions taking the most cumulative time in the last step (cProfile).

  python tools/train_mesh_probe.py --src build/parent/src --label parent
  python tools/train_mesh_probe.py --src src --label change --profile

Needs a card. Builds the flash kernel in ``REPRO_TORCH_BUILD_DIR`` (or
the checkout's default), which runs of two trees with the same kernel
sources share.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import sys
import time

CELLS = {"fsdp": (8, {}),
         "tp": (4, {"optimizer": "adamw_q8", "accum_steps": 2})}
SEQ = 256


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True,
                    help="the source tree holding repro_torch")
    ap.add_argument("--label", required=True)
    ap.add_argument("--cells", nargs="+", default=["tp", "fsdp"],
                    choices=sorted(CELLS))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    os.environ["REPRO_FORCE_DEVICE_COUNT"] = "8"
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.hostdev import device_list
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.lm import lm_init

    cfg = get_config("gemma-2b")
    mesh = make_host_mesh(2, 4, device_list())
    for cell in args.cells:
        b, knobs = CELLS[cell]
        bundle = build_train_step(cfg, ShapeConfig("probe", SEQ, b, "train"),
                                  mesh, dtype=torch.float32, **knobs)
        gen = torch.Generator().manual_seed(61 + b)
        batches = [{k: torch.randint(0, cfg.vocab_size, (b, SEQ),
                                     generator=gen, dtype=torch.int32)
                    for k in ("tokens", "labels")}
                   for _ in range(args.steps)]
        params = lm_init(torch.Generator(device="cuda").manual_seed(71), cfg,
                         device="cuda")
        grid, ostate = bundle.place(params)
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms, top = [], None
        for i, bt in enumerate(batches):
            prof = (cProfile.Profile() if args.profile
                    and i == len(batches) - 1 else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if prof is not None:
                prof.enable()
            grid, ostate, m = bundle.fn(grid, ostate, bt)
            torch.cuda.synchronize()
            if prof is not None:
                prof.disable()
                out = io.StringIO()
                pstats.Stats(prof, stream=out).sort_stats(
                    "cumulative").print_stats(25)
                top = out.getvalue().splitlines()
            ms.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({
            "probe": "train_mesh", "label": args.label, "cell": cell,
            "meta": {k: str(v) for k, v in bundle.meta.items()},
            "host_ms": ms, "loss": float(m["loss"]),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "card": torch.cuda.get_device_name(0)}), flush=True)
        if top is not None:
            print("\n".join(top), flush=True)
        del grid, ostate, bundle
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
