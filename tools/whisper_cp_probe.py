#!/usr/bin/env python3
"""whisper-small's context-parallel prefill on one CUDA card, in a fresh
process: the quick call for that path alone, and its kernel-4 timings
where ``chip_smoke.py``'s long process lets the profiler drop library
kernel events.

    python3 tools/whisper_cp_probe.py

Through ``chip_smoke.py``'s own functions: the build; every launch shape
of the whisper serve steps at mesh (2, 4) against its plain version
(``_whisper_mesh_kernel_checks``); the context-parallel,
tensor-parallel and one-device prefills at full width, 16 rows of 1500
frames and a 448-token prompt (``_serve_mesh_whisper``, with
``REPRO_FORCE_DEVICE_COUNT`` = 8 set for it); the dry run of the
context-parallel step on ``meta`` against the card's per-device state
bytes and collective counters; then kernel 4 beside SDPA (device ms,
CUDA-event ms, device kernels a call of each) at a context-parallel
shard's three shapes and at gemma-2b's 33-token admitted request.
Prints the card's ``nvidia-smi`` name and power limit, then JSON lines;
exits 1 on a failed check.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.dryrun import dry_report
    from repro_torch.launch.mesh import make_host_mesh

    if not torch.cuda.is_available():
        print("whisper_cp_probe: no CUDA device visible", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        info = cs.device_phase(torch)
        print(info["nvidia_smi"])
        cs.emit({"phase": "build", "seconds": cuda_lib.build_all()})
        checked = set()
        worst = {op: 0.0 for op in cs.SHARDED_OPS}
        cs._whisper_mesh_kernel_checks(
            torch, torch.Generator(device="cuda").manual_seed(41), checked,
            worst)
        with cs._forced_shards(cs.MESH[0] * cs.MESH[1]):
            runs = cs._serve_mesh_whisper(torch, np, info["nvidia_smi"],
                                          checked)
        card = runs["whisper-small prefill-cp"]
        rep = dry_report(cs._whisper_config(), ShapeConfig(
            "prefill-cp", cs.WHISPER_MESH_PROMPT, cs.MESH_BATCH, "prefill"),
            make_host_mesh(*cs.MESH, ["meta"] * (cs.MESH[0] * cs.MESH[1])),
            dtype=torch.float32, param_dtype=torch.float32, prefill_cp=True)
        by_dev = rep["argument_by_device"]
        dry = [[by_dev["params"][d][m] + by_dev["caches"][d][m]
                for m in range(cs.MESH[1])] for d in range(cs.MESH[0])]
        equal = (dry == card["per_device_state_bytes"]
                 and rep["collectives"]["by_device"] == card["collectives"])
        cs.emit({"phase": "dryrun", "cell": "whisper-small prefill-cp",
                 "per_device_state_bytes": dry,
                 "collectives_busiest": rep["collectives"]["busiest"],
                 "equal_to_card": equal})
        cs.require(equal, "dry run of the context-parallel step against "
                          "the card's")
        gen = torch.Generator(device="cuda").manual_seed(5)
        rows = cs._whisper_cp_flash_timing(torch, gen,
                                           card["launches_by_shape"])
        rows["gemma-2b 33 tokens"] = cs._flash_timing(
            torch, gen, get_config("gemma-2b"))
        for name, row in rows.items():
            cs.emit({"phase": "timing", "row": name, "card":
                     info["nvidia_smi"], **row})
    except cs.Failed as exc:
        print(f"whisper_cp_probe: FAILED: {exc}", file=sys.stderr)
        return 1
    cs.emit({"phase": "done", "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
