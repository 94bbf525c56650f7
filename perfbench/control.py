"""The control of ``correct``: the plain reference put in the program's
place, computed one precision below what the configurations state (f32
with TF32 off, so TF32). It has to read as not correct.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds <s>

For each seed: one run of the cell as ``run.py`` makes it (no trace),
whose check then reads the f32 reference twice over the same finished
requests: in f32 (the program's gap, as a run reads it), and with
TF32 matmuls (the control's gap: at each served position the f32
reference's best logit less its logit of the token that TF32 ranks
first), each against the cell's limit, so that the run's ``correct``
reads false where the control fails. One JSON line per seed on standard
output. The benchmark's own runs do not run this.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, card_line, err, pin_environment  # noqa: E402


def control_checker(run, seed, device, log):
    """The checks of a run whose served tokens are held to the cell's
    limit twice: as the program served them (``gap_max``), and as the
    TF32 reference would have served them (``control_gap_max``: the f32
    reference's best logit less its logit of the token that TF32 ranks
    first). So the run's ``correct`` reads the control."""
    import torch

    from perfbench import check
    reqs = check.finished(run)
    ref, margins = check.reference_logits(run.cell.config, seed, reqs,
                                          device)
    keep = check.decided(margins, run.cell.limits)
    program = check.gaps_of(ref, [r.output for r in reqs])
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        low, _ = check.reference_logits(run.cell.config, seed, reqs, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ctrl = check.gaps_of(ref, [lo.argmax(dim=-1).cpu() for lo in low])
    limit = float(run.cell.limits["gap_max"]["limit"])
    out = {"gap_max": {"value": check.widest(program[keep]), "limit": limit},
           "control_gap_max": {"value": check.widest(ctrl[keep]),
                               "limit": limit},
           "bad_outputs": {"value": check.bad_outputs(run), "limit": 0}}
    info = {"gap_max_all": check.widest(program),
            "control_gap_max_all": check.widest(ctrl),
            "served_tokens": int(program.size),
            "within_margin": int((~keep).sum()),
            "program_flips": int((program > 0).sum()),
            "control_flips": int((ctrl[keep] > 0).sum()),
            "left_out": check.left_out(margins, program, keep)}
    log(f"[control] {json.dumps(out)} {json.dumps(info)}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    pin_environment()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench import harness
    if not torch.cuda.is_available():
        err("[control] needs a CUDA device")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err(f"[control] card: {card_line()}")
    bench = harness.load_bench(ROOT)
    cell = harness.resolve(bench, args.workload, trace=False)
    t_process = T_PROCESS
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(cell, seed, args.seconds, False,
                               t_process=t_process,
                               checker=control_checker)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "checks": res["checks"],
                          "metrics": res["metrics"]}), flush=True)
        t_process = time.monotonic()
    return 0


if __name__ == "__main__":
    sys.exit(main())
