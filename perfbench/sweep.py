"""The knee of an open-loop cell: the highest arrival rate its engine
sustains without a growing backlog. Run once, when the cell is defined;
the cell then offers a fixed rate (its traffic file's ``rate_per_s``).

    python3 perfbench/sweep.py --workload <cell> --seed <n> \
        --rates 2,4,6,8 --seconds <s>

One set-up; then for each rate the cell's traffic at that rate (its ramp,
then ``--seconds`` of window), the engine emptied between rates. One JSON
line per rate: requests due and admitted in the window, the queue at the
window's opening and end, and the TTFT and queue-wait tails.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, card_line, err, pin_environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    pin_environment()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import tempfile

    import torch

    from perfbench import harness, readers
    from perfbench.traffic import Traffic
    from repro_torch.runtime import Runtime
    from repro_torch.serving import Request, ServeConfig, ServeEngine
    if not torch.cuda.is_available():
        err("[sweep] needs a CUDA device")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    err(f"[sweep] card: {card_line()}")
    cell = harness.resolve(harness.load_bench(ROOT), args.workload,
                           trace=False)
    arch = cell.config["arch"]
    dev = torch.device("cuda")
    params = harness.build_params(arch, cell.config["quantized"]["scheme"],
                                  args.seed, dev)
    eng = ServeEngine(params, harness.arch_config(cell.config),
                      ServeConfig(**cell.traffic["serve"]), rt=Runtime())
    del params
    probe = harness.Run(cell, arch, args.seconds, T_PROCESS)
    inst = harness.Instruments(probe, dev)
    harness._warm_up(eng, Request, Traffic(cell.traffic, args.seed,
                                           arch["vocab_size"], stream=1),
                     eng.config.prefill_chunk, err)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        spec = dict(cell.traffic, rate_per_s=rate)
        run = harness.Run(cell, arch, args.seconds, T_PROCESS)
        inst.run = run
        eng.reset_metrics()
        with tempfile.TemporaryDirectory() as tmp:
            harness.serve(run, eng, Request, Traffic(spec, args.seed + i,
                                                     arch["vocab_size"]),
                          spec, trace=False, instruments=inst,
                          profile_dir=tmp)
        due = readers.due_in_window(run)
        queued_open = sum(1 for r in run.reqs.values()
                          if r.due <= run.t_open and (r.admit is None
                                                      or r.admit > run.t_open))
        queued_end = len(eng.queue)
        window = [st for st in run.steps if run.in_window(st[1])]
        thirds = [window[len(window) * k // 3][4] for k in range(3)]
        line = {"rate_per_s": rate, "due": len(due),
                "admitted": sum(1 for r in due if r.admit is not None),
                "queued_at_open": queued_open,
                "queued_by_thirds": thirds, "queued_at_end": queued_end,
                "slots_held_end": window[-1][2],
                "window_s": run.window_s, "ticks": len(
                    [s for s in run.steps if run.in_window(s[1])]),
                "ttft_p50_ms": readers.ttft_ms(run, 0.5),
                "ttft_p85_ms": readers.ttft_ms(run, 0.85),
                "queue_wait_p85_ms": readers.queue_wait_ms(run, 0.85),
                "itl_p95_ms": readers.itl_ms(run, 0.95),
                "tokens_per_s": readers.tokens_per_s(run),
                "slot_occupancy": readers.slot_occupancy(run),
                "decode_call_ms": readers.call_ms(run, "lm_paged_fused_step"),
                "prefill_call_ms": readers.call_ms(run, "lm_paged_step", 2),
                "lateness_p95_s": sorted(run.lateness)[
                    int(0.95 * (len(run.lateness) - 1))]}
        print(json.dumps(line), flush=True)
        for r in list(eng.queue) + [r for r in eng.slot_req if r]:
            eng.cancel(r.rid)
    inst.restore()
    return 0


if __name__ == "__main__":
    sys.exit(main())
