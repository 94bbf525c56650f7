"""The plain reference against the port's plain versions on the CPU at
tiny sizes (the same seeded weights, the port quantizing its own copy),
its SPx arithmetic against the port's bit for bit, and the check failing
on a perturbed output."""
import copy

import numpy as np
import pytest
import torch

from perfbench import check, harness, weights
from perfbench.reference import lm as ref_lm
from perfbench.reference import spx as ref_spx

from perfbench.tests.tiny import tiny_cell

WORKLOADS = ("olmoe-1b-7b.chat-closed", "qwen2-vl-2b.docs-open")


@pytest.mark.parametrize("shape", [(64, 96), (3, 64, 48), (2, 2, 32, 64)])
def test_spx_round_trip_is_the_ports_bit_for_bit(shape):
    from repro_torch.core.quantized import quantize_weight
    w = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    port = quantize_weight(w, "sp2_4").dequantize()
    assert torch.equal(ref_spx.fake_quantize(w, "sp2_4"), port)


def test_weights_redraw_identically_per_layer():
    arch = tiny_cell(WORKLOADS[0]).config["arch"]
    a = weights.layer_weights(arch, 2 ** 31 + 5, 1, "cpu")
    b = weights.layer_weights(arch, 2 ** 31 + 5, 1, "cpu")
    c = weights.layer_weights(arch, 2 ** 31 + 5, 0, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[("attn", "wq", "w")], c[("attn", "wq", "w")])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_matches_the_ports_plain_forward(workload):
    from repro_torch.models.lm import lm_logits
    from repro_torch.runtime import Runtime
    cell = tiny_cell(workload)
    arch, seed = cell.config["arch"], 2 ** 31 + 9
    params = harness.build_params(arch, "sp2_4", seed, torch.device("cpu"))
    cfg = harness.arch_config(cell.config)
    tokens = np.random.default_rng(0).integers(0, arch["vocab_size"], 37)
    with torch.no_grad():
        port = lm_logits(params, torch.as_tensor(tokens[None]), cfg,
                         Runtime(device="cpu"))[0]
        ref = ref_lm.logits_at(arch, cell.config["quantized"], seed,
                               [tokens], [range(0, 37)], "cpu")[0][0]
    scale = ref.abs().max()
    assert (port - ref).abs().max() <= 2e-5 * scale
    # without the quantization the reference is another model
    raw = dict(cell.config["quantized"], min_size=1 << 60)
    with torch.no_grad():
        other = ref_lm.logits_at(arch, raw, seed, [tokens], [range(0, 37)],
                                 "cpu")[0][0]
    assert (port - other).abs().max() > 1e-2 * scale


@pytest.mark.parametrize("workload", WORKLOADS)
def test_check_fails_a_perturbed_output(workload):
    cell = tiny_cell(workload)
    cell.limits = copy.deepcopy(cell.limits)
    res = harness.run_cell(cell, 12345, 1.0, False, device="cpu",
                           log=lambda m: None)
    assert res["correct"], res["checks"]
    run_reqs = []
    orig = check.finished

    def perturbed(run):
        reqs = orig(run)
        for r in reqs:
            r.output = list(r.output)
            r.output[len(r.output) // 2] = (r.output[len(r.output) // 2]
                                            + 1) % run.arch["vocab_size"]
        run_reqs.extend(reqs)
        return reqs
    check.finished = perturbed
    try:
        res = harness.run_cell(cell, 12345, 1.0, False, device="cpu",
                               log=lambda m: None)
    finally:
        check.finished = orig
    assert run_reqs and not res["correct"], res["checks"]


def test_routing_margins_and_the_positions_they_leave_out():
    cell = tiny_cell(WORKLOADS[0])
    arch = cell.config["arch"]
    tokens = np.random.default_rng(1).integers(0, arch["vocab_size"], 20)
    with torch.no_grad():
        _, margins = ref_lm.logits_at(arch, cell.config["quantized"], 3,
                                      [tokens], [range(5, 20)], "cpu")
    m = margins[0]
    assert m.shape == (15,) and bool((m >= 0).all())
    assert bool(torch.isfinite(m).all())
    limits = {"gap_max": {"limit": 1.0, "router_margin": float(m.median())}}
    keep = check.decided(margins, limits)
    assert 0 < keep.sum() < keep.size
    dense = tiny_cell(WORKLOADS[1]).config["arch"]
    with torch.no_grad():
        _, margins = ref_lm.logits_at(dense, cell.config["quantized"], 3,
                                      [tokens], [range(5, 20)], "cpu")
    assert bool(torch.isinf(margins[0]).all())
    assert check.decided(margins, limits).all()
