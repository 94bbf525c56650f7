"""Mean host ms per decode call (lm_paged_fused_step)."""
from perfbench import readers


def read(run):
    return readers.call_ms(run, "lm_paged_fused_step")
