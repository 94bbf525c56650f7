"""Mean host ms per prefill call (lm_paged_step, chunk > 1)."""
from perfbench import readers


def read(run):
    return readers.call_ms(run, "lm_paged_step", min_c=2)
