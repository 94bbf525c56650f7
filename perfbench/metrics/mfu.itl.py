"""Useful model flops of the profiled ticks over the dense bf16 peak, %:
the whole step's share beside ``paged_decode_roofline``, which moves the
same end-to-end metric."""
from perfbench import readers


def read(run):
    return readers.mfu(run)
