"""Useful model flops of the profiled ticks over the dense bf16 peak, %."""
from perfbench import readers


def read(run):
    return readers.mfu(run)
