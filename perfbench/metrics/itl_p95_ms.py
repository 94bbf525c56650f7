"""95th percentile of every inter-token gap ending in the window, ms."""
from perfbench import readers


def read(run):
    return readers.itl_ms(run, 0.95)
