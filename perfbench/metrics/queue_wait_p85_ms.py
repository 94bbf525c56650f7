"""85th percentile of the wait from due time to admission over the
requests due in the window, ms."""
from perfbench import readers


def read(run):
    return readers.queue_wait_ms(run, 0.85)
