"""Share of the profiled ticks with no device op running, %."""
from perfbench import readers


def read(run):
    return readers.device_idle_share(run)
