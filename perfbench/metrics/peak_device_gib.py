"""Peak device memory allocated from after the weights to the window's end, GiB."""
from perfbench import readers


def read(run):
    return readers.peak_device_gib(run)
