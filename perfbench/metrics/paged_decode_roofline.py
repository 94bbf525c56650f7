"""The decode ticks' ragged attention launches' least time over their kernels' device time, %."""
from perfbench import readers


def read(run):
    return readers.paged_decode_roofline(run)
