"""spx_matmul launches' least time over their kernels' device time, %."""
from perfbench import readers


def read(run):
    return readers.spx_matmul_roofline(run)
