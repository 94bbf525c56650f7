"""85th percentile of time to first token over the requests due in the
window, from the due time, ms: the highest percentile with ten samples
beyond it at the cell's 1.6 req/s over 51 s (about 82 requests)."""
from perfbench import readers


def read(run):
    return readers.ttft_ms(run, 0.85)
