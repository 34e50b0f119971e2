"""matmul_update's least time at each launch's shape (operations over the
bf16 peak, or A, B and C read once and C written once over the memory
rate, whichever is larger), summed over the window, over its device time
in the trace."""

from bench.lib.readers import roofline_pct


def read(record):
    return roofline_pct(record, "matmul_update", "matmul_update")
