"""flash_attention's least time at each launch's shape (causal attention's
operations over the bf16 peak, or q, k, v and o moved once over the memory
rate, whichever is larger), summed over the window, over its device time
in the trace."""

from bench.lib.readers import roofline_pct


def read(record):
    return roofline_pct(record, "flash_attention", "flash_fwd")
