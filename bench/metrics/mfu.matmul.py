"""The window's matmul operations (counted from shapes by the benchmark) over
the CUDA-event time of every run that did them, repeats included, as a
share of the card's bf16 peak."""

from bench.lib.readers import mfu_pct


def read(record):
    return mfu_pct(record, "matmul")
