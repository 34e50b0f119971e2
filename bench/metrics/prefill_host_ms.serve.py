"""Mean host time of the program's ``ServeEngine.generate`` in the traced
window (the cache made, prefill and decode enqueued): its
``engine.generate`` spans.  Near the replicas' device time it would mean
the call waits for the card."""

from bench.lib.program_spans import mean_ms


def read(record):
    return mean_ms("engine.generate")
