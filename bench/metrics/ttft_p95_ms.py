"""The 95th percentile over every request served in the window of the
platform time from its epoch's start (the scheduler's time before the
epoch) to the end of its replica's prefill."""

import numpy as np


def read(record):
    req = record.get("requests")
    if not req or not req["ttft_s"]:
        return None
    return 1e3 * float(np.percentile(np.asarray(req["ttft_s"], dtype=np.float64), 95))
