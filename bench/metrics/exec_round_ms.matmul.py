"""The program's own round cost: for each ``CallableExecutor`` round of the
traced window, the largest ``device_s`` (the CUDA-event seconds the
executor reads around a processor) of its ``executor.proc`` spans; their
mean, in ms."""

from collections import defaultdict

from bench.lib.program_spans import spans


def read(record):
    rounds = defaultdict(float)
    for e in spans("executor.proc"):
        rounds[e.attrs["round"]] = max(rounds[e.attrs["round"]], e.attrs["device_s"])
    if not rounds:
        return None
    return 1e3 * sum(rounds.values()) / len(rounds)
