"""Mean host time of the program's device-bank partitions in the traced
window (the cold balance's and ``observe``'s): its ``speedstore.partition``
spans, which cover the device work since the partition returns host
lists."""

from bench.lib.program_spans import mean_ms


def read(record):
    return mean_ms("speedstore.partition")
