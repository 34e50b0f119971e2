"""Mean host time of the program's ``Scheduler.observe`` (its EMA, fold-in,
imbalance test and any repartition): the ``scheduler.observe`` spans of
the traced window."""

from bench.lib.program_spans import mean_ms


def read(record):
    return mean_ms("scheduler.observe")
