"""The share of the program's ``Scheduler.observe`` calls in the traced
window that changed the distribution: its ``scheduler.repartition``
counter over its ``scheduler.observe`` spans, in percent."""

from bench.lib.program_spans import sink, spans


def read(record):
    observes = spans("scheduler.observe")
    if not observes:
        return None
    return 100.0 * sink().counters.get("scheduler.repartition", 0) / len(observes)
