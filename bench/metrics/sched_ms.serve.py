"""Dispatch host time per epoch: the scheduler's fold-ins and partitions
(the card drained around each) between the window's epochs."""


def read(record):
    sched = record.get("sched_s")
    if not sched or not record.get("iterations"):
        return None
    return 1e3 * sum(sched) / record["iterations"]
