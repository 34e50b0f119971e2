"""Set-up: from the process's start to the window's, compilation, weights,
operands and warm-up included (host clock)."""


def read(record):
    return record["setup_s"]
