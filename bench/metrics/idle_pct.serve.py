"""The share of the traced window in which nothing ran on the card."""

from bench.lib.readers import idle_pct


def read(record):
    return idle_pct(record)
