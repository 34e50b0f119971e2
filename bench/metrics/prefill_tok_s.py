"""Prompt tokens of every request served in the window over the window's
platform time (each epoch its busiest replica plus the scheduler)."""


def read(record):
    req = record.get("requests")
    if not req or record["platform_s"] <= 0:
        return None
    return req["prompt_tokens"] / record["platform_s"]
