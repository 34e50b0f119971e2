"""Platform time of the window's application iterations (each its busiest
processor, plus any scheduler time between them) over their number."""


def read(record):
    if not record.get("iterations"):
        return None
    return 1e3 * record["platform_s"] / record["iterations"]
