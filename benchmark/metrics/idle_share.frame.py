"""The share of the traced window in which no device operation ran."""


def read(record):
    trace = record["trace"]
    if trace is None or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
