"""Frames delivered over the whole window, on the host clock."""


def read(record):
    return record["units"] / record["window_s"]
