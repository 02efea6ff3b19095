"""Device operations (kernels, copies, fills) per step in the traced window."""


def read(record):
    trace = record["trace"]
    if trace is None or not record["units"]:
        return None
    return trace["device_ops"] / record["units"]
