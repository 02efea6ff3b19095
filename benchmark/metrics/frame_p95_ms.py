"""95th percentile of every frame's latency in the window, packet handed
to the converter to the frame's bytes in the pinned host buffer, on the
host clock."""

import statistics


def read(record):
    lat = record["latencies_s"]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100)[94] * 1e3
