"""The host's part of a frame: the mean frame latency less the mean wait
in the copy (which waits for the card), from the benchmark's spans."""


def read(record):
    copies = record["spans"].get("copy")
    lat = record["latencies_s"]
    if not copies or not lat:
        return None
    return (sum(lat) / len(lat) - sum(copies) / len(copies)) * 1e3
