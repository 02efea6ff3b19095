"""The host's time in one step's group call, from the call to its return
(the device may still be working), mean over the window's steps; from the
benchmark's span around the call."""


def read(record):
    spans = record["spans"].get("group")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
