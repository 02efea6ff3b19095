"""The whole frame's share of the chip's dense peak in the frame's dtype:
model FLOPs a frame (the SIRENs' products, counted from the
configuration's widths) times frames, over the window, over the peak."""

from benchmark import counts


def read(record):
    trace = record["trace"]
    if trace is None or not record["units"]:
        return None
    return 100.0 * record["per_unit"]["flops"] * record["units"] / trace["window_s"] / counts.PEAK_FLOPS[record["dtype"]]
