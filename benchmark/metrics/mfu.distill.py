"""The whole step's share of the chip's dense bf16 peak: the teacher's
forward and the student's forward and backward, model FLOPs counted from
the configuration, times steps, over the window, over 989 TFLOP/s.  The
selective-f32 student's f32 products are counted at that peak too."""

from benchmark import counts


def read(record):
    trace = record["trace"]
    if trace is None or not record["units"]:
        return None
    return 100.0 * record["per_unit"]["flops"] * record["units"] / trace["window_s"] / counts.PEAK_FLOPS["bf16"]
