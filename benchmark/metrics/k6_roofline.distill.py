"""K6's share of its roofline: the bound of the teacher's GroupNorm
[-> FiLM] -> SiLU -> 3x3 conv [+ skip] sites a step (counted from the
configuration's U-Nets) times steps, over the device time of the kernels
the trace groups as K6 and its fold (the statistics the block needs)."""


def read(record):
    trace = record["trace"]
    busy = trace and trace["group_s"].get("K6 affine_silu_conv3", 0.0) + trace["group_s"].get("K6 fold", 0.0)
    if not busy:
        return None
    return 100.0 * record["per_unit"]["bounds_s"]["K6"] * record["units"] / busy
