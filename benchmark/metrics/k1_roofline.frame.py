"""K1's share of its roofline: the four SIREN chains' bound a frame
(``counts.chain_bound_s`` from the configuration's widths) times frames,
over the device time of the kernels the trace groups as K1."""


def read(record):
    trace = record["trace"]
    busy = trace and trace["group_s"].get("K1 sine_chain")
    if not busy:
        return None
    return 100.0 * record["per_unit"]["bounds_s"]["K1 sine_chain"] * record["units"] / busy
