"""Examples of the optimizer steps completed in the window, over the
window, which ends in a synchronize; host clock."""


def read(record):
    if not record["window_s"]:
        return None  # no window: the control's run
    return record["examples"] / record["window_s"]
