"""device_idle.keygen: the share (%) of the traced window in which no operation
ran on the card (1 - union of the device intervals / window); nothing
where the trace holds no device operation."""


def read(run):
    if run.busy_s <= 0 or run.window_s <= 0:
        return None
    return (1 - run.busy_s / run.window_s) * 100
