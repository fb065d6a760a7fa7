"""device.idle_share: the share of the traced window (from the first
traced job's start to the last one's end) in which no operation ran on the
card, in %."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
