"""drivers.replay_bubble_ms: card ms of a replay after the day's first in
which no operation ran: ``drivers.replay_ms`` less the busy ms a replay,
the trace's busy time (``device.idle_share``'s union of device ops) less
the copies in and out (by the port's marks), over the traced member-days'
replays.  The bubbles between the graph's own operations, and any wait for
a launch between replays; the busy time also holds the day's few ops
outside the drivers (the prologue's read of the step count)."""

from wavebench import spans


def read(run):
    days = spans.traced_days(run)
    return spans.replay_bubble_ms(days, run.trace.busy_s) if days else None
