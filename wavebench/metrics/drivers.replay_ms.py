"""drivers.replay_ms: card ms of one replay of the captured step after the
day's first: by the port's marks of the card's timeline, from the first
replay's end to the last's over the replays between, over the traced
member-days (a mean; any wait for a launch between them included)."""

from wavebench import spans


def read(run):
    days = spans.traced_days(run)
    return spans.replay_ms(days) if days else None
