"""drivers.launch_gap_ms: card ms a traced member-day that the day's first
replay of the captured step takes beyond a later one, by the port's marks
of the card's timeline (from the copy in's end to the first replay's end,
less ``drivers.replay_ms``), mean over the traced member-days: the card
waiting for the day's first graph launch, and any slower start of the
graph on a card that idled.  Waits for the later launches are not parted
from the bubbles (``drivers.replay_bubble_ms``)."""

from wavebench import spans


def read(run):
    days = spans.traced_days(run)
    return spans.launch_gap_ms(days) if days else None
