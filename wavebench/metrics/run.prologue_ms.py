"""run.prologue_ms: host ms of a traced member-day from the start of
``Simulation.run`` to its first copy into the captured step's input
(the port's spans ``sim.run`` and ``drivers.copy_in``), mean over the
traced member-days: host work before the day's first operation is enqueued,
while the card idles."""

from wavebench import spans


def read(run):
    days = spans.traced_days(run)
    return spans.prologue_ms(days) if days else None
