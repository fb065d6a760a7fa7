"""day_s_p90: the 90th percentile (nearest rank) over every job of the
window of one job's wall seconds, from the member handed to the run loop
to its final state, the card waited for."""

from wavebench import stats


def read(run):
    return stats.percentile([b - a for a, b in run.jobs], 90)
