"""run.job_host_ms: host ms of a member-day that the card does not account
for: over the traced member-days, the mean of each job span's time (the
harness's span around ``Simulation.run``) in which no operation ran on the
card: the Simulation's set-up, the hand-over of the member, the host's lead
before the first replay reaches the card, the final wait."""


def read(run):
    if run.trace is None or not run.trace.job_idle_s:
        return None
    idle = run.trace.job_idle_s
    return 1e3 * sum(idle) / len(idle)
