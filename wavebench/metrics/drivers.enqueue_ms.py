"""drivers.enqueue_ms: host ms to enqueue one replay of the captured step:
a member-day through ``step_n_quiet`` timed from the call to its return,
the card idle before, over the steps (median of 3)."""


def read(run):
    return run.probes.get("enqueue_ms")
