"""step.device_ops: device operations a replayed step (kernels, copies,
fills), from the profiler trace of the traced member-days, the copies in
and out of each job included."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.ops / run.trace.steps
