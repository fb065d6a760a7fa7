"""step.glue_ms: device ms a step of the operations that are none of the
port's kernels (elementwise glue, copies, fills, and a record's forcing
planes), from the profiler trace of the traced member-days."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.glue_s * 1e3 / run.trace.steps
