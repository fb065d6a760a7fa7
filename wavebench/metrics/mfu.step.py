"""mfu.step: the share of the card's peak that the whole step reaches: the
least time the step's necessary work takes (``roofline.step_work``: each
particle's values once in and out, the node state out, the masks, the
projection where it varies, the forcing values the nodes read in the
window, the operations of the substeps taken, the deposit and the remesh)
over the traced window's time a step, in %.  The wind's share comes from
the forcing's kind (``reference.Wind``: none for a wind the kernels compute
in place).  It stays defined whatever kernels do the work."""

from wavebench import roofline


def read(run):
    if run.trace is None or not run.work:
        return None
    steps = run.work["steps"]
    w = roofline.step_work(run.nodes, run.config["solver"],
                           run.work["n_active"] / steps,
                           run.work["tried"] / steps,
                           wind_values=run.wind_values, B=run.B,
                           proj=run.proj)
    return 100.0 * w["bound_ms"] / (run.trace.window_s * 1e3
                                    / run.trace.steps)
