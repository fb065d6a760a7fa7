"""K1_roofline: the share of its roofline that kernel K1 (the advance)
reaches: ``roofline.k1_bound`` on the traced steps' own work (their live
lanes and substeps tried, counted by the plain reference over the same
member-days) over K1's device time a step in the trace, in %."""

from wavebench import roofline


def read(run):
    if run.trace is None or not run.work:
        return None
    k1_s = run.trace.kernel_s.get("K1", 0.0)
    if k1_s <= 0.0:
        return None
    steps = run.work["steps"]
    b = roofline.k1_bound(run.nodes, run.config["solver"], True,
                          run.work["n_active"] / steps,
                          run.work["tried"] / steps, n_wf=run.n_wf,
                          proj=run.proj)
    return 100.0 * b["bound_ms"] / (k1_s * 1e3 / run.trace.steps)
