"""K6_roofline: the share of its roofline that kernel K6 (the deposit with
the remesh) reaches: ``roofline.deposit_bound(remesh=True)`` on the
configuration's halo and the wind's planes over K6's device time a step in
the trace, in %."""

from wavebench import roofline


def read(run):
    if run.trace is None:
        return None
    k6_s = run.trace.kernel_s.get("K6", 0.0)
    if k6_s <= 0.0:
        return None
    halo = run.config["halo"]
    halo = halo if isinstance(halo, int) else tuple(tuple(h) for h in halo)
    b = roofline.deposit_bound(run.nodes, run.nodes, halo, remesh=True,
                               n_wf=run.n_wf)
    return 100.0 * b["bound_ms"] / (k6_s * 1e3 / run.trace.steps)
