"""The comparison that decides ``correct``.

After the window the port's model, capture and pool are freed, the pool is
regenerated from the seed, and the plain reference (``reference.py``) runs
each compared member-day from its member: the job drawn from the seed and,
where the mix's ``check_days`` is 2, the window's last job.  The numbers, each against its limit in
``limits/<cell>.json``:

- ``gap_l2``: over the compared jobs and the channels of the final node
  state that the configuration's family compares (E, m_x, m_y), the largest ||port - reference||_2 /
  ||reference||_2;
- ``gap_max``: likewise the largest max |port - reference| / max
  |reference|;
- ``gap_share``: over the compared jobs, the largest share of the nodes
  whose final energy parts from the reference's by more than ``SHARE_RTOL``
  of its own (plus ``SHARE_RTOL`` 1e-3 of the field's largest, for nodes
  near zero): the solver's relative tolerance, so a node that crosses a
  threshold of the remesh (gather, reseed, off) on one side alone counts
  once however far its value moves;
- ``clock``: over every job of the window, the largest |final time -
  steps DT| plus |final iteration - steps| (exact: limit 0);
- ``failed``: over every job of the window, the failed lanes of its last
  step (``StepMetrics.n_failed``; limit 0);
- ``clamped``: over every job, the deposit displacements clamped to the
  halo in its last step (``n_clamped``; limit 0: the halo is sized to the
  configuration's CFL).

Only the numbers the cell's limits file names are compared; the others
are logged.  A number that is not finite fails.  The reference's own counts over the
compared days (live lanes, substeps tried, clamps) are kept for the
rooflines and logged.
"""

from __future__ import annotations

import math

import torch

# the relative part of a node's energy by which gap_share counts it: the
# configurations' solver tolerance (reltol)
SHARE_RTOL = 1e-3


def worse(a: float, b: float) -> float:
    """The larger of two readings, NaN winning."""
    return a if not a <= b else b


def state_gaps(port: torch.Tensor, ref: torch.Tensor) -> dict:
    """gap_l2 and gap_max (worst channel) and gap_share of two node
    states ``[..., 3]``, in float64."""
    d = port.double() - ref.double()
    r = ref.double()
    out = dict(gap_l2=0.0, gap_max=0.0)
    for c in range(r.shape[-1]):
        a = float(torch.linalg.vector_norm(d[..., c])
                  / torch.linalg.vector_norm(r[..., c]))
        b = float(d[..., c].abs().max() / r[..., c].abs().max())
        out["gap_l2"] = worse(a, out["gap_l2"])
        out["gap_max"] = worse(b, out["gap_max"])
    e = r[..., 0].abs()
    tol = SHARE_RTOL * (e + 1e-3 * e.max())
    out["gap_share"] = float((~(d[..., 0].abs() <= tol)).double().mean())
    return out


def passes(value: float, limit: float) -> bool:
    """Whether ``value`` is within ``limit`` (NaN never is)."""
    return value <= limit


def guarantees(finals, steps: int, DT: float) -> dict:
    """Every job's final clock and last step's counters."""
    if not finals:
        return dict(clock=math.inf, failed=0, clamped=0, failed_jobs=0)
    times = torch.stack([t for t, _, _ in finals]).double()
    its = torch.stack([i for _, i, _ in finals]).double()
    clock = ((times - steps * DT).abs() + (its - steps).abs())
    nf = torch.stack([m.n_failed for _, _, m in finals]).long()
    ncl = torch.stack([m.n_clamped for _, _, m in finals]).long()
    bad = (clock != 0) | (nf != 0)
    return dict(clock=float(clock.max()), failed=int(nf.sum()),
                clamped=int(ncl.sum()), failed_jobs=int(bad.sum()))


def judge(cell, win: dict, extra_members=()) -> dict:
    """``correct`` and its numbers for one run; ``extra_members``: members
    whose reference counts the rooflines need beyond the compared ones."""
    g = guarantees(win["finals"], cell.steps, cell.DT)
    ref = cell.reference_model()
    pool = list(cell.members(ref))
    P = len(pool)
    gaps = dict(gap_l2=0.0, gap_max=0.0, gap_share=0.0)
    work = {}
    ref_clamped = 0
    for j in sorted(win["kept"]):
        out = win["kept"][j]
        r, counts = ref.run(pool[j % P], cell.steps)
        work[j % P] = counts
        ref_clamped += counts["n_clamped"]
        got = state_gaps(*cell.family.compared(out, r))
        clock = abs(float(out.time) - float(r.time)) + abs(
            int(out.iteration) - r.iteration)
        gaps = {k: worse(v, gaps[k]) for k, v in got.items()}
        g["clock"] = worse(clock, g["clock"])
        cell.log(f"compare: job {j} (member {j % P}): "
                 + ", ".join(f"{k} {v!r}" for k, v in got.items())
                 + "; reference over the day: "
                 + ", ".join(f"{k} {v}" for k, v in counts.items()))
        del out, r
    for m in extra_members:
        if m not in work:
            _, work[m] = ref.run(pool[m], cell.steps)
    numbers = dict(gaps, clock=g["clock"], failed=float(g["failed"]),
                   clamped=float(g["clamped"]))
    cell.log("compare: " + ", ".join(f"{k} {v!r}" for k, v in
                                     numbers.items()))
    checks = {k: {"value": numbers[k], "limit": float(v)}
              for k, v in cell.limits.items()}
    correct = all(passes(c["value"], c["limit"]) for c in checks.values())
    traced = [work[m] for m in extra_members if m in work]
    total = None
    if traced:
        total = {k: sum(c[k] for c in traced) for k in traced[0]}
    cell.log(f"compare: the reference clamped {ref_clamped} displacements "
             f"over the compared days")
    return dict(correct=bool(correct), checks=checks,
                failed_jobs=g["failed_jobs"], work=total)
