"""The port's own records of a traced run, for the metric readers: the
spans and marks of the card's timeline that ``picles_torch``'s recorder
(``picles_torch.utils.diagnostics.tracer()``) keeps of each
``Simulation.run`` made while a profiler recorded, and of each capture.

A program without the recorder gives nothing to read: every function here
returns None for it, and raises nothing."""

from __future__ import annotations

import statistics
from typing import Optional

def snapshot() -> Optional[dict]:
    """The recorder's snapshot, or None where the port has no recorder."""
    try:
        from picles_torch.utils import diagnostics
    except ImportError:
        return None
    tracer = getattr(diagnostics, "tracer", None)
    return tracer().snapshot() if tracer is not None else None


def traced_days(run, snap: Optional[dict] = None) -> Optional[list]:
    """The port's records of the traced member-days: the last
    ``run.trace.steps // run.steps`` runs recorded under a profiler whose
    root is ``sim.run`` (the profiler may have traced them more than once:
    the last attempt's are the trace's); None where there are fewer, or no
    trace."""
    if run.trace is None or run.steps <= 0:
        return None
    snap = snapshot() if snap is None else snap
    if snap is None:
        return None
    n = run.trace.steps // run.steps
    days = [r for r in snap["runs"] if r["profiled"] and any(
        s["name"] == "sim.run" and s["parent"] is None for s in r["spans"])]
    return days[-n:] if 0 < n <= len(days) else None


def _first(day: dict, name: str) -> Optional[dict]:
    return next((s for s in day["spans"] if s["name"] == name), None)


def prologue_ms(days: list) -> Optional[float]:
    """Mean host ms from ``sim.run``'s start to ``drivers.copy_in``'s."""
    out = []
    for d in days:
        root, copy = _first(d, "sim.run"), _first(d, "drivers.copy_in")
        if copy is None:
            return None
        out.append((copy["start_ns"] - root["start_ns"]) * 1e-6)
    return statistics.fmean(out) if out else None


def calls(day: dict) -> list:
    """A recorded day's graphed drivers' calls, from the program's marks of
    the card's timeline (ms): each a dict of ``copy`` (the copy in and the
    clone out), ``first`` (the first replay), ``steady`` (the later
    replays, from the first's end to the last's) and ``n`` (its replays)."""
    out, call = [], None
    for p in day["device"]:
        if p["name"] == "drivers.copy_in":
            call = [p]
            continue
        if call is None:
            continue
        call.append(p)
        if p["name"] == "drivers.done":
            c0, r0, r1, rn, done = call[0], call[1], call[2], call[-2], p
            out.append(dict(copy=(r0["ms"] - c0["ms"]) + (done["ms"]
                                                          - rn["ms"]),
                            first=r1["ms"] - r0["ms"],
                            steady=rn["ms"] - r1["ms"], n=rn["step"]))
            call = None
    return out


def replay_ms(days: list) -> Optional[float]:
    """Mean ms of a replay on the card after the first of its call: the
    later replays' time (from the first's end to the last's) over their
    number; any wait for a launch between them included."""
    cs = [c for d in days for c in calls(d)]
    n = sum(c["n"] - 1 for c in cs)
    return sum(c["steady"] for c in cs) / n if n > 0 else None


def launch_gap_ms(days: list) -> Optional[float]:
    """Mean over the days of the card's ms a day that each call's first
    replay takes beyond a later one (``replay_ms``): from the copy in's end
    to the first replay's end, the wait for the call's first graph launch
    and any slower start of the graph on a card that idled."""
    steady = replay_ms(days)
    if steady is None:
        return None
    return statistics.fmean(sum(c["first"] - steady for c in calls(d))
                            for d in days)


def replay_bubble_ms(days: list, busy_s: float) -> Optional[float]:
    """Ms of a later replay in which no operation ran on the card:
    ``replay_ms`` less the busy ms a replay, the trace's busy time (every
    device op of the traced window) less the copies' (their marks' time),
    over every replay.  The busy time also holds the few ops of the days
    outside the drivers (the prologue's read of the step count, a
    device-to-host copy a day): a few microseconds a day."""
    steady = replay_ms(days)
    if steady is None:
        return None
    cs = [c for d in days for c in calls(d)]
    busy = busy_s * 1e3 - sum(c["copy"] for c in cs)
    return steady - busy / sum(c["n"] for c in cs)


def capture_s(snap: Optional[dict] = None) -> Optional[float]:
    """Seconds of the last ``drivers.capture`` span: the warm-up steps, the
    capture and the graph's instantiation."""
    snap = snapshot() if snap is None else snap
    if snap is None:
        return None
    caps = [s for s in snap["once"] if s["name"] == "drivers.capture"]
    return (caps[-1]["end_ns"] - caps[-1]["start_ns"]) * 1e-9 if caps \
        else None
