"""The readers of the port's own records (``spans.py`` and the metrics
``run.prologue_ms``, ``drivers.launch_gap_ms``, ``drivers.replay_ms``,
``drivers.replay_bubble_ms``, ``drivers.capture_s``) on a synthetic
snapshot of the recorder, and their silence where the port has no
recorder."""

import types

import pytest

from wavebench import spans
from wavebench import trace as T
from wavebench.harness import HERE, Run, load_module

NAMES = ("run.prologue_ms", "drivers.launch_gap_ms", "drivers.replay_ms",
         "drivers.replay_bubble_ms", "drivers.capture_s")


def metric(name):
    return load_module(HERE / "metrics" / f"{name}.py", f"m_{name}")


def _day(rid, profiled=True, scale=1.0):
    """One recorded member-day of 3 steps: prologue 0.3 ms (times
    ``scale``); on the card, copy in 0.1 ms, the first replay 2.3 ms, the
    two later ones 1.0 ms each, clone out 0.05 ms."""
    t0 = 10 ** 9 * rid
    sp = [dict(id=rid * 10, name="sim.run", start_ns=t0,
               end_ns=t0 + 5_000_000, parent=None, run=rid, step=None),
          dict(id=rid * 10 + 1, name="sim.prologue", start_ns=t0,
               end_ns=t0 + 250_000, parent=rid * 10, run=rid, step=None),
          dict(id=rid * 10 + 2, name="drivers.copy_in",
               start_ns=t0 + int(300_000 * scale),
               end_ns=t0 + 400_000, parent=rid * 10, run=rid, step=None)]
    dev = [dict(name="drivers.copy_in", step=None, ms=0.0),
           dict(name="drivers.replay", step=0, ms=0.1),
           dict(name="drivers.replay", step=1, ms=2.4),
           dict(name="drivers.replay", step=3, ms=4.4),
           dict(name="drivers.done", step=None, ms=4.45)]
    return dict(id=rid, profiled=profiled, spans=sp, device=dev)


SNAP = {"counters": {"drivers.captures": 1, "drivers.replays": 40},
        "once": [dict(id=1, name="drivers.capture", start_ns=0,
                      end_ns=150_000_000, parent=None, run=None, step=None),
                 dict(id=2, name="drivers.warmup", start_ns=1,
                      end_ns=90_000_000, parent=1, run=None, step=None),
                 dict(id=3, name="drivers.capture", start_ns=10 ** 9,
                      end_ns=10 ** 9 + 170_000_000, parent=None, run=None,
                      step=None)],
        # an untraced run, an earlier attempt's two days (slower prologue),
        # then the last attempt's two
        "runs": [_day(4, profiled=False, scale=9.0), _day(5, scale=5.0),
                 _day(6, scale=5.0), _day(7), _day(8)]}


def _run(busy_s=2 * (3 * 0.9 + 0.15) * 1e-3, days=2):
    s = T.Summary(steps=3 * days, window_s=1.0, busy_s=busy_s, ops=10,
                  kernel_s={}, glue_s=0.0, by_name=[], idle_gaps=[],
                  job_idle_s=[])
    return Run(cell="c", config={}, traffic={}, nodes=4, steps=3, DT=600.0,
               trace=s)


def test_the_arithmetic_on_a_synthetic_snapshot(monkeypatch):
    run = _run()
    days = spans.traced_days(run, SNAP)
    assert [d["id"] for d in days] == [7, 8]
    assert spans.prologue_ms(days) == pytest.approx(0.3)
    assert spans.replay_ms(days) == pytest.approx(1.0)
    # the first replay takes 1.3 ms more than a later one
    assert spans.launch_gap_ms(days) == pytest.approx(1.3)
    # busy 5.7 ms, of which the copies' 0.3: 0.9 ms a replay, so a later
    # replay of 1.0 ms holds 0.1 ms of bubbles
    assert spans.replay_bubble_ms(days, run.trace.busy_s) == pytest.approx(
        0.1)
    assert spans.capture_s(SNAP) == pytest.approx(0.17)
    monkeypatch.setattr(spans, "snapshot", lambda: SNAP)
    want = {"run.prologue_ms": 0.3, "drivers.launch_gap_ms": 1.3,
            "drivers.replay_ms": 1.0, "drivers.replay_bubble_ms": 0.1,
            "drivers.capture_s": 0.17}
    for name in NAMES:
        assert metric(name).read(run) == pytest.approx(want[name]), name


def test_the_days_are_the_last_attempts_and_a_short_record_reads_none(
        monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: SNAP)
    days = spans.traced_days(_run(days=3), SNAP)
    assert [d["id"] for d in days] == [6, 7, 8]
    assert spans.prologue_ms(days) == pytest.approx((1.5 + 0.3 + 0.3) / 3)
    assert spans.traced_days(_run(days=5), SNAP) is None
    for name in NAMES[:-1]:
        assert metric(name).read(_run(days=5)) is None, name
    untraced = Run(cell="c", config={}, traffic={}, nodes=4, steps=3,
                   DT=600.0)
    assert spans.traced_days(untraced, SNAP) is None
    for name in NAMES[:-1]:
        assert metric(name).read(untraced) is None, name
    eager = dict(SNAP, runs=[dict(d, device=[], spans=d["spans"][:2])
                             for d in SNAP["runs"]])
    days = spans.traced_days(_run(), eager)
    for f in (spans.prologue_ms, spans.launch_gap_ms, spans.replay_ms):
        assert f(days) is None
    assert spans.replay_bubble_ms(days, 1.0) is None
    # calls of one replay each: no later replay to read
    single = dict(SNAP, runs=[dict(d, device=[p for p in d["device"]
                                              if p["step"] != 3])
                              for d in SNAP["runs"]])
    days = spans.traced_days(_run(), single)
    assert [c["n"] for d in days for c in spans.calls(d)] == [1, 1]
    for f in (spans.launch_gap_ms, spans.replay_ms):
        assert f(days) is None
    assert spans.replay_bubble_ms(days, 1.0) is None
    assert spans.capture_s(dict(SNAP, once=[])) is None


def test_a_port_without_the_recorder_reads_none(monkeypatch):
    """The parent of the recorder: ``diagnostics`` with no ``tracer``."""
    import picles_torch.utils as utils

    monkeypatch.setattr(utils, "diagnostics",
                        types.ModuleType("diagnostics"), raising=False)
    monkeypatch.setitem(__import__("sys").modules,
                        "picles_torch.utils.diagnostics",
                        types.ModuleType("diagnostics"))
    assert spans.snapshot() is None
    for name in NAMES:
        assert metric(name).read(_run()) is None, name


def test_the_live_recorder_reads_as_a_snapshot():
    snap = spans.snapshot()
    assert {"counters", "once", "runs"} <= set(snap)
    assert "drivers.replays" in snap["counters"]
