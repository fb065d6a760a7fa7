"""The port's recorder of spans and counters (``utils/diagnostics.py``
``tracer()``), on the CPU, through ``Simulation.run`` and the drivers.

- With no profiler a run records no run span and makes no timing event;
  ``drivers.captures`` and ``drivers.replays`` count.
- Under ``torch.profiler`` a run records ``sim.run``, ``sim.prologue`` and
  ``sim.wait`` with one run id, nested, and each is a host event of the
  profiler that is no user annotation (so the profiler makes no device
  copy of it); a graphed run adds ``drivers.copy_in``, one
  ``drivers.replay`` a replay and ``drivers.clone_out``, and five marks
  of the card's timeline (timing events) a graphed call, none a replay.
- The buffer keeps its last runs and reuses their events.
- The benchmark's readers (``wavebench/spans.py``) read a recorded day.

The CPU has no CUDA graphs: a graphed model is stood in for by
``HostGraph``, whose replay runs the eager step into the captured state,
and CUDA's timing events by ``HostEvent``, which reads the host clock.  The
card's graphs and events run in tests/test_torch_cuda.py (marker
``cuda``).
"""

import json
import os
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import picles_torch as pt
from picles_torch.models import drivers
from picles_torch.ops import advance_cuda
from picles_torch.utils import diagnostics as diag

torch.set_num_threads(1)

DT = 600.0
RUN_SPANS = {"sim.run", "sim.prologue", "sim.wait"}


class HostGraph:
    """A CPU stand-in of ``drivers.StepGraph``: its replay runs the eager
    step into the captured state."""

    def __init__(self, model, ms):
        self.layout = drivers.layout(ms)
        self.state = ms.clone()
        self.graph = types.SimpleNamespace(
            replay=lambda: self.state.copy_(model.step(self.state)))

    replay = drivers.StepGraph.replay


class HostEvent:
    """A CPU stand-in of ``torch.cuda.Event(enable_timing=True)``."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        HostEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _model():
    ws = pt.FetchRelations.MinimalWindsea(10.0, 10.0, DT)
    sett = pt.ODESettings(log_energy_minimum=float(ws.lne), timestep=DT,
                          dt=1e-3, dtmin=1e-4, force_dtmin=True)
    grid = pt.cartesian_box(100e3, 9, 100e3, 9,
                            periodic_boundary=(True, True), device="cpu")
    return pt.WaveGrowth2D(grid, pt.constant_winds(10.0, 10.0), sett)


def _day(model, steps):
    """A ``Simulation.run`` of ``steps`` steps from the model's seed."""
    sim = pt.Simulation.create(model, stop_time=(steps - 0.5) * DT)
    sim.run()
    return sim


@pytest.fixture
def rec(monkeypatch):
    """A recorder of its own for the test, keeping 3 runs."""
    t = diag.Tracer(keep=3)
    monkeypatch.setattr(diag, "_TRACER", t)
    return t


@pytest.fixture
def graphed(monkeypatch):
    """A model whose drivers take the graphed path on the CPU."""
    monkeypatch.setattr(drivers, "StepGraph", HostGraph)
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    HostEvent.made = 0
    model = _model()
    model._graphed = True
    return model


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_untraced_run_records_no_run_span_and_counts(rec, graphed):
    assert not diag.tracing()
    eager = _day(_model(), 5)
    assert not rec.runs and HostEvent.made == 0
    assert rec.counts == {"drivers.captures": 0, "drivers.replays": 0}
    sim = _day(graphed, 5)
    for a, b in zip(sim.state.leaves(), eager.state.leaves()):
        assert torch.equal(a, b)
    assert rec.counts == {"drivers.captures": 1, "drivers.replays": 5}
    graphed.step_n_quiet(sim.state, 3)
    _day(graphed, 4)
    assert rec.counts == {"drivers.captures": 1, "drivers.replays": 12}
    assert not rec.runs and HostEvent.made == 0
    # the capture is recorded once a model, with no run
    assert [s.name for s in rec.once] == ["drivers.capture"]
    cap = rec.once[0]
    assert cap.run is None and cap.parent is None
    assert 0 < cap.start_ns < cap.end_ns


def test_profiled_run_records_nested_spans_with_one_run_id(rec):
    model = _model()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert diag.tracing()
        _day(model, 3)
    assert not diag.tracing()
    (run,) = rec.runs
    assert run.profiled and run.marks == []
    by = _by_name(s.as_dict() for s in run.spans)
    assert set(by) == RUN_SPANS
    root, = by["sim.run"]
    pro, = by["sim.prologue"]
    wait, = by["sim.wait"]
    assert {s.run for s in run.spans} == {run.id}
    assert root["parent"] is None
    assert pro["parent"] == root["id"] and wait["parent"] == root["id"]
    assert (root["start_ns"] <= pro["start_ns"] < pro["end_ns"]
            <= wait["start_ns"] < wait["end_ns"] <= root["end_ns"])
    host = {e.name: e for e in prof.events() if e.name in RUN_SPANS}
    assert set(host) == RUN_SPANS
    assert not any(e.is_user_annotation for e in host.values())
    assert host["sim.prologue"].cpu_parent.name == "sim.run"
    assert host["sim.wait"].cpu_parent.name == "sim.run"


def _marks(run):
    return [(d["name"], d["step"]) for d in run["device"]]


def test_profiled_graphed_run_times_each_copy_and_replay(rec, graphed):
    """A graphed call marks the card's timeline five times: before the
    copy in, before the first replay, after it, after the last, after the
    clone out; the replays between are timed together, none alone."""
    _day(graphed, 2)   # the capture, untraced
    made = HostEvent.made
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _day(graphed, 6)
    (run,) = rec.runs
    by = _by_name(s.as_dict() for s in run.spans)
    assert set(by) == RUN_SPANS | {"drivers.copy_in", "drivers.replay",
                                   "drivers.clone_out"}
    assert [s["step"] for s in by["drivers.replay"]] == list(range(6))
    root = by["sim.run"][0]
    assert all(s["parent"] == root["id"] for n, v in by.items()
               if n != "sim.run" for s in v)
    assert by["sim.prologue"][0]["end_ns"] <= by["drivers.copy_in"][0][
        "start_ns"]
    assert HostEvent.made - made == 5
    dev = rec.snapshot()["runs"][0]
    assert _marks(dev) == [("drivers.copy_in", None), ("drivers.replay", 0),
                           ("drivers.replay", 1), ("drivers.replay", 6),
                           ("drivers.done", None)]
    ms = [d["ms"] for d in dev["device"]]
    assert ms[0] == 0.0 and ms == sorted(ms)
    names = [e.name for e in prof.events()]
    assert names.count("drivers.replay") == 6
    assert rec.counts == {"drivers.captures": 1, "drivers.replays": 8}
    # one replay: one mark after it; a drivers' call outside a
    # Simulation.run records no run
    with profile(activities=[ProfilerActivity.CPU]):
        _day(graphed, 1)
        graphed.step_n_quiet(graphed.init_state(), 2)
    assert len(rec.runs) == 2
    assert _marks(rec.snapshot()["runs"][1]) == [
        ("drivers.copy_in", None), ("drivers.replay", 0),
        ("drivers.replay", 1), ("drivers.done", None)]
    assert rec.counts == {"drivers.captures": 1, "drivers.replays": 11}


def test_buffer_stays_bounded_and_reuses_its_events(rec, graphed,
                                                    monkeypatch):
    """With the predicate replaced (the run tier forced on without a
    profiler), 7 runs of 3 steps: the last 3 are kept, the events of the
    runs let go are made again for none."""
    monkeypatch.setattr(diag, "tracing", lambda: True)
    for _ in range(7):
        _day(graphed, 3)
    assert len(rec.runs) == 3
    ids = [r.id for r in rec.runs]
    assert ids == sorted(ids) and len(set(ids)) == 3
    assert not any(r.profiled for r in rec.runs)
    # 5 marks a run; the 4th run's were made, the 5th-7th reused the runs
    # let go
    assert HostEvent.made == 4 * 5
    for r in rec.snapshot()["runs"]:
        assert [k for _, k in _marks(r)] == [None, 0, 1, 3, None]
    assert rec.counts["drivers.replays"] == 21
    for _ in range(5):
        graphed.release_graph()
        _day(graphed, 1)
    assert len(rec.once) == 3 and rec.counts["drivers.captures"] == 6


def test_benchmark_readers_read_a_recorded_day(rec, graphed, monkeypatch):
    """``wavebench/spans.py`` on two recorded days of 5 steps, one a
    buffered call (``step_n``, 2 calls of 3 and 2 steps): every call's
    copies, first replay and later ones, in the ms of its marks."""
    from wavebench import spans

    monkeypatch.setattr(diag, "tracing", lambda: True)
    _day(graphed, 5)
    sim = pt.Simulation.create(graphed, stop_time=4.5 * DT)
    sim.run(store=True, chunk_size=3)
    days = rec.snapshot()["runs"]
    assert [[c["n"] for c in spans.calls(d)] for d in days] == [[5], [3, 2]]
    for d in days:
        ms = {(p["name"], p["step"]): p["ms"] for p in d["device"][:5]}
        c = spans.calls(d)[0]
        assert c["first"] == pytest.approx(
            ms["drivers.replay", 1] - ms["drivers.replay", 0])
        assert c["first"] > 0 and c["steady"] > 0 and c["copy"] > 0
    cs = [c for d in days for c in spans.calls(d)]
    per = sum(c["steady"] for c in cs) / (4 + 2 + 1)
    assert spans.replay_ms(days) == pytest.approx(per)
    assert spans.launch_gap_ms(days) == pytest.approx(
        (cs[0]["first"] - per + cs[1]["first"] + cs[2]["first"] - 2 * per)
        / 2)
    assert spans.replay_bubble_ms(days, 0.0) == pytest.approx(
        per + sum(c["copy"] for c in cs) / 10)


def test_snapshot_reads_the_kernel_wrappers_launch_counters(rec,
                                                           monkeypatch):
    monkeypatch.setattr(advance_cuda.advance_cuda, "launches", 7)
    snap = rec.snapshot()
    assert snap["counters"]["advance_cuda.launches"] == 7
    assert snap["counters"]["drivers.replays"] == 0
    assert "pic_gather_remesh.launches" in snap["counters"]
    assert "remesh_cuda.f64_launches" in snap["counters"]
    assert snap["once"] == [] and snap["runs"] == []


def test_profile_trace_shows_the_run_spans(rec, tmp_path):
    """``profile_trace``'s Chrome trace holds the run's spans as host
    operations, none of them a user annotation."""
    logdir = str(tmp_path / "trace")
    model = _model()
    with diag.profile_trace(logdir):
        _day(model, 2)
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    cats = {e["name"]: e.get("cat") for e in events
            if e.get("name") in RUN_SPANS}
    assert set(cats) == RUN_SPANS
    assert "user_annotation" not in cats.values()
    assert len(rec.runs) == 1
