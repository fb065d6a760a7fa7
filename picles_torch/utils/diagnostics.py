"""Run diagnostics and profiling hooks (PyTorch port of
``picles_tpu/utils/diagnostics.py``): structured per-step summaries and a
NaN checker, which read the device; a per-step wall-clock timer that
waits for the card; a ``torch.profiler`` trace of a block, written as a
Chrome trace (open it in Perfetto or ``chrome://tracing``); and the port's
in-memory recorder of spans and counters (``tracer()``)."""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..models.state import TensorTree


def mean_of_state(ms) -> float:
    """Mean energy over the nodes."""
    return float(ms.state[..., 0].mean())


def max_energy(ms) -> float:
    return float(ms.state[..., 0].max())


def max_cgx(ms) -> float:
    return float(ms.state[..., 1].max())


def max_cgy(ms) -> float:
    return float(ms.state[..., 2].max())


def check_nans(ms, name: str = "state") -> None:
    """Raise ``FloatingPointError`` if the node state holds a NaN or an
    infinity."""
    bad = ~ms.state.isfinite()
    if bool(bad.any()):
        raise FloatingPointError(f"{int(bad.sum())} non-finite values in "
                                 f"{name} at t={float(ms.time)}")


def step_summary(ms) -> dict:
    """One structured log record of a step: clock, energy, counters."""
    m = ms.metrics
    return dict(time=float(ms.time), iteration=int(ms.iteration),
                mean_e=mean_of_state(ms), max_e=max_energy(ms),
                n_active=int(m.n_active), n_failed=int(m.n_failed),
                n_gather=int(m.n_gather), n_reseed=int(m.n_reseed),
                n_off=int(m.n_off), n_relight=int(m.n_relight),
                n_clamped=int(m.n_clamped),
                substeps_max=int(m.substeps_max))


# seconds the host idles after a trace's head and after its block
TRACE_PAD_S = 0.05


@contextlib.contextmanager
def profile_trace(logdir: str = os.path.join(tempfile.gettempdir(),
                                             "picles_torch_trace")
                  ) -> Iterator[torch.profiler.profile]:
    """Trace a block with ``torch.profiler`` (host, and the card's kernels
    where there is one) and write it into ``logdir`` as a Chrome trace,
    ``<pid>.<ms>.pt.trace.json``, when the block ends (the card is waited
    for first).  Yields the profiler.

    On a card the trace opens with a head: one short spin kernel run to its
    end, then the host idle ``TRACE_PAD_S`` s; and the host idles as long
    after the block.  Without it a trace taken late in a process can lose
    the device operations of its first moments.  While the profiler
    records, the port records its run spans (``tracer``), and every span
    shows in the Chrome trace as a host event of its name (``sim.run``,
    ``drivers.replay`` ...; ``drivers.capture`` where the block captures)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        if cuda:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
                time.sleep(TRACE_PAD_S)
    prof.export_chrome_trace(os.path.join(
        logdir, f"{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"))


def _cuda_devices(x) -> set:
    """The CUDA devices of a tensor, a state or a sequence of them."""
    if isinstance(x, torch.Tensor):
        return {x.device} if x.is_cuda else set()
    if isinstance(x, TensorTree):
        x = x.leaves()
    return set().union(*(_cuda_devices(v) for v in x)) if x else set()


class StepTimer:
    """Wall-clock times of blocks (``measure``), each ending when the card
    that holds ``sync_on`` is done."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self, sync_on=None):
        """Time the block; ``sync_on`` (a tensor, a state or a sequence of
        them) names the CUDA devices to synchronize before the clock stops;
        on CPU tensors nothing is waited for."""
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            for dev in _cuda_devices(sync_on):
                torch.cuda.synchronize(dev)
        self.times.append(time.perf_counter() - t0)

    def summary(self) -> dict:
        a = np.asarray(self.times)
        if a.size == 0:
            return {}
        return dict(n=a.size, mean_s=float(a.mean()), min_s=float(a.min()),
                    p50_s=float(np.percentile(a, 50)),
                    p95_s=float(np.percentile(a, 95)))


# ---------------------------------------------------------------------------
# the port's recorder of spans and counters
# ---------------------------------------------------------------------------

# runs (and once-a-model spans) whose records the recorder keeps
RUNS_KEPT = 64

# the kernel wrappers' launch counters: each wrapper, its counters' names
LAUNCH_COUNTERS = {}


def launch_counters(wrapper, *names: str) -> None:
    """Give a kernel wrapper its launch counters ``names``: attributes of
    the wrapper, at 0, that it adds to at each launch; ``launch_counts``
    (and so ``Tracer.snapshot``) reads them.  Called where the wrapper is
    defined."""
    for n in names:
        setattr(wrapper, n, 0)
    LAUNCH_COUNTERS[wrapper] = names


def launch_counts() -> dict:
    """The kernel wrappers' launch counters (``advance_cuda.launches``
    ...), read where they are kept: they count the host's calls of each
    wrapper, a graph's warm-up and capture included, its replays not."""
    return {f"{f.__name__}.{n}": getattr(f, n)
            for f, names in LAUNCH_COUNTERS.items() for n in names}


def tracing() -> bool:
    """Whether the recorder's run tier records: while a ``torch.profiler``
    session records.  The run tier's one predicate, checked once a
    ``Simulation.run``; the drivers' calls inside follow the run."""
    return torch._C._autograd._profiler_enabled()


class Span:
    """One host span: ``name``, ``start_ns`` and ``end_ns``
    (``time.perf_counter_ns``), ``parent`` (the id of the span it opened
    in, or None), ``run`` (the id of its run, or None) and ``step`` (a
    replay's index in its drivers' call)."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "run", "step",
                 "mark")
    FIELDS = ("id", "name", "start_ns", "end_ns", "parent", "run", "step")

    def __init__(self, id: int, name: str, parent: Optional[int],
                 run: Optional[int], step: Optional[int]):
        self.id, self.name, self.parent, self.run, self.step = (
            id, name, parent, run, step)
        self.start_ns = self.end_ns = 0
        self.mark = None   # its host event on the profiler's timeline

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.FIELDS}


class RunRecord:
    """A recorded run: its spans, its marks on the card (``(name, step,
    timing event)``, in the order recorded) and the marks resolved to ms
    (``device``, once read)."""

    __slots__ = ("id", "profiled", "spans", "marks", "device")

    def __init__(self, id: int, profiled: bool):
        self.id, self.profiled = id, profiled
        self.spans, self.marks, self.device = [], [], None


# the run tier's span outside a recorded run
_NO_SPAN = contextlib.nullcontext()


class Tracer:
    """The port's in-memory recorder of spans and counters (the process's
    own is ``tracer()``; one thread records).  Nothing is written to disk:
    ``snapshot()`` reads what it holds.

    Counters (``counts``, plain integers, always on): ``drivers.captures``,
    steps captured in a CUDA graph, and ``drivers.replays``, replays of a
    captured step.  ``snapshot`` shows the kernel wrappers' launch counters
    beside them.

    Spans, in two tiers:

    - once a model, always (``once``, the last ``keep``):
      ``drivers.capture`` (the eager warm-up steps, the capture and the
      graph's instantiation) and inside it ``drivers.warmup``;
    - a run's, where ``tracing()`` holds as a ``Simulation.run`` starts
      (``runs``, the last ``keep`` runs): ``sim.run`` (the root),
      ``sim.prologue`` (from the run's entry to its first call into the
      drivers), ``drivers.copy_in``, ``drivers.replay`` (one a replay,
      ``step`` its index in its drivers' call), ``drivers.clone_out`` and
      ``sim.wait`` (the final wait for the card).

    A recorded run also marks the card's timeline (``mark``): a timing
    event recorded on the current stream between two launches, outside
    any graph; the drivers place five a graphed call (``models/drivers.py``)
    and none a replay.  The events come from a pool and are read only when
    ``snapshot`` resolves them.

    Every span is also a host event of its name on the profiler's timeline
    (``_RecordFunctionFast``: not a user annotation, so the profiler makes
    no device-side copy of it)."""

    def __init__(self, keep: int = RUNS_KEPT):
        self.keep = keep
        self.counts = {"drivers.captures": 0, "drivers.replays": 0}
        self.once = collections.deque(maxlen=keep)
        self.runs = collections.deque()
        self._ids = itertools.count(1)
        self._open = []        # open spans, innermost last
        self._run = None       # the run being recorded
        self._prologue = None
        self._pool = []        # timing events free for reuse

    def _begin(self, name: str, step: Optional[int] = None,
               once: bool = False) -> Span:
        run = self._run
        s = Span(next(self._ids), name,
                 self._open[-1].id if self._open else None,
                 run.id if run is not None else None, step)
        (self.once if once else run.spans).append(s)
        self._open.append(s)
        s.mark = torch._C._profiler._RecordFunctionFast(name)
        s.mark.__enter__()
        s.start_ns = time.perf_counter_ns()
        return s

    def _end(self, s: Span) -> None:
        s.end_ns = time.perf_counter_ns()
        s.mark.__exit__(None, None, None)
        s.mark = None
        self._open.remove(s)

    def span(self, name: str, step: Optional[int] = None,
             once: bool = False):
        """A span around a ``with`` block: a once-a-model span (``once``)
        always, a run's span only while a run is recorded (else a context
        that does nothing)."""
        if once or self._run is not None:
            return self._span(name, step, once)
        return _NO_SPAN

    @contextlib.contextmanager
    def _span(self, name: str, step: Optional[int], once: bool
              ) -> Iterator[None]:
        s = self._begin(name, step, once)
        try:
            yield
        finally:
            self._end(s)

    def mark(self, name: str, step: Optional[int] = None) -> None:
        """Inside a recorded run, a timing event recorded on the current
        stream: the card's time at the point ``name`` (with ``step``) of
        the run; nothing outside one."""
        run = self._run
        if run is not None:
            e = self._pool.pop() if self._pool else torch.cuda.Event(
                enable_timing=True)
            e.record()
            run.marks.append((name, step, e))

    @contextlib.contextmanager
    def run(self, name: str, prologue: str) -> Iterator[None]:
        """Record a run around the block, ``name`` its root span and
        ``prologue`` a span from its start to ``end_prologue()``."""
        run = self._run = RunRecord(next(self._ids),
                                    torch._C._autograd._profiler_enabled())
        root = self._begin(name)
        self._prologue = self._begin(prologue)
        try:
            yield
        finally:
            self.end_prologue()
            self._end(root)
            self._run = None
            self.runs.append(run)
            while len(self.runs) > self.keep:
                self._pool += (e for _, _, e in self.runs.popleft().marks)

    def end_prologue(self) -> None:
        """End the recorded run's prologue, if it is open."""
        if self._prologue is not None:
            self._end(self._prologue)
            self._prologue = None

    def snapshot(self) -> dict:
        """What the recorder holds, as plain data: ``counters`` (its own and
        the kernel wrappers'), ``once`` (``Span.as_dict`` each) and
        ``runs``, a dict a kept run: ``id``, ``profiled`` (whether a
        profiler recorded it), ``spans`` and ``device``: its marks in
        order, a dict each, ``name``, ``step`` and ``ms`` from the run's
        first mark.  The events are resolved here, once a run; a
        ``Simulation.run`` waits for the card before it ends, so after one
        this waits for nothing."""
        return {"counters": {**self.counts, **launch_counts()},
                "once": [s.as_dict() for s in self.once],
                "runs": [{"id": r.id, "profiled": r.profiled,
                          "spans": [s.as_dict() for s in r.spans],
                          "device": _resolve(r)} for r in self.runs]}


def _resolve(run: RunRecord) -> list:
    """A kept run's marks in ms from its first (cached)."""
    if run.device is None:
        run.device = []
        if run.marks:
            t0 = run.marks[0][2]
            run.marks[-1][2].synchronize()
            run.device = [dict(name=n, step=k, ms=t0.elapsed_time(e))
                          for n, k, e in run.marks]
    return run.device


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process's recorder of spans and counters."""
    return _TRACER
