"""Multi-step drivers (PyTorch port of ``picles_tpu/models/drivers.py``).

The JAX package compiles its drivers: ``step_n`` is ``jax.jit`` over
``lax.scan``, ``step_n_buffered`` and ``step_n_quiet`` over ``fori_loop``,
and ``step_jit`` is ``jax.jit(self.step)``.  PyTorch's counterpart of a
compiled step program on the card is a CUDA graph: the step is captured
once (``StepGraph``), and each replay launches every kernel and device op of
the step in one call, where the eager step makes the host dispatch each of
them (about 180 to 670 a step).

When the model's ``graphed`` is true, the four drivers replay one captured
step:

- ``step_n_quiet(ms, n)``: ``ms`` is copied into the graph's input state
  once, the graph replays ``n`` times, and the result is cloned out once;
- ``step_n_buffered(ms, n, capacity)``: the same, each step's Eulerian
  state copied into row i of a ``[capacity, *state.shape]`` buffer after
  its replay; rows past ``n`` stay zero, and a shorter chunk replays fewer
  times (it never captures again);
- ``step_n(ms, n)``: ``step_n_buffered`` with ``capacity = n``;
- ``step_jit()``: a callable ``ms -> ms`` (one replay) whose results are
  clones, so they never alias the graph's buffers: ``f(f(s0))`` leaves the
  first result intact, as JAX's immutable arrays do.

``graphed`` is fixed when the model is built: true for a ``WaveGrowth2D``
on a CUDA device with the advance resolved to kernel K1 (float32 or
float64, each with instances of its own), for a ``WaveGrowth1D`` whose
advance is kernel K7 (a CUDA device, float32 and a node, gridded or traced
wind), and for a ``ShardedWaveGrowth2D`` over NCCL whose wrapped model is
graphed.  Elsewhere the drivers run ``self.step`` in a Python loop, for
these reasons: the CPU has no graphs; the plain advance
(``tsit5.integrate_to``: the CPU's, and on the card only where the caller
asks for ``advance_mode="torch"``, as a float64 1D model, or a float64 2D
model whose wind callable reads its time, must) tests on the host whether
its loop is done, once an iteration, which a replay cannot repeat; and a
sharded step over gloo stages every message through host memory.  A capture or a
replay that fails raises: the drivers never fall back to the loop.
``model.step`` in a loop is always the eager step.

A step that issues collectives (the sharded step over NCCL) is captured
the same way on every rank, since every rank calls the same drivers in the
same order: the warm-up steps run each collective eagerly first, so
NCCL's communicator exists before the capture, and the ranks meet at
``capture_sync()`` (a barrier) before any of them captures.  Every capture
runs in the thread-local error mode: NCCL's watchdog thread polls the
events of the work it tracks, a call that a capture in the global mode
forbids to every thread of the process (a step without collectives
captures the same graph in either mode).
PyTorch does not hand the watchdog the work of a captured collective,
whose ``wait()`` stays a wait of the current stream on NCCL's.

A capture holds one copy of the model state (the graph's input state),
the graph's private memory pool (every intermediate of one step and its
output state) and references to the model's caches the step reads
(``graph_keep``): at 1536^2 the input and output states take 186.5 MiB,
and warm-up and capture reserve 318-506 MiB more (measured on an H100,
root ``PERF.md`` §6).  The model keeps one capture, for the leaves'
shapes, dtypes and device of the last state its drivers were given
(another layout captures anew); it goes with the model, or with
``release_graph()``.  The kernel wrappers' launch counters count the
host's calls: the warm-up steps and the capture tick them, replays do not.
"""

from __future__ import annotations

import functools

import torch

# eager steps on a side stream before a capture (torch.cuda.graph's
# recipe): they build the kernels and fill the model's caches, which must
# never happen under capture
WARMUP_STEPS = 3


def layout(ms) -> tuple:
    """The shapes, dtypes and devices of a state's leaves."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in ms.leaves())


class StepGraph:
    """One step of ``model`` captured in a CUDA graph over a fixed input
    state (``state``), the step's new state copied back into it at the end
    of the graph, so that each replay advances ``state`` by one step."""

    def __init__(self, model, ms):
        dev = ms.state.device
        self.layout = layout(ms)
        self.state = ms.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                model.step(self.state)
        torch.cuda.current_stream(dev).wait_stream(side)
        model.capture_sync()
        self.keep = model.graph_keep()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = model.step(self.state)
            self.state.copy_(self.out)


class StepDrivers:
    """Mixin: multi-step drivers over ``self.step(state) -> state``."""

    _graphed = False
    _graph = None

    @property
    def graphed(self) -> bool:
        """Whether the drivers replay a CUDA graph of ``self.step`` (fixed
        when the model is built; see the module docstring)."""
        return self._graphed

    def graph_keep(self) -> tuple:
        """What a captured step reads besides the model's attributes and
        its input state, kept alive by the capture."""
        return ()

    def capture_sync(self) -> None:
        """Called between the warm-up and the capture; a step that issues
        collectives makes every rank meet here."""

    def release_graph(self) -> None:
        """Drop the capture: its memory goes back to PyTorch's caching
        allocator (``torch.cuda.empty_cache()`` returns it to the card)."""
        self._graph = None

    def _capture(self, ms) -> StepGraph:
        if self._graph is None or self._graph.layout != layout(ms):
            self.release_graph()
            self._graph = StepGraph(self, ms)
        return self._graph

    def _run(self, ms, n: int, each=None):
        """``n`` steps from ``ms``, ``each(i, state)`` called with the
        Eulerian state after step i; graphed or in a loop."""
        if not self.graphed or n == 0:
            for i in range(n):
                ms = self.step(ms)
                if each is not None:
                    each(i, ms.state)
            return ms
        g = self._capture(ms)
        g.state.copy_(ms)
        for i in range(n):
            g.graph.replay()
            if each is not None:
                each(i, g.state.state)
        return g.state.clone()

    def step_n(self, ms, n: int):
        """n steps; returns (final state, stacked Eulerian states
        ``[n, nx, ny, 3]``)."""
        return self.step_n_buffered(ms, n, n)

    def step_n_buffered(self, ms, n: int, capacity: int):
        """``step_n`` into a ``capacity``-row buffer; rows past ``n`` stay
        zero.  Returns (final state, buffer)."""
        if n > capacity:
            raise ValueError(f"n={n} exceeds the buffer capacity {capacity}")
        buf = ms.state.new_zeros((capacity,) + tuple(ms.state.shape))
        ms = self._run(ms, n, lambda i, s: buf[i].copy_(s))
        return ms, buf

    def step_n_quiet(self, ms, n: int):
        """n steps with no per-step output."""
        return self._run(ms, n)

    def step_jit(self):
        """``self.step`` as one replay of the captured step where the model
        is graphed (results are clones), else ``self.step``."""
        return functools.partial(self.step_n_quiet, n=1)
