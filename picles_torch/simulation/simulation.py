"""Simulation driver (PyTorch port of
``picles_tpu/simulation/simulation.py``).

``run`` keeps the JAX package's loop semantics: an initial store write, one
model step per DT until the clock passes ``stop_time``, steps in chunks
between which the wall-time limit and the callbacks are checked.  The steps
queue on the model's device; the loop waits for the device only where it
must: at a chunk end that checks a wall-time limit or runs callbacks, at a
store push, and once at the end of ``run`` (so ``run_wall_time`` is the
time of the work, not of its enqueueing).  On the card the model's drivers
replay a CUDA graph of the step (``models/drivers.py``): the first chunk
captures it, and every chunk, a shorter last one too, replays it.  So a
model's first ``run_wall_time`` holds the capture, which the port's
recorder (``utils.diagnostics.tracer()``) shows as the span
``drivers.capture``.

A sharded model (``parallel/sharded.py``) is driven the same way on every
rank: each store push gathers the blocks to rank 0, which alone writes the
store; a checkpoint is written whole by rank 0, and ``pickup`` slices a
whole checkpoint.
"""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np
import torch

from ..utils import diagnostics
from .store import CashStore, EmptyStore, StateStore


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclasses.dataclass
class Simulation:
    """Driver state.

    ``callbacks``: name -> callable(sim), called after every chunk; a
    callback that raises stops the run (``utils.diagnostics.check_nans`` on
    ``sim.state`` is a NaN checker).
    """

    model: object
    dt: float
    stop_time: float
    wall_time_limit: float = float("inf")
    verbose: bool = False
    store: object = dataclasses.field(default_factory=EmptyStore)
    state: object = None
    initialized: bool = False
    run_wall_time: float = 0.0
    running: bool = False
    callbacks: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def create(cls, model, stop_time: float, verbose: bool = False,
               wall_time_limit: float = float("inf")) -> "Simulation":
        return cls(model=model, dt=model.settings.timestep,
                   stop_time=stop_time, verbose=verbose,
                   wall_time_limit=wall_time_limit)

    # -- initialization ------------------------------------------------

    def initialize(self) -> None:
        """Seed the particles."""
        self.state = self.model.init_state()
        self.initialized = True

    def reset(self) -> None:
        """Seed anew, zero the wall time and reset the store."""
        self.initialize()
        self.run_wall_time = 0.0
        self.store.reset()

    def pickup(self, path: str) -> None:
        """Resume from a checkpoint (either package's npz) on the model's
        device."""
        from .checkpoint import load_checkpoint

        load = getattr(self.model, "load_checkpoint", None)
        self.state = (load(path) if load is not None
                      else load_checkpoint(path, device=self.model.device))
        self.initialized = True

    def checkpoint(self, path: str) -> str:
        from .checkpoint import save_checkpoint

        save = getattr(self.model, "save_checkpoint", None)
        return (save(path, self.state) if save is not None
                else save_checkpoint(path, self.state))

    def n_steps(self) -> int:
        """Steps of the loop: it runs while stop_time >= clock time."""
        return int(np.floor(self.stop_time / self.dt)) + 1

    # -- stores --------------------------------------------------------

    def init_state_store(self, path: str, name: str = "state",
                         replace: bool = True) -> StateStore:
        """An HDF5 ``StateStore`` sized for the whole horizon: ``[time, x,
        y, state]``, ``[time, layer, x, y, state]`` for a layered model
        (``model.layers > 1``), ``[time, x, state]`` for the 1D model.  ``replace=False`` re-attaches an existing
        file (checkpoint-resume legs): the run loop aligns the write cursor
        to the resumed state's iteration."""
        if not getattr(self.model, "is_root", True):
            self.store = EmptyStore()   # rank 0 writes a sharded run's store
            return self.store
        g = self.model.grid
        nsteps = self.n_steps()
        coords = dict(
            time=np.arange(0.0, (nsteps + 1) * self.dt, self.dt)[:nsteps + 1])
        layers = getattr(self.model, "layers", 1)
        if layers > 1:
            coords["layer"] = np.arange(layers, dtype=float)
        if g.x.dim() == 2:
            coords["x"] = g.x[:, 0].cpu().numpy()
            coords["y"] = g.y[0, :].cpu().numpy()
        else:
            coords["x"] = g.x.cpu().numpy()
        coords["state"] = ["e", "m_x", "m_y"]
        self.store = StateStore(path, coords, name=name, replace=replace)
        return self.store

    def _push(self, t, block: bool = False) -> None:
        """Push a state (``block``: a stacked ``[n, ...]`` run of states) to
        the store; a sharded model gathers it to rank 0 first, and only
        rank 0 pushes."""
        gather = getattr(self.model, "gather_blocks", None)
        if gather is not None:
            t = gather(t, 1 if block else 0)
            if t is None:
                return
        if not block:
            self.store.push(t)
        elif hasattr(self.store, "push_block"):
            self.store.push_block(t)
        else:
            for s in t:
                self.store.push(s)

    # -- main loop -----------------------------------------------------

    def run(self, store: bool = False, cash_store: bool = False,
            chunk_size: int = 0) -> None:
        """Run to ``stop_time``.

        With a store, every step's state is kept: steps run in chunks of
        ``chunk_size`` (default 64) through ``step_n_buffered``, whose
        ``[chunk, nx, ny, 3]`` buffer (``[chunk, L, nx, ny, 3]`` layered)
        bounds the device memory for any horizon, and each chunk goes to the
        store.  Without a store, steps
        run through ``step_n_quiet``, in one chunk unless a wall-time limit
        or callbacks need chunk ends (then 64 steps a chunk).

        Where a profiler records (``utils.diagnostics.tracing()``, checked
        once a call), the call is one run of the port's recorder
        (``diagnostics.tracer()``): the span ``sim.run`` around it,
        ``sim.prologue`` from its entry to its first call into the model's
        drivers, the drivers' spans (``drivers.copy_in``, one
        ``drivers.replay`` a replay, ``drivers.clone_out``; ``drivers.capture``
        where the first chunk captures) and their five marks of the card's
        timeline a graphed call (``models/drivers.py``), and ``sim.wait``
        around the final wait for the card, all with the run's id.
        """
        if not diagnostics.tracing():
            return self._run(store, cash_store, chunk_size)
        with diagnostics.tracer().run("sim.run", "sim.prologue"):
            self._run(store, cash_store, chunk_size)

    def _run(self, store: bool, cash_store: bool, chunk_size: int) -> None:
        t_wall = _time.time()
        if not self.initialized:
            self.initialize()

        if cash_store:
            self.store = CashStore()

        use_store = store or cash_store
        if use_store:
            if isinstance(self.store, StateStore):
                # a resumed state at iteration k belongs at row k
                self.store.iteration = int(self.state.iteration)
            self._push(self.state.state)  # initial state write

        remaining = self.n_steps() - int(self.state.iteration)
        if remaining <= 0:
            if self.verbose:
                print("stop_time exceeded, run not executed")
            return

        needs_chunks = self.wall_time_limit != float("inf") or self.callbacks
        if use_store:
            chunk = chunk_size or 64
        else:
            chunk = chunk_size or (64 if needs_chunks else remaining)
        done = 0
        while done < remaining:
            n = min(chunk, remaining - done)
            if use_store:
                self.state, states = self.model.step_n_buffered(
                    self.state, n, chunk)
                self._push(states[:n], block=True)
            else:
                self.state = self.model.step_n_quiet(self.state, n)
                if needs_chunks:
                    _sync(self.state.state)
            done += n
            if self.verbose:
                print(f"t = {float(self.state.time):.0f} s "
                      f"({done}/{remaining} steps)")
            for cb in self.callbacks.values():
                cb(self)
            over = _time.time() - t_wall > self.wall_time_limit
            agree = getattr(self.model, "any_rank", None)
            if agree is not None and self.wall_time_limit != float("inf"):
                over = agree(over)   # the ranks of a sharded run stop together
            if over:
                print("wall time limit reached")
                break

        with diagnostics.tracer().span("sim.wait"):
            _sync(self.state.state)
        self.run_wall_time += _time.time() - t_wall
