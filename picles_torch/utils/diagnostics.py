"""Run diagnostics and profiling hooks (PyTorch port of
``picles_tpu/utils/diagnostics.py``): structured per-step summaries and a
NaN checker, which read the device; a per-step wall-clock timer that
waits for the card; and a ``torch.profiler`` trace of a block, written as
a Chrome trace (open it in Perfetto or ``chrome://tracing``)."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator

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


@contextlib.contextmanager
def profile_trace(logdir: str = os.path.join(tempfile.gettempdir(),
                                             "picles_torch_trace")
                  ) -> Iterator[torch.profiler.profile]:
    """Trace a block with ``torch.profiler`` (host, and the card's kernels
    where there is one) and write it into ``logdir`` as a Chrome trace,
    ``<pid>.<ms>.pt.trace.json``, when the block ends (the card is waited
    for first).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
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
