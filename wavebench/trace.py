"""Reading a profiler trace of the card: a frozen copy of the port's
trace readers (the head that holds off the profiler's loss of launches late
in a process, the kernels' names), and the reduction of the device ops to
per-step numbers and a breakdown."""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import torch

from . import stats

# the device op that opens every trace (``head``): PyTorch's spin kernel,
# which no step launches; left out of every count
HEAD = "spin_kernel"

# the port's kernels by the names they take in a trace (K1-K7, their
# baselines, and the traced and float64 instances, which carry these names
# inside a namespace)
KERNELS = {"K1": "advance_kernel<", "K1 simple": "advance_simple_kernel<",
           "K2": "pic_gather_tiled_kernel<",
           "K2 simple": "pic_gather_simple_kernel(",
           "K3": "auto_dt_kernel<", "K3 simple": "auto_dt_simple_kernel(",
           "K4 simple": "pic_gather_padded_simple_kernel(",
           "K5": "remesh_kernel<",
           "K6": "pic_gather_remesh_tiled_kernel<",
           "K6 simple": "pic_gather_remesh_simple_kernel(",
           "K7": "advance_1d_kernel<",
           "K7 simple": "advance_1d_simple_kernel<"}


def kernel_named(key: str, name: str) -> bool:
    """Whether the device op ``name`` is a launch of the float32 kernel
    ``key`` names (none of a traced or float64 library's instances)."""
    return (KERNELS[key] in name and "traced::" not in name
            and "f64::" not in name and "traced64::" not in name)


def is_port_kernel(name: str) -> bool:
    """Whether ``name`` is any instance of any of the port's kernels."""
    return any(k in name for k in KERNELS.values())


def pad_s(attempt: int) -> float:
    """Seconds the host idles on each side of a trace's work: 0.05 s,
    doubled at each retry."""
    return 0.05 * 2 ** attempt


def head(pad: float) -> None:
    """Open a trace: one short spin kernel run to its end, then the host
    idle ``pad`` s."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(pad)


class Op(NamedTuple):
    name: str
    start: float   # seconds, the profiler's clock
    end: float


def profile(run, spans=("wavebench.job",), attempts: int = 4, want=None):
    """``run()`` under ``torch.profiler`` (host and card), opened with
    ``head`` and padded with host idle time; taken again with more idle if
    the trace holds fewer ops named by ``want`` (a kernel key and a count)
    than asked, and a ``RuntimeError`` if no attempt holds them all: no
    reading comes from a trace that lost launches.  Returns (device ops,
    host ops: (name, start, end) of every CPU event, the host spans named in
    ``spans``)."""
    from torch.profiler import ProfilerActivity, profile as _profile

    for attempt in range(attempts):
        pad = pad_s(attempt)
        with _profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            head(pad)
            run()
            torch.cuda.synchronize()
            time.sleep(pad)
        dev, host = [], []
        for e in prof.events():
            tr = e.time_range
            op = Op(e.name, tr.start * 1e-6, tr.end * 1e-6)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # the device-side copies of the host spans are no ops
                if HEAD not in e.name and e.name not in spans:
                    dev.append(op)
            else:
                host.append(op)
        if want is None:
            break
        held = sum(kernel_named(want[0], o.name) for o in dev)
        if held >= want[1]:
            break
        print(f"trace: attempt {attempt} held {held} of {want[1]} "
              f"{want[0]} launches", file=sys.stderr, flush=True)
    else:
        raise RuntimeError(f"no trace of {attempts} held all {want[1]} "
                           f"{want[0]} launches")
    job_spans = [o for o in host if o.name in spans]
    return dev, host, job_spans


class Summary(NamedTuple):
    steps: int
    window_s: float
    busy_s: float
    ops: int
    kernel_s: dict      # kernel key -> seconds over the window
    glue_s: float       # seconds of device ops not the port's kernels
    by_name: list       # [(name, seconds)] by time, longest first
    idle_gaps: list     # [(what the host did, seconds)], longest first
    job_idle_s: list    # each job span's time with no device op running


def summarize(dev, host, job_spans, steps: int, keys=("K1", "K6")) -> Summary:
    """The trace's numbers over the window from the first job span's start
    to the last one's end: device busy time (the union of the device ops),
    ops, each kernel's time, the glue's, the ops by name, and the longest
    idle gaps, each named by the shortest host event running at its
    middle."""
    w0 = min(s.start for s in job_spans)
    w1 = max(s.end for s in job_spans)
    ops = [o for o in dev if o.end > w0 and o.start < w1]
    spans = [(max(o.start, w0), min(o.end, w1)) for o in ops]
    busy = stats.union_length(spans)
    by = {}
    for o in ops:
        by[o.name] = by.get(o.name, 0.0) + (o.end - o.start)
    kernel_s = {k: sum(d for n, d in by.items() if kernel_named(k, n))
                for k in keys}
    glue = sum(d for n, d in by.items() if not is_port_kernel(n))
    idle = sorted(stats.gaps(spans, w0, w1), key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in idle:
        mid = 0.5 * (a + b)
        cover = [h for h in host if h.start <= mid <= h.end]
        what = (min(cover, key=lambda h: h.end - h.start).name if cover
                else "host")
        named.append((what, b - a))
    job_idle = []
    for j in job_spans:
        inside = [(max(o.start, j.start), min(o.end, j.end)) for o in ops
                  if o.end > j.start and o.start < j.end]
        job_idle.append((j.end - j.start) - stats.union_length(inside))
    return Summary(steps=steps, window_s=w1 - w0, busy_s=busy, ops=len(ops),
                   kernel_s=kernel_s, glue_s=glue,
                   by_name=sorted(by.items(), key=lambda kv: -kv[1]),
                   idle_gaps=named, job_idle_s=job_idle)
