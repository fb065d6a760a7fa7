"""The benchmark of the PyTorch port: one cell, one run.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; the harness finds each piece by name, one
file each, so a later change adds a configuration, a mix, a forcing kind, a
model family, a metric or a cell by adding files and entries:

- ``configs/<config>.json``: the configuration's sizes and settings and its
  ``family``, and ``configs/<config>.py`` beside it, whose ``grids(cfg,
  device)`` builds the port's grid and the plain reference's;
- ``families/<family>.py``: both sides' models, the members, what is
  compared (``families/wave_growth_2d.py`` says what a family gives);
- ``traffic/<mix>.json``: the mix's parameters (its forcing's kind and
  parameters, the member pool, the horizon, the days it checks);
- ``forcing/<kind>.py``: ``make(spec, seed, device)``, the plain wind of a
  kind (a ``reference.Wind``, which names the port's wind too);
- ``metrics/<metric>.py``: one reader a metric, ``read(run)`` -> a number,
  or None where the run has nothing to read;
- ``limits/<cell>.json``: the limits of the numbers that decide ``correct``.

A run: set-up (the forcing, both grids, the pool of members, the port's
model, its capture and ``WARM_S`` seconds of member-days), then a closed
loop of jobs for ``--seconds``: each job one member's horizon through
``Simulation.run`` (no store) from t = 0, the members in turn.  The job
that runs past the window's end finishes and counts.  With ``--trace 1``
the window is followed by a probe of the host's enqueue of a replay and a
profiler trace of the compared members' days.  Then the port's state is
freed and the plain reference runs the compared member-days from the same
inputs, regenerated from the seed (``compare.py``): the job drawn from the
seed and, where the mix's ``check_days`` is 2, the window's last job.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from . import compare, generator
from . import trace as T

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules no run may hold once its window has closed (whole top-level
# names): JAX, and the port's JAX reference package
FORBIDDEN = ("jax", "jaxlib", "flax", "picles_tpu")
# seconds of member-days that end the set-up: under a sustained load the
# card ran member-days 4.5% slower for its first 5-14 s (an H100 at 700 W,
# its SM clock at 1980 MHz throughout), so the window starts after them
WARM_S = 20.0
# the compared jobs: one drawn from the seed among the first SAMPLE_RANGE
# (every window finishes that many) and, where the mix's ``check_days`` is
# 2, the last job of the window
SAMPLE_RANGE = 16
# a spin of the card (about 0.1 s) ahead of a probe's launches
SPIN_CYCLES = 200_000_000


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names that ``modules`` (default
    ``sys.modules``) holds, compared whole."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def load_module(path: Path, name: str):
    """A module from its file (names may hold dots and dashes)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merged(base: dict, over: Optional[dict]) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


class Bench:
    """``BENCHMARK.json`` and the files it names, found by name under
    ``bench_dir``."""

    def __init__(self, root: Path = ROOT, bench_dir: Path = HERE):
        self.root, self.dir = Path(root), Path(bench_dir)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def config_module(self, name: str):
        return load_module(self.dir / "configs" / f"{name}.py",
                           f"wavebench_config_{name}")

    def family(self, name: str):
        return load_module(self.dir / "families" / f"{name}.py",
                           f"wavebench_family_{name}")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def forcing(self, kind: str):
        return load_module(self.dir / "forcing" / f"{kind}.py",
                           f"wavebench_forcing_{kind}")

    def limits(self, cell: str) -> dict:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def metric(self, name: str):
        return load_module(self.dir / "metrics" / f"{name}.py",
                           f"wavebench_metric_{name}")

    def metrics_for(self, cell: str, traced: bool) -> list:
        """The cell's metric entries: its end-to-end metrics, or with
        ``traced`` its per-layer ones (those whose ``workloads`` list it,
        or that list none)."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.spec[key]
                if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: str
    config: dict
    traffic: dict
    nodes: int
    steps: int
    DT: float
    setup_s: float = 0.0
    capture_s: float = 0.0
    jobs: list = dataclasses.field(default_factory=list)   # (start, end) s
    peak_bytes: int = 0
    probes: dict = dataclasses.field(default_factory=dict)
    trace: Optional[T.Summary] = None
    # what the kernels read beyond the nodes' planes (``reference.Wind``):
    # window planes a lane, frames a window straddles, forcing values a
    # step; whether the projection varies from node to node
    n_wf: int = 0
    B: int = 0
    wind_values: int = 0
    proj: bool = False
    # the reference's counts over the traced member-days (live lanes,
    # substeps tried, steps), for the rooflines
    work: Optional[dict] = None


class Cell:
    """One cell's set-up, window, probes and comparison."""

    def __init__(self, bench: Bench, workload: str, seed: int, device,
                 overrides: Optional[dict] = None, log=None):
        self.bench, self.name, self.seed = bench, workload, int(seed)
        self.device = torch.device(device)
        self.log = log or (lambda msg: print(msg, file=sys.stderr,
                                             flush=True))
        w = bench.workload(workload)
        ov = overrides or {}
        self.cfg = merged(bench.config(w["config"]), ov.get("config"))
        self.traffic = merged(bench.traffic(w["traffic"]), ov.get("traffic"))
        self.builder = bench.config_module(w["config"])
        self.family = bench.family(self.cfg["family"])
        self.kind = bench.forcing(self.traffic["forcing"]["kind"])
        self.limits = merged(bench.limits(workload), ov.get("limits"))
        self.DT = float(self.cfg["DT"])
        self.steps = generator.steps_per_job(self.traffic, self.DT)
        self.on_cuda = self.device.type == "cuda"

    # -- set-up --------------------------------------------------------

    def reference_model(self):
        """The plain reference on the configuration's grid (kept on the
        host while the port runs)."""
        return self.family.reference(self.ref_grid_host.to(self.device),
                                     self.wind, self.ref_settings)

    def members(self, ref):
        """The mix's members, made again from the seed, for ``ref``."""
        return self.family.members(self.traffic["pool"], ref, self.seed)

    def grids(self):
        return self.builder.grids(self.cfg, self.device)

    def setup(self, warm_s: float = WARM_S) -> None:
        """The forcing, the grids, the pool, the port's model, its capture
        (``capture_s``), and member-days for ``warm_s`` seconds (one at
        least)."""
        import picles_torch as pt

        fam = self.family
        self.wind = self.kind.make(self.traffic["forcing"], self.seed,
                                   self.device)
        prog_grid, ref_grid = self.grids()
        self.prog_settings, self.ref_settings = fam.settings(self.cfg,
                                                             self.traffic)
        ref = fam.reference(ref_grid, self.wind, self.ref_settings)
        self.pool = [fam.program_state(s) for s in self.members(ref)]
        self.ref_grid_host = ref_grid.to("cpu")
        self.proj = fam.projected(ref_grid)
        del ref, ref_grid
        self.nodes = int(prog_grid.x.numel())
        self.model = fam.program(self.cfg, prog_grid, self.wind.port(pt),
                                 self.prog_settings)
        self.sync()
        t0 = time.perf_counter()
        self.model.step_n_quiet(self.pool[0], 1)
        self.sync()
        self.capture_s = time.perf_counter() - t0
        t0, k = time.perf_counter(), 1
        while True:
            self.job(self.pool[k % len(self.pool)])
            k += 1
            if time.perf_counter() - t0 >= warm_s:
                break

    def sync(self) -> None:
        if self.on_cuda:
            torch.cuda.synchronize(self.device)

    def job(self, member):
        """One member's horizon through ``Simulation.run`` from t = 0; the
        final state (``Simulation.run`` waits for the card)."""
        import picles_torch as pt

        sim = pt.Simulation(model=self.model, dt=self.DT,
                            stop_time=(self.steps - 0.5) * self.DT,
                            state=member, initialized=True)
        sim.run()
        return sim.state

    # -- the window ----------------------------------------------------

    def window(self, seconds: float) -> dict:
        """Jobs back to back, the members in turn, until ``seconds`` have
        passed (the last job finishes).  Keeps each job's clock and
        counters, and the final states of the compared jobs."""
        rng = torch.Generator().manual_seed(generator.substream(self.seed, 3))
        self.sample = int(torch.randint(SAMPLE_RANGE, (1,), generator=rng))
        jobs, finals, kept = [], [], {}
        i, P = 0, len(self.pool)
        t_start = time.perf_counter()
        while True:
            ta = time.perf_counter()
            out = self.job(self.pool[i % P])
            tb = time.perf_counter()
            jobs.append((ta, tb))
            finals.append((out.time, out.iteration, out.metrics))
            if i == self.sample:
                kept[i] = out
            last = (i, out)
            i += 1
            if tb - t_start >= seconds:
                break
        if int(self.traffic["check_days"]) > 1 or not kept:
            kept[last[0]] = last[1]
        self.sync()
        return dict(jobs=jobs, finals=finals, kept=kept)

    # -- probes of a traced run -------------------------------------------

    def probe_enqueue(self, steps: int = 8, reps: int = 3) -> float:
        """Host ms to enqueue one replay of the captured step: ``steps``
        steps through ``step_n_quiet`` (copy in, the replays, clone out)
        timed from the call to its return, queued behind a spin of the card
        so that no launch waits for it (median of ``reps``)."""
        out = []
        for r in range(reps):
            self.sync()
            torch.cuda._sleep(SPIN_CYCLES)
            t0 = time.perf_counter()
            self.model.step_n_quiet(self.pool[r % len(self.pool)], steps)
            out.append((time.perf_counter() - t0) * 1e3 / steps)
            self.sync()
        return statistics.median(out)

    def traced_days(self, members) -> T.Summary:
        """A profiler trace of ``members``' member-days, back to back."""
        def run():
            for m in members:
                with torch.profiler.record_function("wavebench.job"):
                    self.job(self.pool[m])

        dev, host, spans = T.profile(run, want=("K1", self.steps * len(
            members)))
        return T.summarize(dev, host, spans, self.steps * len(members))

    def release(self) -> None:
        """Free the port's model, capture and pool."""
        self.model.release_graph()
        self.model = None
        self.pool = None
        if self.on_cuda:
            torch.cuda.empty_cache()


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             traced: bool, device, t_process: float,
             overrides: Optional[dict] = None, log=None,
             warm_s: float = WARM_S) -> dict:
    """One run of a cell; returns the result line's object."""
    cell = Cell(bench, workload, seed, device, overrides, log)
    clock = [time.perf_counter()]

    def phase(name):
        now = time.perf_counter()
        cell.log(f"phase {name}: {now - clock[0]:.2f} s")
        clock[0] = now

    if cell.on_cuda:
        torch.cuda.reset_peak_memory_stats(cell.device)
    cell.setup(warm_s)
    setup_s = time.perf_counter() - t_process
    phase("set-up")
    win = cell.window(seconds)
    phase(f"window ({len(win['jobs'])} member-days)")
    cell.log("member-day ms: " + " ".join(f"{(b - a) * 1e3:.1f}"
                                          for a, b in win["jobs"]))
    peak = (torch.cuda.max_memory_allocated(cell.device) if cell.on_cuda
            else 0)
    g = cell.ref_grid_host
    run = Run(cell=workload, config=cell.cfg, traffic=cell.traffic,
              nodes=cell.nodes, steps=cell.steps, DT=cell.DT,
              setup_s=setup_s, capture_s=cell.capture_s, jobs=win["jobs"],
              peak_bytes=peak, n_wf=cell.wind.n_wf(cell.DT),
              B=cell.wind.breakpoints(cell.DT),
              wind_values=cell.wind.values_read(g.x, g.y, cell.DT),
              proj=cell.proj)
    traced_members = []
    if traced:
        run.probes["enqueue_ms"] = cell.probe_enqueue()
        phase("probes")
        P = len(cell.pool)
        traced_members = sorted({j % P for j in win["kept"]})
        run.trace = cell.traced_days(traced_members)
        phase("trace")
    cell.release()

    verdict = compare.judge(cell, win, traced_members)
    run.work = verdict.pop("work", None)
    phase("reference")
    metrics = {}
    for m in bench.metrics_for(workload, traced):
        value = bench.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cell.on_cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(cell.device)
                            if cell.on_cuda else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": verdict["correct"], "attempted": len(win["jobs"]),
           "failed": verdict["failed_jobs"], "metrics": metrics,
           "device": device_info}
    if traced and run.trace is not None:
        tr = run.trace
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        out["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in tr.by_name[:10]],
            "idle_gaps": [[n[:160], s] for n, s in tr.idle_gaps[:10]]}
    out["checks"] = verdict["checks"]
    return out
