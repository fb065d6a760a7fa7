"""The harness finds configurations, families, traffic mixes, forcing
kinds, limits and metrics by name, and a cell, a forcing kind and a metric
added as files only."""

import json
import shutil
import time

import pytest

from wavebench.harness import HERE, ROOT, Bench, run_cell

from cases import CELLS, SMALL


def test_every_cell_finds_its_files():
    b = Bench()
    for cell in CELLS:
        w = b.workload(cell)
        cfg = b.config(w["config"])
        assert cfg["name"] == w["config"]
        assert callable(b.config_module(w["config"]).grids)
        fam = b.family(cfg["family"])
        for f in ("settings", "program", "reference", "projected",
                  "members", "program_state", "final", "compared",
                  "control", "witness"):
            assert callable(getattr(fam, f)), f
        mix = b.traffic(w["traffic"])
        assert mix["pool"]["members"] == 8
        assert callable(b.forcing(mix["forcing"]["kind"]).make)
        assert {"clock", "failed"} <= set(b.limits(cell)) <= {
            "gap_l2", "gap_max", "gap_share", "clock", "failed", "clamped"}
        for traced in (False, True):
            for m in b.metrics_for(cell, traced):
                assert callable(b.metric(m["name"]).read)


def test_metrics_for_follows_the_workloads_key():
    b = Bench()
    e2e = [m["name"] for m in b.metrics_for("box1536.steady-day", False)]
    assert e2e == ["pushes_per_s", "day_s_p90", "peak_mib", "setup_s"]
    b.spec = dict(b.spec, per_layer=b.spec["per_layer"] + [
        {"name": "x.elsewhere", "workloads": ["other.cell"]}])
    got = [m["name"] for m in b.metrics_for("box1536.steady-day", True)]
    assert "x.elsewhere" not in got and "mfu.step" in got
    assert "x.elsewhere" in [m["name"] for m in
                             b.metrics_for("other.cell", True)]


TURNED = '''"""turned: a uniform steady wind of a speed from a direction (a test
kind, added as a file)."""

import math

import torch

from wavebench import reference as R


class Turned(R.Wind):
    def __init__(self, speed, deg):
        a = math.radians(deg)
        self.u0, self.v0 = speed * math.cos(a), speed * math.sin(a)

    def sample(self, x, y, t):
        return (torch.full_like(x, self.u0, dtype=torch.float32),
                torch.full_like(x, self.v0, dtype=torch.float32))

    def port(self, pt):
        return pt.constant_winds(self.u0, self.v0)


def make(spec, seed, device):
    return Turned(spec["speed"], spec["deg"])
'''


def test_a_cell_with_a_new_forcing_kind_added_as_files_runs(tmp_path):
    """A copy of the benchmark in a temporary directory, with a new forcing
    kind, a mix of it, a cell, its limits and a metric added as files and
    entries; the new cell runs at the tests' size and is correct."""
    shutil.copytree(HERE, tmp_path / "wavebench")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "box1536.turned-day", "config":
                              "box1536", "traffic": "turned-day", "chips": 1,
                              "why": "a test cell"})
    spec["per_layer"].append({"name": "jobs.count", "unit": "jobs",
                              "better": "higher", "source": "host_clock",
                              "layer": "run loop", "moves": "pushes_per_s",
                              "workloads": ["box1536.turned-day"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    wb = tmp_path / "wavebench"
    mix = json.loads((HERE / "traffic" / "steady-day.json").read_text())
    mix["forcing"] = {"kind": "turned", "speed": 9.0, "deg": 30.0}
    (wb / "traffic" / "turned-day.json").write_text(json.dumps(mix))
    (wb / "forcing" / "turned.py").write_text(TURNED)
    shutil.copy(HERE / "limits" / "box1536.steady-day.json",
                wb / "limits" / "box1536.turned-day.json")
    (wb / "metrics" / "jobs.count.py").write_text(
        "def read(run):\n    return len(run.jobs)\n")
    b = Bench(tmp_path, wb)
    assert b.traffic(b.workload("box1536.turned-day")["traffic"])[
        "forcing"]["kind"] == "turned"
    got = [m["name"] for m in b.metrics_for("box1536.turned-day", True)]
    assert "jobs.count" in got
    assert b.metric("jobs.count").read(type("R", (), {"jobs": [1, 2]})) == 2
    out = run_cell(b, "box1536.turned-day", 2 ** 31 + 3, 0.3, False, "cpu",
                   time.perf_counter(), overrides=SMALL["box1536.steady-day"],
                   log=lambda m: None, warm_s=0.0)
    assert out["correct"], out["checks"]
    with pytest.raises(KeyError):
        b.workload("no.such-cell")
