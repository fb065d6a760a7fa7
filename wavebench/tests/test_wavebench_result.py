"""The shape of a run's last line, and the command's refusals."""

import json
import subprocess
import sys
import time

import pytest

from wavebench.harness import HERE, ROOT, Bench, run_cell

from cases import CELLS, SMALL


@pytest.mark.parametrize("name", CELLS)
def test_result_line(name):
    out = run_cell(Bench(), name, 2 ** 31 + 77, 0.5, False, "cpu",
                   time.perf_counter(), overrides=SMALL[name],
                   log=lambda m: None, warm_s=0.0)
    line = json.loads(json.dumps(out))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    units = {m["name"]: m["unit"] for m in Bench().spec["end_to_end"]}
    assert set(line["metrics"]) == {"pushes_per_s", "day_s_p90", "setup_s"}
    for k, v in line["metrics"].items():
        assert v["unit"] == units[k] and v["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(Bench().limits(name))
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_the_command_refuses_without_a_card():
    """No result and a non-zero code without enough CUDA devices (this
    machine has none)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        "box1536.steady-day", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_traced_run_on_the_card(cuda_device, name):
    """A traced run at the tests' size on the card: every per-layer metric
    of the cell read, ``correct`` true."""
    out = run_cell(Bench(), name, 2 ** 31 + 5, 1.0, True, cuda_device,
                   time.perf_counter(), overrides=SMALL[name],
                   log=lambda m: None, warm_s=0.0)
    assert out["correct"], out["checks"]
    want = {m["name"] for m in Bench().metrics_for(name, True)}
    assert set(out["metrics"]) == want
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["breakdown"]["device_ops"]
