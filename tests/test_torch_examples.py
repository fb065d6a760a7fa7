"""The port's examples (``picles_torch/examples/*.py``) on the CPU at their
shrunken (PICLES_SMOKE=1) configurations, against the JAX package's
examples and ``tests/test_examples.py``'s assertions.

Each example runs in-process with ``--device cpu`` and exposes its results
as module globals.  Examples 00-03 are held against the JAX examples'
globals, run the same way, as the 2D families are held
(``tests/test_torch_families_2d.py``): the propagation-only swell of
example 01 within 1e-5 of the state's largest value (measured 3.7e-7); the
forced examples run at their own default solver tolerances, where the
adaptive controller turns last-ulp differences of the two libraries into
other substep paths, within 1e-2 (measured 8.9e-4, 2.9e-3 and 7.4e-5 for
examples 00, 02 and 03).  Examples 04 and 05 start gloo ranks as processes
and hold the sharded run against the port's single-device run within rtol
2e-3 themselves; the test reads their globals.  A subprocess runs every
port example with ``jax`` made unimportable.
"""

import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "picles_torch", "examples")
JAX = os.path.join(REPO, "examples")
FORCED_GAP = 1e-2
SWELL_GAP = 1e-5


def _run(folder, name, argv=()):
    os.environ["PICLES_SMOKE"] = "1"
    os.environ.setdefault("MPLBACKEND", "Agg")
    saved = sys.argv
    sys.argv = [name, *argv]
    try:
        return runpy.run_path(os.path.join(folder, name),
                              run_name="example_smoke")
    finally:
        sys.argv = saved
        os.environ.pop("PICLES_SMOKE", None)


def _port(name, *argv):
    return _run(PORT, name, ("--device", "cpu", *argv))


def _gap(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_example_00_minimal():
    g = _port("example_00_minimal.py")
    states = g["states"]
    assert np.all(np.isfinite(states))
    assert states[-1, ..., 0].mean() > 0          # wave energy grew
    assert g["sim"].n_steps() == len(states) - 1
    j = _run(JAX, "example_00_minimal.py")
    assert _gap(states, j["states"]) <= FORCED_GAP
    assert int(g["sim"].state.metrics.n_failed) == 0


def test_example_01_sphere_swell():
    g = _port("example_01_sphere_swell.py")
    e_last = g["snaps"][-1][..., 0]
    assert np.all(np.isfinite(e_last))
    assert e_last.sum() > 0                       # blob still carries energy
    assert int(g["ms"].metrics.n_failed) == 0
    x = g["grid"].x.numpy()[:, 0]
    assert x[11] < g["com_lon"] < x[18]
    j = _run(JAX, "example_01_sphere_swell.py")
    assert _gap(np.stack(g["snaps"]), np.stack(j["snaps"])) <= SWELL_GAP
    assert g["times"] == j["times"]


def test_example_02_tripolar_global():
    g = _port("example_02_tripolar_global.py")
    e = g["e"]
    mask = g["grid"].mask.numpy()
    assert np.all(np.isfinite(e))
    assert e[mask == 1].max() > 0                 # forced ocean grew waves
    assert e[mask == 0].sum() == pytest.approx(0.0, abs=1e-10)  # land dry
    j = _run(JAX, "example_02_tripolar_global.py")
    assert _gap(g["states"], j["states"]) <= FORCED_GAP
    assert int(g["sim"].state.metrics.n_failed) == 0


def test_example_03_checkpoint_restart(tmp_path):
    out = tmp_path / "port"
    out.mkdir()
    g = _port("example_03_checkpoint_restart.py", str(out))
    assert np.array_equal(g["final_a"], g["final_b"])
    assert os.path.exists(os.path.join(str(out), "leg1.h5"))
    assert os.path.exists(os.path.join(str(out), "example_03.gif"))
    jout = tmp_path / "jax"
    jout.mkdir()
    j = _run(JAX, "example_03_checkpoint_restart.py", (str(jout),))
    assert _gap(g["final_a"], j["final_a"]) <= FORCED_GAP


def test_example_03_without_outdir_writes_nothing(tmp_path, monkeypatch):
    """Without an outdir the example keeps its checkpoint in a temporary
    directory and writes no store and no movie (the card machine has no
    h5py and no matplotlib)."""
    monkeypatch.chdir(tmp_path)
    g = _port("example_03_checkpoint_restart.py")
    assert np.array_equal(g["final_a"], g["final_b"])
    assert not os.path.exists(os.path.dirname(g["ckpt"]))
    assert os.listdir(tmp_path) == []


def test_example_04_sharded():
    g = _port("example_04_sharded.py")
    states = g["states"]
    assert np.all(np.isfinite(states))
    assert g["n_failed"] == 0
    assert g["N_RANKS"] == 4 and g["MESH"] == (2, 2)
    assert g["transport"] == "gloo, staged through host memory"
    assert g["rel"] < 2e-3
    assert states.shape == g["ref"].shape == (5, 32, 32, 3)


def test_example_05_multiprocess():
    g = _port("example_05_multiprocess.py")
    assert np.isfinite(g["field"]).all()
    assert g["n_active"] == 32 * 32
    assert g["field"][..., 0].mean() > 0
    rel = np.abs(g["field"] - g["ref"]).max() / np.abs(g["ref"]).max()
    assert rel < 2e-3


def test_port_examples_import_no_jax():
    """Every port example runs with ``jax`` unimportable (as on the card
    machine), and none imports ``picles_tpu``."""
    code = (
        "import os, runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "os.environ['PICLES_SMOKE'] = '1'\n"
        f"folder = {PORT!r}\n"
        "for name in ('example_00_minimal.py', 'example_01_sphere_swell.py',"
        " 'example_02_tripolar_global.py',"
        " 'example_03_checkpoint_restart.py'):\n"
        "    sys.argv = [name, '--device', 'cpu']\n"
        "    runpy.run_path(os.path.join(folder, name))\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'picles_tpu'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("ok")
    for name in os.listdir(PORT):
        if name.endswith(".py"):
            src = open(os.path.join(PORT, name)).read()
            assert "import jax" not in src and "picles_tpu" not in src, name
