"""The port's orbax checkpoint backend (``picles_torch/simulation/
checkpoint.py``, written and read through tensorstore) against the JAX
package's (orbax-checkpoint's ``PyTreeCheckpointer``), on the CPU: a
directory either package writes, the other reads, bit for bit, for 2D, 1D
and layered states; the port's own round trip resumes to the same step
(tests/test_utils_and_checkpoint.py:146).  Exact throughout: a checkpoint
moves bits.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from picles_tpu.core import fetch_relations as jfr
from picles_tpu.core.constants import ODESettings as JSettings
from picles_tpu.forcing import winds as jw
from picles_tpu.grids.cartesian import cartesian_box as j_box
from picles_tpu.models.wave_growth_1d import WaveGrowth1D as JModel1D
from picles_tpu.models.wave_growth_1d import one_d_grid as j_grid1d
from picles_tpu.models.wave_growth_2d import WaveGrowth2D as JModel
from picles_tpu.models.wave_growth_2d import WaveGrowth2DConfig as JConfig
from picles_tpu.simulation import checkpoint as jck

import picles_torch as pt
from picles_torch.simulation import checkpoint as tck
from test_torch_model_2d import port_of

torch.set_num_threads(1)

DT = 600.0


def _sett():
    ws = jfr.MinimalWindsea(10.0, 10.0, DT)
    return JSettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                     timestep=DT, total_time=6 * 3600.0, dt=1e-3, dtmin=1e-4,
                     force_dtmin=True)


def _jax_state(kind):
    """A JAX state of ``kind`` two steps in (counters non-zero)."""
    if kind == "1d":
        m = JModel1D(j_grid1d(0.0, 200e3, 11), jw.constant_winds_1d(9.0),
                     _sett())
        ms = m.init_state()
        return m.step(m.step(ms))
    layers = 3 if kind == "layered" else 1
    m = JModel(j_box(60e3, 7, 60e3, 7, periodic_boundary=(True, True)),
               jw.constant_winds(10.0, -4.0), _sett(),
               config=JConfig(periodic_boundary=True, layers=layers))
    if layers > 1:
        step = jax.jit(m.step_layers)
        return step(step(m.init_state_layers()))
    step = jax.jit(m.step)
    return step(step(m.init_state()))


def _assert_same(port_state, jax_state):
    want = jax.tree.leaves(jax_state)
    got = port_state.leaves()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kind", ["2d", "1d", "layered"])
def test_orbax_written_by_jax_reads_in_the_port(kind, tmp_path):
    jms = _jax_state(kind)
    path = jck.save_checkpoint(str(tmp_path / "jax_orbax"), jms,
                               backend="orbax")
    back = tck.load_checkpoint(path, device="cpu")
    assert type(back).__name__ == type(jms).__name__
    _assert_same(back, jms)


@pytest.mark.parametrize("kind", ["2d", "1d", "layered"])
def test_orbax_written_by_the_port_reads_in_jax(kind, tmp_path):
    """The port writes orbax's layout (``_METADATA``,
    ``_CHECKPOINT_METADATA``, the OCDBT store with its ``manifest.ocdbt``
    and ``d/``) and the JAX package's ``picles_meta.json``; orbax restores
    it, and so does the port."""
    jms = _jax_state(kind)
    tms = tck.load_checkpoint(
        jck.save_checkpoint(str(tmp_path / "src"), jms), device="cpu")
    path = tck.save_checkpoint(str(tmp_path / "port_orbax"), tms,
                               backend="orbax")
    assert sorted(os.listdir(path)) == ["_CHECKPOINT_METADATA", "_METADATA",
                                        "d", "manifest.ocdbt",
                                        "picles_meta.json"]
    with open(os.path.join(path, "picles_meta.json")) as f:
        assert json.load(f) == {"version": 2, "kind": type(jms).__name__,
                                "backend": "orbax"}
    _assert_same(tms, jck.load_checkpoint(path))
    again = tck.load_checkpoint(path, device="cpu")
    for a, b in zip(again.leaves(), tms.leaves()):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_orbax_metadata_matches_jax(tmp_path):
    """The port's ``_METADATA`` is orbax's for the same state, key for
    key."""
    jms = _jax_state("2d")
    jpath = jck.save_checkpoint(str(tmp_path / "j"), jms, backend="orbax")
    tms = tck.load_checkpoint(jpath, device="cpu")
    tpath = tck.save_checkpoint(str(tmp_path / "t"), tms, backend="orbax")
    with open(os.path.join(jpath, "_METADATA")) as f:
        jmeta = json.load(f)
    with open(os.path.join(tpath, "_METADATA")) as f:
        tmeta = json.load(f)
    assert tmeta == jmeta
    with open(os.path.join(tpath, "_CHECKPOINT_METADATA")) as f:
        cm = json.load(f)
    assert cm["item_handlers"].endswith("PyTreeCheckpointHandler")


def test_orbax_roundtrip_resumes(tmp_path):
    """tests/test_utils_and_checkpoint.py::test_orbax_checkpoint_roundtrip
    on the port: bit for bit back, and the next step the same; a second
    save over the same path replaces it."""
    jm = JModel(j_box(60e3, 7, 60e3, 7, periodic_boundary=(True, True)),
                jw.constant_winds(10.0, 10.0), _sett(),
                config=JConfig(periodic_boundary=True))
    m = port_of(jm, pt.constant_winds(10.0, 10.0))
    ms = m.step(m.step(m.init_state()))
    p = str(tmp_path / "ck_orbax")
    tck.save_checkpoint(p, m.init_state(), backend="orbax")
    assert tck.save_checkpoint(p, ms, backend="orbax") == p
    back = pt.load_checkpoint(p, device="cpu")
    for a, b in zip(ms.leaves(), back.leaves()):
        assert torch.equal(a, b)
    assert torch.equal(m.step(ms).state, m.step(back).state)


def test_orbax_without_tensorstore_raises(tmp_path, monkeypatch):
    """Without tensorstore the backend raises ImportError naming it, in
    both directions, and writes nothing (no npz in its place)."""
    jms = _jax_state("2d")
    jpath = jck.save_checkpoint(str(tmp_path / "j"), jms, backend="orbax")
    tms = tck.load_checkpoint(jpath, device="cpu")
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        tck.save_checkpoint(str(tmp_path / "o"), tms, backend="orbax")
    assert not os.path.exists(tmp_path / "o") and \
        not os.path.exists(tmp_path / "o.npz")
    with pytest.raises(ImportError, match="tensorstore"):
        tck.load_checkpoint(jpath, device="cpu")
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        tck.save_checkpoint(str(tmp_path / "x"), tms, backend="zarr")
