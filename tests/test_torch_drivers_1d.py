"""The 1D model's step and drivers against the JAX package's, on the CPU,
with the wind given the way kernel K7 takes it on the card.

- The step with the wind as K7 reads it (a steady callable's node plane,
  ``forcing.winds.steady_node_plane_1d``, given back as a callable of the
  plane; a ``GriddedWinds1D`` record) against JAX's step with its own
  callable or record: the B01 grid, the periodic oracle configuration and a
  periodic record, at abstol 1e-7 / reltol 1e-6, within 1e-4 of the state's
  scale, ``on`` and the counters equal (``substeps_max`` within 2), as
  tests/test_torch_model_1d.py holds the step.
- The drivers (``step_jit`` twice, ``step_n``, ``step_n_buffered`` with a
  ragged chunk, ``step_n_quiet``), which loop on the CPU, against the JAX
  package's compiled 1D drivers on the B01 grid at the same tolerances and
  bound.

The graphed drivers against the eager K7 step run on the card
(tests/test_torch_cuda.py, marker ``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picles_tpu.forcing import winds as jwinds

import picles_torch as pt
from picles_torch import convert
from picles_torch.forcing.winds import steady_node_plane_1d
from test_torch_graphs_1d import _jsteady, _plane_winds, _record, _steady
from test_torch_model_1d import (COUNTERS, TIGHT, _compare_steps, _jmetrics,
                                 _jmodel, _model)

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["b01 node plane",
                                  "oracle periodic node plane", "record"])
def test_step_with_the_kernel_winds_matches_jax(case):
    """The step against JAX's with the wind as K7 takes it, 6 steps."""
    if case == "record":
        r = _record()
        kw = dict(nx=21, Lx=500e3, periodic=True, **TIGHT)
        jg = jwinds.GriddedWinds1D(
            u_data=jnp.asarray(r["u_data"]),
            **{k: v for k, v in r.items() if k != "u_data"})
        tg = convert.gridded1d_from_jax(jg, device="cpu")
        _compare_steps(_model(winds=tg, **kw), _jmodel(winds=jg, **kw), 6)
        return
    if case.startswith("b01"):
        kw = dict(**TIGHT)
        tw, jw = pt.Winds1D(u=_steady), jwinds.Winds1D(u=_jsteady)
    else:
        kw = dict(nx=8, Lx=200e3, periodic=True, **TIGHT)
        tw, jw = pt.constant_winds_1d(10.0), jwinds.constant_winds_1d(10.0)
    grid = pt.one_d_grid(0.0, kw.get("Lx", 500e3), kw.get("nx", 31),
                         periodic=kw.get("periodic", False), device="cpu")
    plane = steady_node_plane_1d(tw, grid.x)
    _compare_steps(_model(winds=_plane_winds(plane), **kw),
                   _jmodel(winds=jw, **kw), 6)



def test_1d_drivers_match_jax_jitted_drivers():
    """step_jit twice, step_n, step_n_buffered (a ragged chunk of 2 in 4
    rows) and step_n_quiet on the B01 grid against JAX's drivers."""
    tm, jm = _model(**TIGHT), _jmodel(**TIGHT)
    tms, jms = tm.init_state(), jm.init_state()

    def close(t, j, what):
        a, b = t.numpy(), np.asarray(j)
        assert a.shape == b.shape, what
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), what

    def counters(t, j, what):
        tc, jc = t.metrics.as_dict(), _jmetrics(j)
        for c in COUNTERS:
            assert tc[c] == jc[c], (what, c)
        assert abs(tc["substeps_max"] - jc["substeps_max"]) <= 2, what

    jf, tf = jm.step_jit(), tm.step_jit()
    j1, t1 = jf(jms), tf(tms)
    kept = t1.clone()
    j2, t2 = jf(j1), tf(t1)
    close(t2.state, j2.state, "step_jit twice")
    counters(t2, j2, "step_jit")
    for a, b in zip(t1.leaves(), kept.leaves()):
        assert torch.equal(a, b)

    jfin, jstack = jm.step_n(jms, 3)
    tfin, tstack = tm.step_n(tms, 3)
    assert tuple(tstack.shape) == tuple(jstack.shape) == (3, 31, 3)
    close(tstack, jstack, "step_n stack")
    close(tfin.state, jfin.state, "step_n final")
    counters(tfin, jfin, "step_n")

    jfin, jbuf = jm.step_n_buffered(jms, 2, 4)
    tfin, tbuf = tm.step_n_buffered(tms, 2, 4)
    close(tbuf, jbuf, "step_n_buffered buffer")
    assert not tbuf[2:].any()
    assert int(tfin.iteration) == int(jfin.iteration) == 2

    jq, tq = jm.step_n_quiet(jms, 3), tm.step_n_quiet(tms, 3)
    close(tq.state, jq.state, "step_n_quiet")
    close(tq.particles.z, jq.particles.z, "z")
    np.testing.assert_array_equal(tq.particles.on.numpy(),
                                  np.asarray(jq.particles.on))
    counters(tq, jq, "step_n_quiet")
