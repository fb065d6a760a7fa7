"""The port's advance (K1) and auto-dt (K3) wrappers against the JAX
package's Pallas kernels in interpret mode, on the CPU at 8 x 16.

On CPU tensors the wrappers run the plain versions (``tsit5.integrate_to``
and ``tsit5.auto_dt``); the CUDA kernels themselves are checked against the
same plain versions on the card by ``chip_smoke.py``.  Tolerances: rtol
1e-5 in fixed-substep mode and for the Hairer estimate (same float32
operations; last-ulp differences of the transcendentals), rtol 5e-3 in
adaptive mode (the error controller may turn an ulp into a different
accept/reject sequence)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from picles_tpu.core import fetch_relations as jfr
from picles_tpu.core.constants import ODEParameters as JOP
from picles_tpu.forcing import winds as jw
from picles_tpu.ops import rhs as jrhs
from picles_tpu.ops import tsit5 as jts
from picles_tpu.ops.advance_pallas import advance_pallas, auto_dt_pallas

from picles_torch.core.constants import ODEParameters as TOP
from picles_torch.forcing import winds as tw
from picles_torch.ops import rhs as trhs
from picles_torch.ops import tsit5 as tts
from picles_torch.ops.advance_cuda import (advance_cuda, auto_dt_cuda,
                                           flag_bits, kernel_wind)

torch.set_num_threads(1)

DT = 600.0
NX, NY = 8, 16
PROJ = (1.0 / 2e3, 0.0, 0.0, 1.0 / 2e3, 0.0)


def _case(seed, wind):
    rng = np.random.default_rng(seed)
    ws = jfr.get_initial_windsea(np.full((NX, NY), 10.0),
                                 np.full((NX, NY), 10.0), DT)
    comps = [np.asarray(ws.lne) + rng.normal(0, 0.05, (NX, NY)),
             np.asarray(ws.cg_bar_x) * rng.uniform(0.95, 1.05, (NX, NY)),
             np.asarray(ws.cg_bar_y) * rng.uniform(0.95, 1.05, (NX, NY)),
             rng.uniform(-0.3, 0.3, (NX, NY)),
             rng.uniform(-0.3, 0.3, (NX, NY))]
    comps = [c.astype(np.float32) for c in comps]
    active = rng.uniform(size=(NX, NY)) < 0.9
    x, y = np.meshgrid(np.arange(NX) * 2e3, np.arange(NY) * 2e3,
                       indexing="ij")
    jp, jid, _ = JOP.create()
    tp, tid, _ = TOP.create()
    jc = jrhs.make_rhs_consts(gamma=jid.gamma, constants=jid, params=jp)
    tc = trhs.make_rhs_consts(gamma=tid.gamma, constants=tid, params=tp)
    if wind == "constant":
        jwd, twd = jw.constant_winds(10.0, 10.0), tw.constant_winds(10.0, 10.0)
    else:
        jwd = jw.time_cosine_winds(10.0, 5.0, 6 * 3600.0)
        twd = tw.time_cosine_winds(10.0, 5.0, 6 * 3600.0)
    return (comps, active, x.astype(np.float32), y.astype(np.float32),
            jc, tc, jwd, twd)


@pytest.mark.parametrize("method,adaptive", [("bosh3", False),
                                             ("tsit5", False),
                                             ("bosh3", True),
                                             ("tsit5", True)])
def test_advance_matches_pallas_interpret(method, adaptive):
    comps, active, x, y, jc, tc, jwd, twd = _case(0, "time_cosine")
    t0 = np.full((NX, NY), 1200.0, np.float32)
    dt = np.full((NX, NY), 37.5 if not adaptive else 1e-3, np.float32)
    jcfg = jts.SolverConfig(method=method, adaptive=adaptive)
    tcfg = tts.SolverConfig(method=method, adaptive=adaptive)
    j = advance_pallas(jwd.u, jwd.v, jc, jrhs.TermFlags(), jcfg, DT,
                       tuple(jnp.asarray(c) for c in comps), jnp.asarray(t0),
                       jnp.asarray(dt), jnp.asarray(active), jnp.asarray(x),
                       jnp.asarray(y), PROJ, jnp.zeros((NX, NY)),
                       interpret=True)
    p = advance_cuda(twd, tc, trhs.TermFlags(), tcfg, DT,
                     tuple(torch.as_tensor(c) for c in comps),
                     torch.as_tensor(t0), torch.as_tensor(dt),
                     torch.as_tensor(active), torch.as_tensor(x),
                     torch.as_tensor(y), PROJ)
    rtol, atol = (5e-3, 1e-4) if adaptive else (1e-5, 1e-6)
    for name in ("lne", "cgx", "cgy", "x", "y"):
        np.testing.assert_allclose(getattr(p, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=rtol,
                                   atol=atol, err_msg=name)
    np.testing.assert_array_equal(p.t.numpy(), np.asarray(j.t))
    np.testing.assert_array_equal(p.failed.numpy(), np.asarray(j.failed))
    assert p.naccept.dtype == torch.int32 and p.failed.dtype == torch.bool
    if not adaptive:
        np.testing.assert_array_equal(p.naccept.numpy(),
                                      np.asarray(j.naccept))
        np.testing.assert_array_equal(p.dt.numpy(), np.asarray(j.dt))
    # inactive lanes pass through untouched
    off = ~active
    np.testing.assert_array_equal(p.lne.numpy()[off], comps[0][off])
    assert int(p.naccept.numpy()[off].max()) == 0


@pytest.mark.parametrize("wind", ["constant", "time_cosine"])
def test_auto_dt_matches_pallas_interpret(wind):
    comps, _, x, y, jc, tc, jwd, twd = _case(1, wind)
    t = np.full((NX, NY), 1800.0, np.float32)
    j = auto_dt_pallas(jwd.u, jwd.v, jc, jrhs.TermFlags(), jnp.asarray(t),
                       tuple(jnp.asarray(c) for c in comps), jnp.asarray(x),
                       jnp.asarray(y), PROJ, jnp.zeros((NX, NY)), order=5.0,
                       interpret=True)
    p = auto_dt_cuda(twd, tc, trhs.TermFlags(), torch.as_tensor(t),
                     tuple(torch.as_tensor(c) for c in comps),
                     torch.as_tensor(x), torch.as_tensor(y), PROJ, order=5.0)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5)


def test_kernel_contract_helpers():
    assert flag_bits(trhs.TermFlags()) == 31
    assert flag_bits(trhs.TermFlags(input=False, direction=False)) == 1 + 4 + 8
    assert kernel_wind(tw.half_domain_winds(1.0, 2.0, 3.0)).x_split == 3.0
    plain = tw.Winds2D(u=lambda x, y, t: x * 0 + 1.0,
                       v=lambda x, y, t: x * 0 + 1.0)
    with pytest.raises(NotImplementedError, match="kernel descriptor"):
        kernel_wind(plain)
