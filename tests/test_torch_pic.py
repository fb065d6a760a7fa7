"""PyTorch port vs the JAX package: the CIC deposit (the plain version of
kernel K2) on the CPU.  Positions, charges and masks come from a numpy seed;
both packages get the same float32 arrays.  Tolerance: rtol 1e-5 with an
atol of 1e-6 of the field's scale, because the pad-and-fold sum, the
scatter-add oracle and the gather add the same terms in different orders;
the clamp count is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from picles_tpu.grids.base import Boundary as JB
from picles_tpu.grids.base import GridStats as JStats
from picles_tpu.ops import pic as jpic
from picles_tpu.ops.pic_pallas import scatter_core_channels_pallas

from picles_torch.grids.base import Boundary as TB
from picles_torch.grids.base import GridStats as TStats
from picles_torch.ops import pic as tpic
from picles_torch.ops.pic_cuda import pic_gather

torch.set_num_threads(1)


def _inputs(nx, ny, lo, hi, seed):
    rng = np.random.default_rng(seed)
    xr = rng.uniform(lo, hi, (nx, ny)).astype(np.float32)
    yr = rng.uniform(lo, hi, (nx, ny)).astype(np.float32)
    ch = rng.uniform(0.0, 1.0, (nx, ny, 3)).astype(np.float32)
    ch[..., 1:] -= 0.5
    act = rng.uniform(size=(nx, ny)) < 0.85
    return xr, yr, ch, act


def _stats(nx, ny, kind):
    b = {"periodic": ("PERIODIC", "PERIODIC"),
         "open": ("NONPERIODIC", "NONPERIODIC"),
         "mixed": ("PERIODIC", "NONPERIODIC"),
         "tripolar": ("PERIODIC", "TRIPOLAR_NORTH")}[kind]
    return (JStats(nx=nx, ny=ny, bx=JB[b[0]], by=JB[b[1]]),
            TStats(nx=nx, ny=ny, bx=TB[b[0]], by=TB[b[1]]))


def _close(actual, desired, what=""):
    desired = np.asarray(desired)
    np.testing.assert_allclose(actual, desired, rtol=1e-5,
                               atol=1e-6 * np.abs(desired).max(),
                               err_msg=what)


def _t(*arrs):
    return [torch.as_tensor(a) for a in arrs]


def test_halo_helpers_match():
    for h in (3, ((0, 3), (0, 3)), ((1, 2), (2, 1)), (2, 4)):
        assert tpic.normalize_halo(h) == jpic.normalize_halo(h)
    pos = np.linspace(-4.5, 4.5, 37).astype(np.float32)
    for lohi in ((3, 3), (0, 3), (1, 2)):
        j = jpic.cic_weights(jnp.asarray(pos), lohi)
        t = tpic.cic_weights(torch.as_tensor(pos), lohi)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", ["periodic", "open", "mixed", "tripolar"])
@pytest.mark.parametrize("halo,lo,hi", [(3, -3.4, 3.4),
                                        (((0, 3), (0, 3)), -0.3, 3.3),
                                        (((1, 2), (2, 1)), -2.3, 2.3)])
def test_scatter_dense_matches_jax(kind, halo, lo, hi):
    nx, ny = 12, 10
    xr, yr, ch, act = _inputs(nx, ny, lo, hi, seed=len(kind) + int(10 * hi))
    js, ts = _stats(nx, ny, kind)
    J, jst = jpic.scatter_dense(*(jnp.asarray(a) for a in (xr, yr, ch, act)),
                                js, halo)
    T, tst = tpic.scatter_dense(*_t(xr, yr, ch, act), ts, halo)
    _close(T.numpy(), J, kind)
    assert int(tst.clamped) == int(jst.clamped) > 0
    assert tst.clamped.dtype == torch.int32


@pytest.mark.parametrize("kind", ["periodic", "open", "tripolar"])
def test_scatter_xla_oracle_matches_jax_and_dense(kind):
    nx, ny = 9, 11
    xr, yr, ch, act = _inputs(nx, ny, -2.9, 2.9, seed=5)
    js, ts = _stats(nx, ny, kind)
    J, _ = jpic.scatter_xla(*(jnp.asarray(a) for a in (xr, yr, ch, act)), js)
    T, _ = tpic.scatter_xla(*_t(xr, yr, ch, act), ts)
    _close(T.numpy(), J, "oracle")
    D, st = tpic.scatter_dense(*_t(xr, yr, ch, act), ts, 3)
    assert int(st.clamped) == 0
    _close(D.numpy(), T.numpy(), "dense vs oracle")


@pytest.mark.parametrize("halo", [3, ((0, 3), (0, 3))])
def test_periodic_deposit_conserves_mass(halo):
    nx = ny = 16
    xr, yr, ch, act = _inputs(nx, ny, -4.0, 4.0, seed=7)
    _, ts = _stats(nx, ny, "periodic")
    S, st = tpic.scatter_dense(*_t(xr, yr, ch, act), ts, halo)
    assert int(st.clamped) > 0        # clamped particles still deposit
    src = (ch[..., 0].astype(np.float64) * act).sum()
    np.testing.assert_allclose(S[..., 0].double().sum().item(), src,
                               rtol=1e-5)


@pytest.mark.parametrize("kind,halo", [("periodic", ((0, 3), (0, 3))),
                                       ("periodic", 3),
                                       ("open", ((1, 2), (2, 1)))])
def test_dense_matches_pallas_gather_interpret(kind, halo):
    """The JAX one-pass gather kernel (K2) in interpret mode against the
    port's plain version, through the port's K2 wrapper on CPU tensors."""
    nx = ny = 16
    lo, hi = (-0.2, 3.2) if halo == ((0, 3), (0, 3)) else (-3.2, 3.2)
    xr, yr, ch, act = _inputs(nx, ny, lo, hi, seed=11)
    js, ts = _stats(nx, ny, kind)
    chans = tuple(ch[..., i] for i in range(3))
    (jo, jst) = scatter_core_channels_pallas(
        jnp.asarray(xr), jnp.asarray(yr),
        tuple(jnp.asarray(c) for c in chans), jnp.asarray(act), js, halo,
        interpret=True)
    (to, tst) = pic_gather(*_t(xr, yr), tuple(_t(*chans)),
                           torch.as_tensor(act), ts, halo)
    for c in range(3):
        _close(to[c].numpy(), jo[c], f"channel {c}")
    assert int(tst.clamped) == int(jst.clamped)


@pytest.mark.parametrize("mode", ["dense", "xla"])
def test_scatter_channels_modes(mode):
    nx = ny = 8
    xr, yr, ch, act = _inputs(nx, ny, -1.9, 1.9, seed=3)
    js, ts = _stats(nx, ny, "periodic")
    chans = tuple(ch[..., i] for i in range(3))
    jo, _ = jpic.scatter_channels(
        jnp.asarray(xr), jnp.asarray(yr),
        tuple(jnp.asarray(c) for c in chans), jnp.asarray(act), js, 2, mode)
    to, _ = tpic.scatter_channels(*_t(xr, yr), tuple(_t(*chans)),
                                  torch.as_tensor(act), ts, 2, mode)
    for c in range(3):
        _close(to[c].numpy(), jo[c], f"channel {c}")
    with pytest.raises(ValueError, match="unknown scatter mode"):
        tpic.scatter_channels(*_t(xr, yr), tuple(_t(*chans)),
                              torch.as_tensor(act), ts, 2, "pallas")
