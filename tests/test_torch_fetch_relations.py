"""The port's fetch relations (``picles_torch/core/fetch_relations.py``)
against the JAX package's, on the CPU, from the same numpy-seeded float32
inputs: the windsea seeds of both types (JONSWAP and Pierson-Moskowitz,
``type=``) through every function that takes one, and the rest of the
family (non-dimensionalizations, the Dulov law, the static fetch laws, the
PM parameters, the JONSWAP helpers and spectra).

Tolerance: rtol 1e-6 (atol 1e-30 for values that underflow alike), both
packages computing in float32; the two libraries' pow, exp and log differ
in the last ulp, and no function chains more than a few of them.  The
spectra are the exception: their exp(-x) multiplies a relative error of x
by x (up to x = 101 on the low-frequency side of the seeded range, 1.5e-5
measured), so they are held at rtol 1e-6 (1 + x), x their exponent's
magnitude at each frequency.  The JAX package's own golden tests
(``tests/test_fetch_relations.py``) run on the port too, with their
tolerances.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picles_tpu.core import fetch_relations as jfr

from picles_torch.core import fetch_relations as tfr

torch.set_num_threads(1)

RTOL = 1e-6
ATOL = 1e-30
WINDSEA_FNS = ("get_initial_windsea", "MinimalWindsea", "MinimalParticle",
               "MinimalState", "get_initial_windsea_particle_state",
               "get_initial_windsea_1d", "MinimalWindsea_1d")


def _winds(seed, n=64):
    """Wind components over calm, moderate and strong winds, with exact
    zeros (the minimal windsea's sign rule) and both signs."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-25.0, 25.0, n).astype(np.float32)
    v = rng.uniform(-25.0, 25.0, n).astype(np.float32)
    u[:4] = [0.0, 0.05, -0.02, 0.0]
    v[:4] = [0.0, 0.0, 0.03, -7.0]
    return u, v


def _check(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _check(got[k], want[k], f"{what}.{k}")
        return
    if hasattr(want, "_fields"):
        assert type(got).__name__ == type(want).__name__, what
        for k in want._fields:
            _check(getattr(got, k), getattr(want, k), f"{what}.{k}")
        return
    w = np.asarray(want)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=what)


# ---------------------------------------------------------------------------
# the windsea seeds and their type
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["JONSWAP", "PM"])
@pytest.mark.parametrize("fn", WINDSEA_FNS)
def test_windsea_type_matches_jax(fn, kind):
    """Every seed function takes the windsea ``type`` as the JAX package's
    does (a keyword the port lacked: ``type="PM"`` raised TypeError) and
    gives its values, on arrays and with a seconds scalar of either
    sign."""
    u, v = _winds(11)
    for ts in (600.0, -300.0):
        if fn.endswith("_1d"):
            args_j, args_t = (jnp.asarray(u), ts), (torch.from_numpy(u), ts)
        else:
            args_j = (jnp.asarray(u), jnp.asarray(v), ts)
            args_t = (torch.from_numpy(u), torch.from_numpy(v), ts)
        want = getattr(jfr, fn)(*args_j, type=kind)
        got = getattr(tfr, fn)(*args_t, type=kind)
        _check(got, want, f"{fn}({kind}, {ts})")


@pytest.mark.parametrize("fn", WINDSEA_FNS)
def test_windsea_default_type_is_jonswap(fn):
    """Without ``type`` the seeds are JONSWAP's, as before the argument."""
    args = (10.0, 600.0) if fn.endswith("_1d") else (10.0, 4.0, 600.0)
    a = getattr(tfr, fn)(*args)
    b = getattr(tfr, fn)(*args, type="JONSWAP")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_windsea_unknown_type_raises():
    with pytest.raises(ValueError, match="unknown windsea type 'Bretschneider'"):
        tfr.get_initial_windsea(10.0, 0.0, 600.0, type="Bretschneider")
    with pytest.raises(ValueError, match="unknown windsea type"):
        tfr.MinimalParticle(1.0, 1.0, 600.0, type="jonswap")


def test_windsea_pm_type():
    """``tests/test_fetch_relations.py::test_windsea_pm_type`` on the
    port."""
    got = tfr.get_initial_windsea(10.0, 0.0, 600.0, type="PM")
    fpeak = 0.816 * 9.81 / (2 * math.pi * 10.0)
    hs = 0.0246 * 100.0
    assert np.isclose(float(got.f_peak), fpeak, rtol=1e-5)
    assert np.isclose(float(got.Hs), hs, rtol=1e-5)
    assert np.isclose(float(got.E), (hs / 4) ** 2, rtol=1e-5)
    want = jfr.get_initial_windsea(10.0, 0.0, 600.0, type="PM")
    _check(got, want, "PM seed of a 10 m/s wind")


# ---------------------------------------------------------------------------
# the rest of the family
# ---------------------------------------------------------------------------

def _u10(rng, n=256):
    return rng.uniform(1.0, 30.0, n).astype(np.float32)


def _family_args(name, rng):
    """Seeded float32 arguments of each function, over its physical
    range."""
    U = _u10(rng)
    n = U.size
    Xt = np.exp(rng.uniform(np.log(10.0), np.log(1e6), n)).astype(np.float32)
    X = np.exp(rng.uniform(np.log(1e2), np.log(1e6), n)).astype(np.float32)
    tau = rng.uniform(600.0, 2 * 86400.0, n).astype(np.float32)
    f = rng.uniform(0.04, 0.6, n).astype(np.float32)
    return {
        "X_tilde": (X, U), "t_tilde": (tau, U),
        "E_tilde": (rng.uniform(1e-3, 20.0, n).astype(np.float32), U),
        "f_p_tilde": (f, U), "X_tilde_from_tau": (tau * 9.81 / U,),
        "tau_from_X_tilde": (Xt,), "min_fetch": (Xt,),
        "c_p_fetch": (Xt, U), "H_s_fetch": (Xt, U), "E_fetch": (Xt, U),
        "E_fetch_tilde": (Xt,), "X_tilde_time_and_fetch": (tau, U, X),
        "f_m_from_X_tilde": (U, Xt), "alpha_j": (U, f),
        "E_JONSWAP": (f, rng.uniform(1e-3, 3e-2, n).astype(np.float32)),
        "f_m_from_X": (U, X), "X_tilde_j_U_freq": (U, f),
        "X_j_U_freq": (U, f), "X_tilde_j_U_tau": (U, tau), "tau_j": (U, X),
        "f_m_given_U_tau": (U, tau), "c_g_U_tau": (U, tau), "E_j": (U, tau),
        "JONSWAP_omega": (U, 2 * np.pi * 0.12, 2 * np.pi * f),
        "JONSWAP_frequency": (U, 0.12, f),
        "PMSpectrum": (U, f), "PMParameters": (U,),
    }[name]


FAMILY = ("X_tilde", "t_tilde", "E_tilde", "f_p_tilde", "X_tilde_from_tau",
          "tau_from_X_tilde", "min_fetch", "c_p_fetch", "H_s_fetch",
          "E_fetch", "E_fetch_tilde", "X_tilde_time_and_fetch",
          "f_m_from_X_tilde", "alpha_j", "E_JONSWAP", "f_m_from_X",
          "X_tilde_j_U_freq", "X_j_U_freq", "X_tilde_j_U_tau", "tau_j",
          "f_m_given_U_tau", "c_g_U_tau", "E_j", "JONSWAP_omega",
          "JONSWAP_frequency", "PMSpectrum", "PMParameters")


def _spectral_exponent(name, args):
    """|x| of the spectrum's exp(-x) at each frequency."""
    U = args[0].astype(np.float64)
    if name == "PMSpectrum":
        wp = 0.879 * 9.81 / U
        return 1.25 * (wp / (2 * np.pi * args[1].astype(np.float64))) ** 4
    wp, w = args[1], args[2].astype(np.float64)
    if name == "JONSWAP_frequency":
        wp, w = 2 * np.pi * wp, 2 * np.pi * w
    return 1.25 * (wp / w) ** 4


@pytest.mark.parametrize("name", FAMILY)
def test_family_matches_jax(name):
    """Each function on the same seeded float32 arrays in both packages,
    at rtol 1e-6 (the spectra at rtol 1e-6 (1 + x), see above)."""
    args = _family_args(name, np.random.default_rng(FAMILY.index(name)))
    want = getattr(jfr, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                else a for a in args))
    got = getattr(tfr, name)(*(torch.from_numpy(a)
                               if isinstance(a, np.ndarray) else a
                               for a in args))
    if name not in ("JONSWAP_omega", "JONSWAP_frequency", "PMSpectrum"):
        _check(got, want, name)
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    x = _spectral_exponent(name, args)
    assert x.max() > 10.0    # the range reaches the ill-conditioned side
    bad = np.abs(g - w) > RTOL * (1.0 + x) * np.abs(w) + ATOL
    assert not bad.any(), (name, g[bad], w[bad], x[bad])


def test_constants_and_limits_match_jax():
    assert tfr.FETCH_GROWTH_PARAMETER == jfr.FETCH_GROWTH_PARAMETER == 3.5
    assert tfr.PMlimits() == jfr.PMlimits()
    for k in ("DULOV_Q_X", "DULOV_A", "DULOV_XI_0X", "U_MIN"):
        assert getattr(tfr, k) == getattr(jfr, k)


def test_pm_parameters_use_the_pm_variance():
    """The PM energy is (Hs/4)^2, the JAX package's fix of the Julia
    source's (Hs/4)^4, and equals the PM seed's energy of the same wind."""
    U = torch.tensor([5.0, 10.0, 20.0])
    p = tfr.PMParameters(U)
    torch.testing.assert_close(p["E"], (p["Hs"] / 4.0) ** 2, rtol=0, atol=0)
    seed = tfr.get_initial_windsea(U, torch.zeros_like(U), 600.0, type="PM")
    torch.testing.assert_close(p["E"], seed.E, rtol=1e-6, atol=0)
    torch.testing.assert_close(p["f_peak"], seed.f_peak, rtol=1e-6, atol=0)


def test_family_keeps_the_device_and_float32():
    """Tensor inputs keep their device and dtype (float32 in, float32
    out), as the model's reseeds need on the card."""
    U = torch.full((3, 4), 12.0)
    for name in ("c_p_fetch", "H_s_fetch", "E_fetch"):
        out = getattr(tfr, name)(torch.full((3, 4), 1e3), U)
        assert out.dtype == torch.float32 and out.shape == (3, 4)
    S = tfr.PMSpectrum(U, torch.full((3, 4), 0.1))
    assert S.dtype == torch.float32 and S.device == U.device


# ---------------------------------------------------------------------------
# the JAX package's golden tests, on the port
# ---------------------------------------------------------------------------

def test_dulov_roundtrip():
    tau = tfr.tau_from_X_tilde(torch.tensor(1e3))
    assert np.isclose(float(tfr.X_tilde_from_tau(tau)), 1e3, rtol=1e-5)


def test_double_limited_fetch():
    v = float(tfr.X_tilde_time_and_fetch(3 * 3600.0, 10.0, 5e3))
    assert v <= float(tfr.X_tilde(5e3, 10.0))
    assert v == float(jfr.X_tilde_time_and_fetch(3 * 3600.0, 10.0, 5e3))


def test_legacy_fetch_and_duration_roundtrips():
    u10, xt = 12.0, torch.tensor(3e3)
    fm = tfr.f_m_from_X_tilde(u10, xt)
    xt_back = float(tfr.X_tilde_j_U_freq(u10, fm))
    assert np.isclose(xt_back, 3e3, rtol=0.05)
    assert np.isclose(float(tfr.X_j_U_freq(u10, fm)),
                      xt_back * u10 ** 2 / 9.81, rtol=1e-6)
    tau = torch.tensor(6 * 3600.0)
    X = tfr.X_tilde_j_U_tau(10.0, tau) * 10.0 ** 2 / 9.81
    assert np.isclose(float(tfr.tau_j(10.0, X)), 6 * 3600.0, rtol=1e-6)


def test_legacy_f_m_given_U_tau_and_E_j():
    u10, tau = 10.0, 6 * 3600.0
    xt = (9.81 * tau / (14 * math.pi * u10)) ** 1.5
    expected = 3.5 * (9.81 / u10) * xt ** (-1.0 / 3.0) * 1.035
    t = torch.tensor(tau)
    assert np.isclose(float(tfr.f_m_given_U_tau(u10, t)), expected, rtol=1e-6)
    assert np.isclose(float(tfr.c_g_U_tau(u10, t)),
                      9.81 / (4 * math.pi * expected), rtol=1e-6)
    fm = float(tfr.f_m_given_U_tau(u10, t))
    aj = 0.033 * (fm * u10 / 9.81) ** 0.67
    assert np.isclose(float(tfr.E_j(u10, t)),
                      0.31 * 9.81 ** 2 * aj * (fm * 2 * math.pi) ** (-4),
                      rtol=1e-6)


def test_spectra_shapes():
    fp = 0.12
    f = np.linspace(0.5 * fp, 4 * fp, 400)
    S = tfr.JONSWAP_frequency(10.0, fp, f).numpy()
    assert np.all(S >= 0) and np.all(np.isfinite(S))
    assert abs(f[np.argmax(S)] - fp) / fp < 0.1
    assert S[-1] < 0.05 * S.max()
    f = np.linspace(0.02, 1.0, 2000)
    S = tfr.PMSpectrum(10.0, f).numpy()
    assert np.all(np.isfinite(S)) and np.all(S >= 0)
    wp = 0.879 * 9.81 / 10.0 / (2 * math.pi)
    assert abs(f[np.argmax(S)] - wp) / wp < 0.15
