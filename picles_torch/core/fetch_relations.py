"""Fetch relations and windsea initialization (PyTorch port).

Counterpart of ``picles_tpu/core/fetch_relations.py``: the
non-dimensionalizations, the Dulov time/fetch law, the static fetch laws,
the windsea seeds (JONSWAP or Pierson-Moskowitz), and the JONSWAP and PM
helpers with the JAX package's documented fixes of the Julia source.
Everything is elementwise, in the dtype the JAX package computes it in
(``jnp.result_type(float)``): float32, as with x64 off, unless a tensor
input is float64 or the caller passes ``dtype=torch.float64``, as a float64
JAX model runs with x64 on.  Python numbers and arrays are cast to that
dtype first, and the constants enter as Python scalars, which PyTorch
rounds to it.  A tensor input keeps its device, so the model's reseeds
stay on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .constants import G_GRAVITY

# Dulov et al. 2020 time->fetch constants
DULOV_Q_X = 0.2748
DULOV_A = 22.8013
DULOV_XI_0X = 2.4097

U_MIN = 1.0


def _dtype(dtype, *xs) -> torch.dtype:
    """``dtype`` where given, else float64 where a tensor input is float64,
    else float32."""
    if dtype is not None:
        return dtype
    wide = any(isinstance(x, torch.Tensor) and x.dtype == torch.float64
               for x in xs)
    return torch.float64 if wide else torch.float32


def _real(x, dtype, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    if isinstance(x, (int, float)):
        # a fill, not a copy from the host (which a CUDA graph cannot hold)
        return torch.full((), float(x), dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


def _f32(x, device=None) -> torch.Tensor:
    return _real(x, torch.float32, device)


# ---------------------------------------------------------------------------
# non-dimensionalizations
# ---------------------------------------------------------------------------

def X_tilde(X, U10):
    """Dimensionless fetch distance: g X / U10^2."""
    return G_GRAVITY * X / U10 ** 2


def t_tilde(t, U10):
    """Dimensionless time: g t / U10."""
    return t * G_GRAVITY / U10


def E_tilde(E, U10):
    """Dimensionless energy: g^2 E / U10^4."""
    return E * G_GRAVITY ** 2 / U10 ** 4


def f_p_tilde(f_p, U10):
    """Dimensionless peak frequency: f_p U10 / g."""
    return f_p * U10 / G_GRAVITY


# ---------------------------------------------------------------------------
# Dulov time <-> fetch
# ---------------------------------------------------------------------------

def X_tilde_from_tau(tau):
    """Non-dimensional fetch from non-dimensional duration tau."""
    return (tau / (DULOV_A * DULOV_XI_0X)) ** (1.0 / (1.0 - DULOV_Q_X))


def tau_from_X_tilde(X):
    """Non-dimensional duration tau from non-dimensional fetch."""
    return DULOV_A * DULOV_XI_0X * X ** (1.0 - DULOV_Q_X)


# ---------------------------------------------------------------------------
# JONSWAP pieces
# ---------------------------------------------------------------------------

def f_m_from_X_tilde(U10, X_tilde_, fgp: float = 3.5):
    """JONSWAP peak-frequency scale given U10 and non-dim fetch."""
    return fgp * (G_GRAVITY / U10) * X_tilde_ ** (-0.33)


def alpha_j(U10, f_m):
    """JONSWAP spectral-peak enhancement factor 0.033 (f_m U / g)^0.67."""
    return 0.033 * (f_m * U10 / G_GRAVITY) ** 0.67


def E_JONSWAP(f_m, alpha_j_):
    """JONSWAP wave energy 0.31 g^2 alpha_j (2 pi f_m)^-4."""
    return 0.31 * G_GRAVITY ** 2 * alpha_j_ * (f_m * 2.0 * math.pi) ** (-4.0)


# ---------------------------------------------------------------------------
# static fetch laws
# ---------------------------------------------------------------------------

def min_fetch(X_tilde_, X_t_0: float = 2.2e4, *, dtype=None):
    return torch.clamp(_real(X_tilde_, _dtype(dtype, X_tilde_)) / X_t_0,
                       max=1.0)


def c_p_fetch(X_tilde_, U10, X_t_0: float = 2.2e4):
    return U10 * 1.2 * min_fetch(X_tilde_, X_t_0) ** 0.33


def H_s_fetch(X_tilde_, U10, X_t_0: float = 2.2e4):
    return 0.26 * U10 ** 2 * min_fetch(X_tilde_, X_t_0) ** 0.5 / G_GRAVITY


def E_fetch(X_tilde_, U10, X_t_0: float = 2.2e4):
    return 4.23e-3 * U10 ** 4 * min_fetch(X_tilde_, X_t_0) / G_GRAVITY ** 2


def E_fetch_tilde(X_tilde_, X_t_0: float = 2.2e4):
    return 4.23e-3 * min_fetch(X_tilde_, X_t_0)


def X_tilde_time_and_fetch(t, U10, X, *, dtype=None):
    """Duration- or fetch-limited non-dimensional fetch (Python numbers in,
a tensor of ``dtype``, float32 by default, out)."""
    dtype = _dtype(dtype, t, U10, X)
    Tt = _real(t_tilde(t, U10), dtype)
    Xt = _real(X_tilde(X, U10), dtype, Tt.device)
    return torch.where(Tt < 1e5, torch.minimum(Xt, X_tilde_from_tau(Tt)), Xt)


# ---------------------------------------------------------------------------
# windsea initialization
# ---------------------------------------------------------------------------

class WindSea(NamedTuple):
    E: torch.Tensor
    lne: torch.Tensor
    Hs: torch.Tensor
    cg_bar_x: torch.Tensor
    cg_bar_y: torch.Tensor
    cg_bar: torch.Tensor
    f_peak: torch.Tensor
    T_bar: torch.Tensor
    X_tilde: torch.Tensor
    m_x: torch.Tensor
    m_y: torch.Tensor


def get_initial_windsea(U10, V10, time_scale, type: str = "JONSWAP", *,
                        dtype=None) -> WindSea:
    """Initial windsea from wind components and a duration scale; the wind
    speed is floored at 0.1 m/s.  ``type`` selects the JONSWAP or the
    Pierson-Moskowitz ("PM") seed.  ``dtype``: as the module says."""
    dtype = _dtype(dtype, U10, V10, time_scale)
    U10 = _real(U10, dtype)
    V10 = _real(V10, dtype, U10.device)
    U_amp = torch.sqrt(U10 * U10 + V10 * V10)
    U_amp = torch.where(U_amp < 0.1, 0.1, U_amp)

    time_scale = torch.abs(_real(time_scale, dtype, U10.device))
    tau = G_GRAVITY * time_scale / U_amp

    X_tilde_ = X_tilde_from_tau(tau)
    f_m_ = f_m_from_X_tilde(U_amp, X_tilde_)
    alpha_j_ = alpha_j(U_amp, f_m_)

    if type == "JONSWAP":
        E_ = E_JONSWAP(f_m_, alpha_j_)
        Hs_ = 4.0 * torch.sqrt(E_)
        f_peak = f_m_ * G_GRAVITY / U_amp
    elif type == "PM":
        f_peak = 0.816 * G_GRAVITY / (2.0 * math.pi * U_amp)
        Hs_ = 0.0246 * U_amp ** 2
        E_ = (Hs_ / 4.0) ** 2
    else:
        raise ValueError(f"unknown windsea type {type!r}")

    T_bar = 0.9 * (1.0 / f_peak)
    cg_bar_amp = G_GRAVITY * T_bar / (4.0 * math.pi)
    cg_bar_x = cg_bar_amp * U10 / U_amp
    cg_bar_y = cg_bar_amp * V10 / U_amp

    mom_x = (U10 / U_amp) * E_ / (2.0 * cg_bar_amp)
    mom_y = (V10 / U_amp) * E_ / (2.0 * cg_bar_amp)

    return WindSea(E=E_, lne=torch.log(E_), Hs=Hs_, cg_bar_x=cg_bar_x,
                   cg_bar_y=cg_bar_y, cg_bar=cg_bar_amp, f_peak=f_peak,
                   T_bar=T_bar, X_tilde=X_tilde_, m_x=mom_x, m_y=mom_y)


def get_initial_windsea_particle_state(U10, V10, time_scale,
                                       type: str = "JONSWAP", *, dtype=None):
    """[lne, cg_x, cg_y, 0, 0] of the initial windsea, stacked along a
    trailing axis."""
    ws = get_initial_windsea(U10, V10, time_scale, type, dtype=dtype)
    zero = torch.zeros_like(ws.lne)
    return torch.stack([ws.lne, ws.cg_bar_x, ws.cg_bar_y, zero, zero], dim=-1)


def _nonzero_sign(x):
    """sign(x) but +1 at x == 0 (the JAX package's deterministic stand-in
    for the Julia source's random sign), in x's dtype."""
    return torch.where(x < 0, -1.0, 1.0).to(x.dtype)


def MinimalWindsea(U10, V10, time_scale, type: str = "JONSWAP", *,
                   dtype=None) -> WindSea:
    """Windsea of a |U| = 1 m/s wind in the direction of (U10, V10)."""
    dtype = _dtype(dtype, U10, V10, time_scale)
    U10 = _real(U10, dtype)
    V10 = _real(V10, dtype, U10.device)
    U10 = torch.where(U10 == 0, _nonzero_sign(U10), U10)
    V10 = torch.where(V10 == 0, _nonzero_sign(V10), V10)
    Uamp = torch.sqrt(U10 * U10 + V10 * V10)
    return get_initial_windsea(U_MIN * U10 / Uamp, U_MIN * V10 / Uamp,
                               time_scale, type, dtype=dtype)


def MinimalParticle(U10, V10, time_scale, type: str = "JONSWAP", *,
                    dtype=None):
    """[lne, cg_x, cg_y, 0, 0] of the minimal windsea."""
    ws = MinimalWindsea(U10, V10, time_scale, type, dtype=dtype)
    zero = torch.zeros_like(ws.lne)
    return torch.stack([ws.lne, ws.cg_bar_x, ws.cg_bar_y, zero, zero], dim=-1)


def MinimalState(U10, V10, time_scale, type: str = "JONSWAP", *,
                 dtype=None):
    """[minimal energy, minimal momentum^2] of the minimal windsea."""
    ws = MinimalWindsea(U10, V10, time_scale, type, dtype=dtype)
    return torch.stack([ws.E, ws.m_x * ws.m_x + ws.m_y * ws.m_y], dim=-1)


def get_initial_windsea_1d(U10, time_scale, type: str = "JONSWAP", *,
                           dtype=None) -> WindSea:
    """The 1D windsea of a signed wind ``U10`` along x: ``get_initial_windsea
    (U10, 0, time_scale)``, so ``cg_bar_x`` and ``m_x`` carry U10's sign and
    ``cg_bar_y = m_y = 0``."""
    dtype = _dtype(dtype, U10, time_scale)
    U10 = _real(U10, dtype)
    return get_initial_windsea(U10, torch.zeros_like(U10), time_scale, type,
                               dtype=dtype)


def MinimalWindsea_1d(U10, time_scale, type: str = "JONSWAP", *,
                      dtype=None) -> WindSea:
    """The 1D windsea of a 1 m/s wind with U10's sign (+1 where U10 is 0)."""
    dtype = _dtype(dtype, U10, time_scale)
    U10 = _real(U10, dtype)
    return get_initial_windsea_1d(_nonzero_sign(U10) * U_MIN, time_scale,
                                  type, dtype=dtype)


def PMParameters(U10):
    """Pierson-Moskowitz peak frequency, Hs and energy.  The Julia source
    computes E = (Hs/4)^4 in this untested function; the PM variance is
    E = (Hs/4)^2, as the JAX package corrects it (and as the PM seed of
    ``get_initial_windsea`` has it)."""
    f_peak = 0.816 * G_GRAVITY / (2.0 * math.pi * U10)
    Hs = 0.0246 * U10 ** 2
    E = (Hs / 4.0) ** 2
    return dict(f_peak=f_peak, Hs=Hs, E=E)


def PMlimits():
    """The fully developed PM sea's non-dimensional energy and peak
    frequency."""
    return dict(E_tilde=0.00402, f_p_tilde=0.123)


# ---------------------------------------------------------------------------
# JONSWAP helpers of the Julia source's "old functions", with the JAX
# package's fixes of the faults in paths the source never ran
# ---------------------------------------------------------------------------

FETCH_GROWTH_PARAMETER = 3.5


def f_m_from_X(U10, X, fgp: float = FETCH_GROWTH_PARAMETER):
    """JONSWAP peak frequency from dimensional fetch."""
    return fgp * (G_GRAVITY / U10) * X_tilde(X, U10) ** (-0.33)


def X_tilde_j_U_freq(U10, f_max, fgp: float = FETCH_GROWTH_PARAMETER):
    """Non-dimensional JONSWAP fetch from peak frequency."""
    return fgp ** 3.0815 * G_GRAVITY ** 3 / (U10 ** 3 * f_max ** 3)


def X_j_U_freq(U10, f_max, fgp: float = FETCH_GROWTH_PARAMETER):
    """Dimensional JONSWAP fetch (meters) from peak frequency."""
    return fgp ** 3.0815 * G_GRAVITY ** 2 / (U10 * f_max ** 3)


def X_tilde_j_U_tau(U10, tau):
    """Non-dimensional JONSWAP fetch from duration tau (seconds)."""
    return (tau * G_GRAVITY / (14.0 * math.pi * U10)) ** 1.5


def tau_j(U10, X):
    """Equivalent JONSWAP duration (seconds) of fetch X (meters), the
    inverse of ``X_tilde_j_U_tau`` (the Julia source swaps X_tilde's
    arguments)."""
    return 14.0 * math.pi * (U10 / G_GRAVITY) * X_tilde(X, U10) ** (2.0 / 3.0)


def f_m_given_U_tau(U10, tau):
    """JONSWAP peak frequency from wind and duration, with the empirical
    1.035 adjustment."""
    Xt = X_tilde_j_U_tau(U10, tau)
    f_max = FETCH_GROWTH_PARAMETER * (G_GRAVITY / U10) * Xt ** (-1.0 / 3.0)
    return f_max * 1.035


def c_g_U_tau(U10, tau):
    """Peak group speed g / (4 pi f_m) from wind and duration."""
    return G_GRAVITY / (4.0 * math.pi * f_m_given_U_tau(U10, tau))


def E_j(U10, tau):
    """JONSWAP wave energy from wind and duration."""
    f_max = f_m_given_U_tau(U10, tau)
    return E_JONSWAP(f_max, alpha_j(U10, f_max))


def JONSWAP_omega(U10, omega_p, omega, *, dtype=None):
    """JONSWAP spectral density S(omega) with the 3.3^Gamma peak
    enhancement; ``alpha_j`` takes the peak in Hz, omega_p / 2 pi (the
    Julia source reads an undefined global U and passes omega_p)."""
    omega = _real(omega, _dtype(dtype, U10, omega_p, omega))
    a_j = alpha_j(U10, omega_p / (2.0 * math.pi))
    S = (2.0 * math.pi * a_j * G_GRAVITY ** 2) / omega ** 5 \
        * torch.exp(-(5.0 / 4.0) * (omega_p / omega) ** 4)
    sigma = torch.where(omega > omega_p, 0.09, 0.07).to(omega.dtype)
    Gamma_j = torch.exp(-(omega - omega_p) ** 2
                        / (2.0 * sigma ** 2 * omega_p ** 2))
    return S * 3.3 ** Gamma_j


def JONSWAP_frequency(U10, f_p, freq, *, dtype=None):
    """JONSWAP spectral density over frequency (Hz)."""
    dtype = _dtype(dtype, U10, f_p, freq)
    return JONSWAP_omega(U10, 2.0 * math.pi * f_p,
                         2.0 * math.pi * _real(freq, dtype),
                         dtype=dtype) * 2.0 * math.pi


def PMSpectrum(U10, f, *, dtype=None):
    """Pierson-Moskowitz spectrum S(f) (Massel eq. 3.79-3.80)."""
    f = _real(f, _dtype(dtype, U10, f))
    wp = 0.879 * G_GRAVITY / U10
    w = 2.0 * math.pi * f
    sigma = 0.04 * G_GRAVITY / wp ** 2
    alpha = 5.0 * (wp ** 2 * sigma / G_GRAVITY) ** 2
    return alpha * w ** (-5.0) * G_GRAVITY ** 2 \
        * torch.exp(-5.0 / 4.0 * (w / wp) ** (-4.0))
