"""Fetch relations and windsea initialization (PyTorch port).

Counterpart of ``picles_tpu/core/fetch_relations.py``, restricted to what
seeding and the remesh use.  Everything is elementwise and computed in
float32, as the JAX package computes it (``jnp.result_type(float)`` with
x64 off): Python inputs and float64 arrays are cast to float32 first, and
the constants enter as Python scalars, which PyTorch rounds to float32.
A tensor input keeps its device, so the model's reseeds stay on the card.
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


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def X_tilde_from_tau(tau):
    """Non-dimensional fetch from non-dimensional duration tau."""
    return (tau / (DULOV_A * DULOV_XI_0X)) ** (1.0 / (1.0 - DULOV_Q_X))


def f_m_from_X_tilde(U10, X_tilde_, fgp: float = 3.5):
    """JONSWAP peak-frequency scale given U10 and non-dim fetch."""
    return fgp * (G_GRAVITY / U10) * X_tilde_ ** (-0.33)


def alpha_j(U10, f_m):
    """JONSWAP spectral-peak enhancement factor 0.033 (f_m U / g)^0.67."""
    return 0.033 * (f_m * U10 / G_GRAVITY) ** 0.67


def E_JONSWAP(f_m, alpha_j_):
    """JONSWAP wave energy 0.31 g^2 alpha_j (2 pi f_m)^-4."""
    return 0.31 * G_GRAVITY ** 2 * alpha_j_ * (f_m * 2.0 * math.pi) ** (-4.0)


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


def get_initial_windsea(U10, V10, time_scale) -> WindSea:
    """JONSWAP windsea from wind components and a duration scale; the wind
    speed is floored at 0.1 m/s."""
    U10 = _f32(U10)
    V10 = _f32(V10, U10.device)
    U_amp = torch.sqrt(U10 * U10 + V10 * V10)
    U_amp = torch.where(U_amp < 0.1, 0.1, U_amp)

    time_scale = torch.abs(_f32(time_scale, U10.device))
    tau = G_GRAVITY * time_scale / U_amp

    X_tilde_ = X_tilde_from_tau(tau)
    f_m_ = f_m_from_X_tilde(U_amp, X_tilde_)
    alpha_j_ = alpha_j(U_amp, f_m_)

    E_ = E_JONSWAP(f_m_, alpha_j_)
    Hs_ = 4.0 * torch.sqrt(E_)
    f_peak = f_m_ * G_GRAVITY / U_amp

    T_bar = 0.9 * (1.0 / f_peak)
    cg_bar_amp = G_GRAVITY * T_bar / (4.0 * math.pi)
    cg_bar_x = cg_bar_amp * U10 / U_amp
    cg_bar_y = cg_bar_amp * V10 / U_amp

    mom_x = (U10 / U_amp) * E_ / (2.0 * cg_bar_amp)
    mom_y = (V10 / U_amp) * E_ / (2.0 * cg_bar_amp)

    return WindSea(E=E_, lne=torch.log(E_), Hs=Hs_, cg_bar_x=cg_bar_x,
                   cg_bar_y=cg_bar_y, cg_bar=cg_bar_amp, f_peak=f_peak,
                   T_bar=T_bar, X_tilde=X_tilde_, m_x=mom_x, m_y=mom_y)


def _nonzero_sign(x):
    """sign(x) but +1 at x == 0 (the JAX package's deterministic stand-in
    for the Julia source's random sign)."""
    return torch.where(x < 0, -1.0, 1.0)


def MinimalWindsea(U10, V10, time_scale) -> WindSea:
    """Windsea of a |U| = 1 m/s wind in the direction of (U10, V10)."""
    U10 = _f32(U10)
    V10 = _f32(V10, U10.device)
    U10 = torch.where(U10 == 0, _nonzero_sign(U10), U10)
    V10 = torch.where(V10 == 0, _nonzero_sign(V10), V10)
    Uamp = torch.sqrt(U10 * U10 + V10 * V10)
    return get_initial_windsea(U_MIN * U10 / Uamp, U_MIN * V10 / Uamp,
                               time_scale)


def MinimalParticle(U10, V10, time_scale):
    """[lne, cg_x, cg_y, 0, 0] of the minimal windsea."""
    ws = MinimalWindsea(U10, V10, time_scale)
    zero = torch.zeros_like(ws.lne)
    return torch.stack([ws.lne, ws.cg_bar_x, ws.cg_bar_y, zero, zero], dim=-1)


def MinimalState(U10, V10, time_scale):
    """[minimal energy, minimal momentum^2] of the minimal windsea."""
    ws = MinimalWindsea(U10, V10, time_scale)
    return torch.stack([ws.E, ws.m_x * ws.m_x + ws.m_y * ws.m_y], dim=-1)
