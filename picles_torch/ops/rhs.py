"""Particle-wave ODE right-hand sides (PyTorch port of
``picles_tpu/ops/rhs.py``): the 2D one, the 1D model's
(``particle_equations_1d``, plain PyTorch only), the constant-velocity ray
tracer (``particle_rays``) and the source-term helpers (``speed`` ...
``S_dir``), each the closure of the Kudryavtsev et al. (2021) terms as the
JAX package writes it.  ``rhs_core_2d`` does not call the helpers: it
forms the same terms with fewer transcendentals (squared norms, the
wave-age clamp on alpha^2), in the order of operations the kernels share.

``rhs_core_2d`` is the plain version of the device function ``rhs_core_2d``
in ``picles_torch/csrc/rhs.cuh``; the two keep the same guarded forms and
the same order of float32 operations (products left to right, squares as
products), so the kernels and this twin differ only in the last ulp of the
transcendentals.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..core.constants import (IDConstants, ODEParameters, e_T_func,
                              magic_fractions)

ALPHA_THRESH = 0.85


class RHSParams(NamedTuple):
    """Per-particle parameters of the RHS: node coordinates ``x, y`` (where
    the wind is sampled), projection ``M [..., 2, 2]`` and great-circle
    coefficient ``pc``."""

    x: torch.Tensor
    y: torch.Tensor
    M: torch.Tensor
    pc: torch.Tensor


def speed(cx, cy):
    return torch.sqrt(cx ** 2 + cy ** 2)


def alpha_p(u, v, cx, cy):
    """Projected wave age: (u cx + v cy) / (2 max(|c|, 1e-4)^2)."""
    return (u * cx + v * cy) / (2.0 * torch.clamp(speed(cx, cy), min=1e-4) ** 2)


def alpha_func(u_speed, c_gp_speed):
    """Wave age u / (2 c_gp), clamped at 500."""
    a = u_speed / (2.0 * c_gp_speed)
    return torch.where(a > 500.0, 500.0, a)


def sin2_a_min_b(ux, uy, cx, cy):
    """sin(2 (phi_u - phi_c)) from the components; 0 where either vector
    is 0."""
    denom = speed(ux, uy) * speed(cx, cy)
    safe = torch.where(denom == 0, 1.0, denom)
    val = (2.0 / safe ** 2) * (ux * uy * (2.0 * cy ** 2 - speed(cx, cy) ** 2)
                               - cx * cy * (2.0 * uy ** 2 - speed(ux, uy) ** 2))
    return torch.where(denom == 0, 0.0, val)


def H_beta(alpha, p):
    """Input window 0.5 (1 + tanh(p (alpha - 0.85)))."""
    return 0.5 * (1.0 + torch.tanh(p * (alpha - ALPHA_THRESH)))


def Delta_beta(alpha):
    """Peak-shift window 1 - 1.25 sech^2(10 (alpha - 0.85)), sech written
    through exp (stable for large arguments)."""
    ax = torch.abs(10.0 * (alpha - ALPHA_THRESH))
    e = torch.exp(-ax)
    sech = 2.0 * e / (1.0 + e * e)
    return 1.0 - 1.25 * sech ** 2


def c_g_conversions(c_bar, r_g, g):
    """(c_gp, k_p, omega_p) from the mean group speed."""
    c_gp = c_bar / r_g
    k_p = g / (4.0 * torch.clamp(c_gp ** 2, min=1e-2))
    omega_p = g / (2.0 * torch.clamp(torch.abs(c_gp), min=0.1))
    return c_gp, k_p, omega_p


def I_tilde(alpha, H_p, C_e):
    """Wind input C_e H_p alpha^2."""
    return C_e * H_p * alpha ** 2


def D_tilde_lne(lne, k_p, e_T, n):
    """Dissipation exp(n lne) (k_p / e_T)^(2n)."""
    return torch.exp(n * lne) * (k_p / e_T) ** (2.0 * n)


def S_cg(lne, Delta_p, k_p, C_alpha):
    """Peak downshift C_alpha Delta_p k_p^4 e^(2 lne)."""
    return C_alpha * Delta_p * k_p ** 4 * torch.exp(2.0 * lne)


def S_dir(u, v, cx, cy, C_varphi, H_p):
    """Peak-direction shift alpha^2 C_varphi H_p sin(2 (phi_u - phi_c))."""
    return (alpha_func(speed(u, v), speed(cx, cy)) ** 2
            * C_varphi * H_p * sin2_a_min_b(u, v, cx, cy))


@dataclasses.dataclass(frozen=True)
class TermFlags:
    """Source-term switches."""

    propagation: bool = True
    input: bool = True
    dissipation: bool = True
    peak_shift: bool = True
    direction: bool = True


class RHSConsts(NamedTuple):
    """Scalar constants of the RHS."""

    r_g: float
    C_alpha: float
    C_e: float
    C_varphi: float
    g: float
    p: float
    n: float
    e_T: float


def make_rhs_consts(gamma: float = 0.88, q: float = -0.25,
                    constants: Optional[IDConstants] = None,
                    params: Optional[ODEParameters] = None) -> RHSConsts:
    if params is None:
        params, constants, _ = ODEParameters.create(q=q)
    if constants is None:
        constants = IDConstants.create(r_g=params.r_g, q=q)
    p_, q_, n_ = magic_fractions(q)
    e_T = e_T_func(gamma, p_, q_, n_, c_beta=constants.c_beta,
                   c_D=constants.c_D, c_e=constants.c_e,
                   c_alpha=constants.c_alpha)
    return RHSConsts(r_g=params.r_g, C_alpha=params.C_alpha, C_e=params.C_e,
                     C_varphi=params.C_varphi, g=params.g, p=p_, n=n_,
                     e_T=e_T)


def rhs_core_2d(lne, cg_x, cg_y, u, v, M00, M01, M10, M11, pc,
                c: RHSConsts, flags: TermFlags = TermFlags()):
    """Component-wise 2D RHS; returns (dlne, dcg_x, dcg_y, dx, dy).

    The wave-age clamp acts on alpha^2 <= 500^2, alpha_p's denominator is
    max(|c_gp|^2, 1e-8), sin(2(phi_u - phi_c)) uses squared norms with a
    ``safe`` denominator, and sech is written through ``exp``."""
    c2 = cg_x * cg_x + cg_y * cg_y
    u2 = u * u + v * v
    rg2 = c.r_g * c.r_g
    cgp2_raw = c2 / rg2

    k_p = c.g / (4.0 * torch.clamp(cgp2_raw, min=1e-2))
    omega_p = c.g / (2.0 * torch.clamp(torch.sqrt(c2) / c.r_g, min=0.1))
    c_gp_x = cg_x / c.r_g
    c_gp_y = cg_y / c.r_g

    alpha2 = torch.where(u2 / (4.0 * cgp2_raw) > 250000.0, 250000.0,
                         u2 / (4.0 * cgp2_raw))
    a_p = (u * c_gp_x + v * c_gp_y) / (2.0 * torch.clamp(cgp2_raw, min=1e-8))
    H_p = 0.5 * (1.0 + torch.tanh(c.p * (a_p - ALPHA_THRESH)))
    ax = torch.abs(10.0 * (a_p - ALPHA_THRESH))
    ex = torch.exp(-ax)
    sech = 2.0 * ex / (1.0 + ex * ex)
    Delta_p = 1.0 - 1.25 * (sech * sech)

    I_t = c.C_e * H_p * alpha2 if flags.input else 0.0
    if flags.dissipation:
        D_t = torch.exp(c.n * (lne + 2.0 * torch.log(k_p / c.e_T)))
    else:
        D_t = 0.0
    if flags.peak_shift:
        k_p2 = k_p * k_p
        S_cg_t = c.C_alpha * Delta_p * (k_p2 * k_p2) * torch.exp(2.0 * lne)
    else:
        S_cg_t = 0.0
    if flags.direction:
        prod = u2 * cgp2_raw
        safe = torch.where(prod == 0, 1.0, prod)
        sin2 = torch.where(
            prod == 0, 0.0,
            (2.0 / safe) * (u * v * (2.0 * (c_gp_y * c_gp_y) - cgp2_raw)
                            - c_gp_x * c_gp_y * (2.0 * (v * v) - u2)))
        S_dir_t = alpha2 * c.C_varphi * H_p * sin2
    else:
        S_dir_t = 0.0
    S_sphere_t = pc * cg_x

    dlne = omega_p * c.r_g * S_cg_t + omega_p * (I_t - D_t)
    dcg_x = -cg_x * omega_p * c.r_g * S_cg_t + cg_y * S_dir_t + cg_y * S_sphere_t
    dcg_y = -cg_y * omega_p * c.r_g * S_cg_t - cg_x * S_dir_t - cg_x * S_sphere_t

    if flags.propagation:
        dx = M00 * cg_x + M01 * cg_y
        dy = M10 * cg_x + M11 * cg_y
    else:
        dx = torch.zeros_like(cg_x)
        dy = torch.zeros_like(cg_y)
    return dlne, dcg_x, dcg_y, dx, dy


def particle_equations(u_wind: Callable, v_wind: Callable, *,
                       gamma: float = 0.88, q: float = -0.25,
                       constants: Optional[IDConstants] = None,
                       params: Optional[ODEParameters] = None,
                       flags: TermFlags = TermFlags()) -> Callable:
    """Build ``rhs(t, z, aux: RHSParams) -> dz`` over stacked
    ``z[..., 5] = [lne, cg_x, cg_y, x, y]``."""
    consts = make_rhs_consts(gamma=gamma, q=q, constants=constants,
                             params=params)
    return make_rhs(u_wind, v_wind, consts, flags)


def make_rhs(u_wind: Callable, v_wind: Callable, consts: RHSConsts,
             flags: TermFlags = TermFlags()) -> Callable:
    """``particle_equations`` from ready constants."""

    def rhs(t, z, aux: RHSParams):
        lne, cg_x, cg_y = z[..., 0], z[..., 1], z[..., 2]
        u = torch.broadcast_to(u_wind(aux.x, aux.y, t).to(lne.dtype),
                               lne.shape)
        v = torch.broadcast_to(v_wind(aux.x, aux.y, t).to(lne.dtype),
                               lne.shape)
        out = rhs_core_2d(lne, cg_x, cg_y, u, v,
                          aux.M[..., 0, 0], aux.M[..., 0, 1],
                          aux.M[..., 1, 0], aux.M[..., 1, 1],
                          aux.pc, consts, flags)
        return torch.stack(out, dim=-1)

    return rhs


def particle_equations_1d(u_wind: Callable, *, gamma: float = 0.88,
                          q: float = -0.25,
                          constants: Optional[IDConstants] = None,
                          params: Optional[ODEParameters] = None,
                          flags: TermFlags = TermFlags()) -> Callable:
    """Build the 1D RHS ``rhs(t, z, aux) -> dz`` over ``z[..., 3] = [lne,
    cg_x, x]`` (x absolute, in meters).  ``aux``: the node positions where
    the wind is sampled (a tensor, or an object with ``.x``, such as a
    ``Grid1D``).

    The 1D closures differ from ``rhs_core_2d``'s: no direction terms, the
    wave age alpha = |u| / (2 |c_gp|) (clamped at 500, not its square at
    500^2) feeds the H and Delta windows, dissipation is written
    exp(n lne) (k_p / e_T)^(2n), and dx = cg_x.  The constants are
    ``make_rhs_consts``'."""
    c = make_rhs_consts(gamma=gamma, q=q, constants=constants, params=params)

    def rhs(t, z, aux):
        lne, cg_x = z[..., 0], z[..., 1]
        x_node = aux.x if hasattr(aux, "x") else aux
        u = torch.broadcast_to(u_wind(x_node, t).to(lne.dtype), lne.shape)

        c_gp = torch.abs(cg_x) / c.r_g
        k_p = c.g / (4.0 * torch.clamp(c_gp * c_gp, min=1e-2))
        omega_p = c.g / (2.0 * torch.clamp(torch.abs(c_gp), min=0.1))
        a = torch.abs(u) / (2.0 * c_gp)
        alpha = torch.where(a > 500.0, 500.0, a)
        H_p = 0.5 * (1.0 + torch.tanh(c.p * (alpha - ALPHA_THRESH)))
        ax = torch.abs(10.0 * (alpha - ALPHA_THRESH))
        ex = torch.exp(-ax)
        sech = 2.0 * ex / (1.0 + ex * ex)
        Delta_p = 1.0 - 1.25 * (sech * sech)

        I_t = c.C_e * H_p * (alpha * alpha) if flags.input else 0.0
        if flags.dissipation:
            D_t = torch.exp(c.n * lne) * (k_p / c.e_T) ** (2.0 * c.n)
        else:
            D_t = 0.0
        if flags.peak_shift:
            k_p2 = k_p * k_p
            S_cg_t = c.C_alpha * Delta_p * (k_p2 * k_p2) * torch.exp(2.0 * lne)
        else:
            S_cg_t = 0.0

        dlne = omega_p * c.r_g * S_cg_t + omega_p * (I_t - D_t)
        dcg_x = -cg_x * omega_p * c.r_g * S_cg_t
        dx = cg_x if flags.propagation else torch.zeros_like(cg_x)
        return torch.stack(torch.broadcast_tensors(dlne, dcg_x, dx), dim=-1)

    return rhs


def particle_rays() -> Callable:
    """The constant-velocity ray tracer ``rhs(t, z, aux) -> dz`` over
    ``z[..., 3] = [lne, cg_x, x]``: dlne = dcg_x = 0, dx = cg_x."""

    def rhs(t, z, aux):
        zero = torch.zeros_like(z[..., 0])
        return torch.stack([zero, zero, z[..., 1]], dim=-1)

    return rhs
