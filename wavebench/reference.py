"""The plain reference of the benchmark: one WaveGrowth2D step, and a
member-day of steps, in plain PyTorch and NumPy.

This is a frozen copy of the plain path of the PyTorch port (its
``models/wave_growth_2d.py`` ``step_core`` with the plain advance, the
pad-and-fold deposit and the PyTorch remesh), cut to the configurations the
benchmark runs: windsea seeding and reseeding, the boundary type "same", the
carried dt (no Hairer reset), periodic domains.  It imports nothing of the
port, of its JAX reference package or of JAX, and takes nothing the port has
made: it derives the grid's planes from the configuration, the winds from
the forcing's own parameters, and the windsea seeds itself.

One step ``DT``:

1. the advance: every active particle over DT by the embedded RK loop with
   its controller (``integrate_to``), then the guards (re-light of an off
   particle where the wind at its lagged end time is strong, NaN/Inf reset
   to the local windsea, log-energy clamp);
2. the deposit: (E, m_x, m_y) by CIC from each particle's position relative
   to its home node into a padded accumulator, folded periodically in x and
   periodically or over the tripolar north seam in y (``scatter_dense``);
3. the remesh branch table: gather / reseed / off (``remesh_core``);
4. the clock: time + DT, iteration + 1.

A wind is a ``Wind``: its interpolant ``sample`` (the seeds and the
re-light), and ``step_sampler``, what the advance and the remesh read over
one step's window (the interpolant itself unless a kind overrides it, as a
gridded record would with the kernels' window planes).  The kinds live in
``forcing/<kind>.py``; each also names the port's wind for itself
(``Wind.port``) and the work its planes add to the roofline counts.

``state_round``: a dtype the particle and node state is rounded to after
every step (the control of the benchmark's comparison: the state held in
bfloat16), the clocks kept in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

G = 9.81
SQRT2 = math.sqrt(2.0)

# ---------------------------------------------------------------------------
# constants (Kudryavtsev et al. 2021 closure, as the port sets them)
# ---------------------------------------------------------------------------


def magic_fractions(q: float = -0.25):
    p = (-1.0 - 10.0 * q) / 2.0
    n = 2.0 * q / (p + 4.0 * q)
    return p, q, n


class Consts(NamedTuple):
    r_g: float
    C_alpha: float
    C_e: float
    C_varphi: float
    g: float
    p: float
    n: float
    e_T: float


def rhs_consts(r_g: float = 0.85, q: float = -0.25) -> Consts:
    """The RHS's scalar constants: r_g 0.85, c_D 2e-3, c_beta 4e-2, c_e
    1.3e-6, c_alpha 11.8, r_w 2.35, C_alpha -1.41, C_varphi 1.81e-5."""
    c_D, c_beta, c_e, c_alpha, r_w = 2e-3, 4e-2, 1.3e-6, 11.8, 2.35
    p, q, n = magic_fractions(q)
    C_e = r_w * c_beta * c_D / r_g
    gamma = 1.0 - (p - q) / (c_alpha ** 4 * C_e * 2.0)
    e_T = math.sqrt(c_e * c_alpha ** (-p / q)
                    / (gamma * c_beta * c_D) ** (1.0 / n))
    return Consts(r_g=r_g, C_alpha=-1.41, C_e=C_e, C_varphi=1.81e-5, g=G,
                  p=p, n=n, e_T=e_T)


# ---------------------------------------------------------------------------
# windsea seeds (JONSWAP, Dulov time -> fetch)
# ---------------------------------------------------------------------------

DULOV_Q_X = 0.2748
DULOV_A = 22.8013
DULOV_XI_0X = 2.4097


class WindSea(NamedTuple):
    E: torch.Tensor
    lne: torch.Tensor
    cg_x: torch.Tensor
    cg_y: torch.Tensor
    m_x: torch.Tensor
    m_y: torch.Tensor


def _t(x, dtype, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.full((), float(x), dtype=dtype, device=device)


def windsea(U10, V10, time_scale, dtype=torch.float32) -> WindSea:
    """The JONSWAP windsea of a wind (U10, V10) grown over ``time_scale``
    seconds, the wind speed floored at 0.1 m/s."""
    U10 = _t(U10, dtype)
    V10 = _t(V10, dtype, U10.device)
    U_amp = torch.sqrt(U10 * U10 + V10 * V10)
    U_amp = torch.where(U_amp < 0.1, 0.1, U_amp)
    ts = torch.abs(_t(time_scale, dtype, U10.device))
    tau = G * ts / U_amp
    X_tilde = (tau / (DULOV_A * DULOV_XI_0X)) ** (1.0 / (1.0 - DULOV_Q_X))
    f_m = 3.5 * (G / U_amp) * X_tilde ** (-0.33)
    alpha_j = 0.033 * (f_m * U_amp / G) ** 0.67
    E = 0.31 * G ** 2 * alpha_j * (f_m * 2.0 * math.pi) ** (-4.0)
    f_peak = f_m * G / U_amp
    T_bar = 0.9 * (1.0 / f_peak)
    cg_amp = G * T_bar / (4.0 * math.pi)
    cg_x = cg_amp * U10 / U_amp
    cg_y = cg_amp * V10 / U_amp
    m_x = (U10 / U_amp) * E / (2.0 * cg_amp)
    m_y = (V10 / U_amp) * E / (2.0 * cg_amp)
    return WindSea(E=E, lne=torch.log(E), cg_x=cg_x, cg_y=cg_y, m_x=m_x,
                   m_y=m_y)


def _nonzero_sign(x):
    return torch.where(x < 0, -1.0, 1.0).to(x.dtype)


def minimal_windsea(U10, V10, time_scale, dtype=torch.float32) -> WindSea:
    """The windsea of a 1 m/s wind in the direction of (U10, V10)."""
    U10 = _t(U10, dtype)
    V10 = _t(V10, dtype, U10.device)
    U10 = torch.where(U10 == 0, _nonzero_sign(U10), U10)
    V10 = torch.where(V10 == 0, _nonzero_sign(V10), V10)
    Uamp = torch.sqrt(U10 * U10 + V10 * V10)
    return windsea(U10 / Uamp, V10 / Uamp, time_scale, dtype)


def minimal_state(U10, V10, time_scale, dtype=torch.float32):
    """(minimal energy, minimal momentum squared) as host floats in
    ``dtype``."""
    ws = minimal_windsea(U10, V10, time_scale, dtype)
    return float(ws.E), float(ws.m_x * ws.m_x + ws.m_y * ws.m_y)


def seed_planes(u, v, time_scale):
    """(lne, cgx, cgy) of the windsea of (u, v)."""
    ws = windsea(u, v, time_scale, dtype=u.dtype)
    return ws.lne, ws.cg_x, ws.cg_y


# ---------------------------------------------------------------------------
# particle <-> node
# ---------------------------------------------------------------------------

_TINY = 1e-30


def particle_to_node(lne, cg_x, cg_y):
    e = torch.exp(lne)
    c2 = torch.clamp(cg_x * cg_x + cg_y * cg_y, min=_TINY)
    return e, cg_x * e / c2 / 2.0, cg_y * e / c2 / 2.0


def node_to_particle(e, m_x, m_y):
    m2 = torch.clamp(m_x * m_x + m_y * m_y, min=_TINY)
    e_safe = torch.clamp(e, min=_TINY)
    return (torch.log(e_safe), m_x * e_safe / (2.0 * m2),
            m_y * e_safe / (2.0 * m2))


# ---------------------------------------------------------------------------
# winds
# ---------------------------------------------------------------------------

class Wind:
    """A plain wind.  A kind (``forcing/<kind>.py``) gives ``sample(x, y,
    t) -> (u, v)`` (float32, m/s) and ``port(pt)``, the port's wind for the
    same forcing (``pt`` is the port's package, handed in: no plain code
    imports it).  ``step_sampler(x, y, t0, DT)`` is what the advance and the
    remesh read over the step from ``t0``: ``sampler(idx)`` the sampler of
    the flat lanes ``idx`` (None: every node).  The counts below are what
    the kernels read of the wind beyond the nodes' own planes: the window
    planes a lane reads (``n_wf``), the frames a window can straddle
    (``breakpoints``) and the forcing values the nodes read a step
    (``values_read``): none for a wind the kernels compute in place."""

    def sample(self, x, y, t):
        raise NotImplementedError

    def port(self, pt):
        raise NotImplementedError

    def step_sampler(self, x, y, t0, DT: float) -> Callable:
        return lambda idx=None: self.sample

    def n_wf(self, DT: float) -> int:
        return 0

    def breakpoints(self, DT: float) -> int:
        return 0

    def values_read(self, x, y, DT: float) -> int:
        return 0


def winds_at(sample, x, y, t, dtype=torch.float32):
    shape = torch.broadcast_shapes(x.shape, t.shape)
    u, v = sample(x, y, torch.broadcast_to(t, shape))
    return (torch.broadcast_to(u.to(dtype), shape),
            torch.broadcast_to(v.to(dtype), shape))


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------

PERIODIC, NONPERIODIC, TRIPOLAR_NORTH = 0, 1, 2


@dataclasses.dataclass(eq=False)
class Grid:
    """Node planes ``[nx, ny]``: x, y, the projection ``M [nx, ny, 2, 2]``
    (m/s -> grid index/s), the great-circle coefficient ``pc``, the total
    mask (0 land, 1 ocean, 2 land boundary, 3 grid boundary) and the axes'
    boundaries."""

    x: torch.Tensor
    y: torch.Tensor
    M: torch.Tensor
    pc: torch.Tensor
    mask: torch.Tensor
    bx: int
    by: int

    @property
    def shape(self):
        return tuple(self.x.shape)

    def to(self, device) -> "Grid":
        return dataclasses.replace(
            self, x=self.x.to(device), y=self.y.to(device),
            M=self.M.to(device), pc=self.pc.to(device),
            mask=self.mask.to(device))


def interior_boundary(mask: np.ndarray) -> np.ndarray:
    mask = np.asarray(mask, dtype=bool)
    b = np.zeros_like(mask)
    for shift in [(1, 0), (-1, 0), (0, 1), (0, -1)]:
        b |= np.roll(mask, shift, axis=(0, 1)) & ~mask
    return b


def make_boundaries(mask: np.ndarray, bx: int, by: int) -> np.ndarray:
    """Total mask {0 land, 1 ocean, 2 land boundary, 3 grid boundary}."""
    mask = np.asarray(mask, dtype=bool)
    total = mask.astype(np.int32) + 2 * interior_boundary(mask).astype(
        np.int32)
    if bx == NONPERIODIC:
        total[0, :] = 3
        total[-1, :] = 3
    if by == NONPERIODIC:
        total[:, 0] = 3
        total[:, -1] = 3
    return total


def box_grid(nx: int, ny: int, spacing: float, device,
             dtype=torch.float32) -> Grid:
    """A periodic Cartesian box of ``nx`` x ``ny`` nodes ``spacing`` m
    apart, from 0: the planes in float64, rounded once."""
    Lx, Ly = spacing * (nx - 1), spacing * (ny - 1)
    dx, dy = Lx / (nx - 1), Ly / (ny - 1)
    XX, YY = np.meshgrid(np.linspace(0.0, Lx, nx), np.linspace(0.0, Ly, ny),
                         indexing="ij")
    M = np.broadcast_to(np.array([[1.0 / dx, 0.0], [0.0, 1.0 / dy]]),
                        (nx, ny, 2, 2))
    total = make_boundaries(np.ones((nx, ny), bool), PERIODIC, PERIODIC)
    npd = torch.empty((), dtype=dtype).numpy().dtype

    def t(a, d=npd):
        return torch.as_tensor(np.ascontiguousarray(a, d), device=device)

    return Grid(x=t(XX), y=t(YY), M=t(M), pc=torch.zeros((nx, ny),
                                                         dtype=dtype,
                                                         device=device),
                mask=t(total, np.int32), bx=PERIODIC, by=PERIODIC)


# ---------------------------------------------------------------------------
# the right-hand side
# ---------------------------------------------------------------------------

ALPHA_THRESH = 0.85


def rhs_terms(lne, cg_x, cg_y, u, v, M00, M01, M10, M11, pc, c: Consts):
    """(dlne, dcg_x, dcg_y, dx, dy) of the particle equations, every term
    on: propagation, wind input, dissipation, peak shift, direction, the
    great-circle turn."""
    c2 = cg_x * cg_x + cg_y * cg_y
    u2 = u * u + v * v
    rg2 = c.r_g * c.r_g
    cgp2 = c2 / rg2
    k_p = c.g / (4.0 * torch.clamp(cgp2, min=1e-2))
    omega_p = c.g / (2.0 * torch.clamp(torch.sqrt(c2) / c.r_g, min=0.1))
    c_gp_x = cg_x / c.r_g
    c_gp_y = cg_y / c.r_g
    alpha2 = torch.where(u2 / (4.0 * cgp2) > 250000.0, 250000.0,
                         u2 / (4.0 * cgp2))
    a_p = (u * c_gp_x + v * c_gp_y) / (2.0 * torch.clamp(cgp2, min=1e-8))
    H_p = 0.5 * (1.0 + torch.tanh(c.p * (a_p - ALPHA_THRESH)))
    ax = torch.abs(10.0 * (a_p - ALPHA_THRESH))
    ex = torch.exp(-ax)
    sech = 2.0 * ex / (1.0 + ex * ex)
    Delta_p = 1.0 - 1.25 * (sech * sech)
    I_t = c.C_e * H_p * alpha2
    D_t = torch.exp(c.n * (lne + 2.0 * torch.log(k_p / c.e_T)))
    k_p2 = k_p * k_p
    S_cg = c.C_alpha * Delta_p * (k_p2 * k_p2) * torch.exp(2.0 * lne)
    prod = u2 * cgp2
    safe = torch.where(prod == 0, 1.0, prod)
    sin2 = torch.where(
        prod == 0, 0.0,
        (2.0 / safe) * (u * v * (2.0 * (c_gp_y * c_gp_y) - cgp2)
                        - c_gp_x * c_gp_y * (2.0 * (v * v) - u2)))
    S_dir = alpha2 * c.C_varphi * H_p * sin2
    S_sph = pc * cg_x
    dlne = omega_p * c.r_g * S_cg + omega_p * (I_t - D_t)
    dcg_x = -cg_x * omega_p * c.r_g * S_cg + cg_y * S_dir + cg_y * S_sph
    dcg_y = -cg_y * omega_p * c.r_g * S_cg - cg_x * S_dir - cg_x * S_sph
    dx = M00 * cg_x + M01 * cg_y
    dy = M10 * cg_x + M11 * cg_y
    return dlne, dcg_x, dcg_y, dx, dy


def make_rhs(sample, x, y, M, pc, c: Consts) -> Callable:
    """``rhs(t, z) -> dz`` over ``z[..., 5] = [lne, cg_x, cg_y, x, y]`` of
    lanes at the nodes ``x, y`` (projection ``M [..., 2, 2]``, great-circle
    coefficient ``pc``), the wind ``sample(x, y, t)`` at the home node."""
    def rhs(t, z):
        lne, cg_x, cg_y = z[..., 0], z[..., 1], z[..., 2]
        u, v = sample(x, y, t)
        u = torch.broadcast_to(u.to(lne.dtype), lne.shape)
        v = torch.broadcast_to(v.to(lne.dtype), lne.shape)
        out = rhs_terms(lne, cg_x, cg_y, u, v, M[..., 0, 0], M[..., 0, 1],
                        M[..., 1, 0], M[..., 1, 1], pc, c)
        return torch.stack(out, dim=-1)

    return rhs


# ---------------------------------------------------------------------------
# the embedded RK loop
# ---------------------------------------------------------------------------

class Tableau(NamedTuple):
    c: tuple
    a: tuple
    b: tuple
    bt: tuple
    order: float


TABLEAUX = {
    "tsit5": Tableau(
        c=(0.161, 0.327, 0.9, 0.9800255409045097, 1.0),
        a=((0.161,),
           (-0.008480655492356989, 0.335480655492357),
           (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
           (5.325864828439257, -11.748883564062828, 7.4955393428898365,
            -0.09249506636175525),
           (5.86145544294642, -12.92096931784711, 8.159367898576159,
            -0.071584973281401, -0.028269050394068383)),
        b=(0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
           -3.290069515436081, 2.324710524099774),
        bt=(-0.00178001105222577714, -0.0008164344596567469,
            0.007880878010261995, -0.1447110071732629, 0.5823571654525552,
            -0.45808210592918697, 0.015151515151515152),
        order=5.0),
    "bosh3": Tableau(
        c=(0.5, 0.75),
        a=((0.5,), (0.0, 0.75)),
        b=(2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0),
        bt=(2.0 / 9.0 - 7.0 / 24.0, 1.0 / 3.0 - 1.0 / 4.0,
            4.0 / 9.0 - 1.0 / 3.0, -1.0 / 8.0),
        order=3.0),
}

SAFETY, QMIN, QMAX = 0.9, 0.2, 10.0


@dataclasses.dataclass(frozen=True)
class Solver:
    method: str = "bosh3"
    abstol: float = 1e-4
    reltol: float = 1e-3
    dtmin: float = 1e-4
    force_dtmin: bool = True
    maxiters: int = 10_000


def _rms(x):
    s = x[..., 0] * x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i] * x[..., i]
    return torch.sqrt(s / x.shape[-1])


def rk_step(tab: Tableau, rhs, t, z, dt, k1):
    dt_ = dt[..., None]
    ks = [k1]
    for ci, row in zip(tab.c, tab.a):
        acc = z
        for aij, kj in zip(row, ks):
            if aij != 0.0:
                acc = acc + dt_ * aij * kj
        ks.append(rhs(t + ci * dt, acc))
    z_new = z
    for bi, ki in zip(tab.b, ks):
        if bi != 0.0:
            z_new = z_new + dt_ * bi * ki
    ks.append(rhs(t + dt, z_new))
    err = torch.zeros_like(z)
    for bti, ki in zip(tab.bt, ks):
        if bti != 0.0:
            err = err + bti * ki
    return z_new, dt_ * err, ks[-1]


class Solved(NamedTuple):
    z: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor
    failed: torch.Tensor
    naccept: torch.Tensor
    nreject: torch.Tensor


def integrate_to(rhs_for, z0, t0, t_end, dt0, active, s: Solver,
                 compact: bool = True) -> Solved:
    """Every active lane from ``t0`` to ``t_end``: land exactly on t_end,
    dt floored at max(dtmin, 4 eps max(|t|, |t_end|)), steps at that floor
    accepted (``force_dtmin``), the error norm an RMS of err / (abstol +
    reltol max(|z|, |z_new|)), the step factor 0.9 enorm^(-1/order) in [0.2,
    10] (at most 1 after a rejection).

    The lanes are flat; ``rhs_for(idx)`` gives the right-hand side over the
    lanes ``idx``.  The loop works on the live lanes only: they are gathered
    at the start and again whenever fewer than half of those in hand are
    live (every operation is elementwise in the lanes, so on the card
    gathering changes no value).  ``compact=False`` keeps every lane in
    hand: on the CPU a transcendental's vector body and its scalar tail can
    part by an ulp, so a lane's value there depends on its place in the
    tensor, and only the whole tensor is the port's plain path bit for
    bit."""
    shape, D = t0.shape, z0.shape[-1]
    tab = TABLEAUX[s.method]
    eps4 = 4.0 * torch.finfo(z0.dtype).eps
    Z = z0.reshape(-1, D).clone()
    T = t0.reshape(-1).clone()
    DTs = torch.clamp(dt0, min=s.dtmin).reshape(-1).clone()
    TE = torch.broadcast_to(t_end, shape).reshape(-1)
    act = active.reshape(-1)
    FAILED = torch.zeros_like(act)
    NACC = torch.zeros(T.shape, dtype=torch.int32, device=T.device)
    NREJ = torch.zeros_like(NACC)
    todo = act & ~(T >= TE)
    idx = (torch.nonzero(todo).reshape(-1) if compact else
           torch.arange(T.numel(), device=T.device))
    z, t, dt, te = Z[idx], T[idx], DTs[idx], TE[idx]
    rhs = rhs_for(idx)
    k1 = rhs(t, z)
    done = ~todo[idx]
    failed = torch.zeros_like(done)
    nacc = torch.zeros(idx.shape, dtype=torch.int32, device=T.device)
    nrej = torch.zeros_like(nacc)

    def put_back():
        Z[idx], T[idx], DTs[idx] = z, t, dt
        FAILED[idx], NACC[idx], NREJ[idx] = failed, nacc, nrej

    iters = 0
    live_n = int(todo.sum())
    while iters < s.maxiters and live_n:
        live = ~done
        remaining = te - t
        dtmin_eff = torch.clamp(
            eps4 * torch.maximum(torch.abs(t), torch.abs(te)), min=s.dtmin)
        dt_try = torch.minimum(torch.maximum(dt, dtmin_eff),
                               torch.maximum(remaining, dtmin_eff))
        at_dtmin = dt_try <= dtmin_eff * (1.0 + 1e-8)
        z_new, err, k_fsal = rk_step(tab, rhs, t, z, dt_try, k1)
        sc = s.abstol + s.reltol * torch.maximum(torch.abs(z),
                                                 torch.abs(z_new))
        enorm = _rms(err / sc)
        finite = torch.isfinite(z_new).all(dim=-1) & torch.isfinite(enorm)
        accept = (enorm <= 1.0) & finite
        if s.force_dtmin:
            accept = accept | at_dtmin
        newly_failed = live & at_dtmin & ~accept
        q = SAFETY * torch.clamp(enorm, min=1e-10) ** (-1.0 / tab.order)
        q = torch.where(finite, q, QMIN)
        dt_next = torch.where(
            accept, dt_try * torch.clamp(q, QMIN, QMAX),
            torch.maximum(dt_try * torch.clamp(q, QMIN, 1.0), dtmin_eff))
        upd = live & accept
        t = torch.where(upd, t + dt_try, t)
        z = torch.where(upd[..., None], z_new, z)
        dt = torch.where(live, dt_next, dt)
        k1 = torch.where(upd[..., None], k_fsal, k1)
        done = done | (live & (t >= te - 1e-9)) | newly_failed
        failed = failed | newly_failed
        nacc = nacc + upd.to(torch.int32)
        nrej = nrej + (live & ~accept).to(torch.int32)
        iters += 1
        live_n = int((~done).sum())
        if compact and 0 < live_n and 2 * live_n < idx.numel():
            put_back()
            keep = ~done
            idx, z, t, dt, te, k1 = (a[keep] for a in (idx, z, t, dt, te, k1))
            failed, nacc, nrej, done = (a[keep] for a in (failed, nacc, nrej,
                                                          done))
            rhs = rhs_for(idx)
    put_back()
    FAILED[idx[~done]] = True
    t_final = torch.where(act & ~FAILED, TE, T)
    return Solved(z=Z.reshape(z0.shape), t=t_final.reshape(shape),
                  dt=DTs.reshape(shape), failed=FAILED.reshape(shape),
                  naccept=NACC.reshape(shape), nreject=NREJ.reshape(shape))


# ---------------------------------------------------------------------------
# the deposit
# ---------------------------------------------------------------------------

def normalize_halo(halo):
    if isinstance(halo, int):
        return ((halo, halo), (halo, halo))
    hx, hy = halo
    if isinstance(hx, int):
        return ((hx, hx), (hy, hy))
    return ((int(hx[0]), int(hx[1])), (int(hy[0]), int(hy[1])))


def _cic(pos, lo: int, hi: int):
    lim_lo, lim_hi = -float(lo), float(hi) - 1e-5
    clamped = (pos < lim_lo) | (pos > lim_hi)
    p = torch.clamp(pos, lim_lo, lim_hi)
    f = torch.floor(p)
    frac = p - f
    return f.to(torch.int32), 1.0 - frac, frac, clamped


def deposit(xrel, yrel, charge, active, bx: int, by: int, halo):
    """CIC deposit of ``charge [nx, ny, C]`` from positions relative to the
    home node, clamped into the halo, folded over the boundaries; returns
    (node state ``[nx, ny, C]``, clamped count)."""
    nx, ny, C = charge.shape
    (xl, xh), (yl, yh) = normalize_halo(halo)
    fx, wxf, wxc, cx_cl = _cic(xrel, xl, xh)
    fy, wyf, wyc, cy_cl = _cic(yrel, yl, yh)
    ch = charge * active.to(charge.dtype)[..., None]

    def planes(fi, wf, wc, lo, hi):
        return [torch.where(fi == o, wf, 0.0) + torch.where(fi == o - 1, wc,
                                                              0.0)
                for o in range(-lo, hi + 1)]

    Wx = planes(fx, wxf, wxc, xl, xh)
    Wy = planes(fy, wyf, wyc, yl, yh)
    P = torch.zeros((nx + xl + xh, ny + yl + yh, C), dtype=charge.dtype,
                    device=charge.device)
    for ix, ox in enumerate(range(-xl, xh + 1)):
        for iy, oy in enumerate(range(-yl, yh + 1)):
            w = Wx[ix] * Wy[iy]
            P[xl + ox:xl + ox + nx, yl + oy:yl + oy + ny, :] += w[..., None] * ch
    clamped = int(((cx_cl | cy_cl) & active).sum())
    # x: periodic wrap or drop
    Q = P[xl:xl + nx].clone()
    if bx == PERIODIC:
        if xl:
            Q[nx - xl:] += P[:xl]
        if xh:
            Q[:xh] += P[xl + nx:]
    # y: periodic wrap, drop, or the tripolar north fold (row ny + k onto
    # ny - 1 - k, x mirrored: x' = (nx - 2 - x) mod nx)
    out = Q[:, yl:yl + ny].clone()
    if by == PERIODIC:
        if yl:
            out[:, ny - yl:] += Q[:, :yl]
        if yh:
            out[:, :yh] += Q[:, yl + ny:]
    elif by == TRIPOLAR_NORTH:
        for k in range(yh):
            row = Q[:, yl + ny + k]
            out[:, ny - 1 - k] += torch.roll(torch.flip(row, dims=(0,)), -1,
                                             dims=0)
    return out, clamped


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class State:
    """A member's state: the particle planes, the node state ``S [nx, ny,
    3]`` (E, m_x, m_y), the model clock and the iteration."""

    lne: torch.Tensor
    cgx: torch.Tensor
    cgy: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor
    on: torch.Tensor
    S: torch.Tensor
    time: torch.Tensor
    iteration: int = 0


COUNTS = ("n_active", "tried", "n_failed", "n_nan_reset", "n_inf_reset",
          "n_emax_clamp", "n_relight", "n_gather", "n_reseed", "n_off",
          "n_clamped", "steps")


@dataclasses.dataclass(frozen=True)
class Settings:
    DT: float
    log_energy_maximum: float = math.log(17.0)
    wind_min_squared: float = 4.0
    solver: Solver = Solver()
    halo: object = 3


class Model:
    """The plain step on ``grid`` under ``wind`` (a ``Wind``), periodic
    boundary, windsea seeding and reseeding, boundary type "same", the
    carried dt clipped into [dtmin, DT] by the remesh."""

    def __init__(self, grid: Grid, wind, sett: Settings, dtype=torch.float32,
                 compact: Optional[bool] = None):
        self.grid, self.wind, self.sett = grid, wind, sett
        # the advance's loop gathers its live lanes on the card only
        # (``integrate_to``)
        self.compact = grid.x.is_cuda if compact is None else compact
        self.dtype = dtype
        self.c = rhs_consts()
        self.active = (grid.mask == 1) | (grid.mask == 3)
        self.boundary = grid.mask == 2
        self.min_e, self.min_m2 = minimal_state(2.0, 2.0, sett.DT, dtype)
        self.DT = float(torch.tensor(sett.DT, dtype=dtype))

    def _rhs_for(self, sampler):
        """``rhs_for(idx)``: the right-hand side over the flat lanes
        ``idx``, the wind from the step's ``sampler``."""
        g = self.grid
        flat = [a.reshape(-1) for a in (g.x, g.y, g.pc)]
        M = g.M.reshape(-1, 2, 2)

        def rhs_for(idx):
            x, y, pc = (a[idx] for a in flat)
            return make_rhs(sampler(idx), x, y, M[idx], pc, self.c)

        return rhs_for

    def step(self, s: State, counts: dict) -> State:
        g, sett, DT = self.grid, self.sett, self.DT
        active = self.active
        sampler = self.wind.step_sampler(g.x, g.y, s.time, DT)

        # advance
        adv = s.on & active
        comps0 = (s.lne, s.cgx, s.cgy, s.px, s.py)
        res = integrate_to(self._rhs_for(sampler), torch.stack(comps0, dim=-1),
                           s.t, s.t + DT, s.dt, adv, sett.solver,
                           self.compact)
        failed = res.failed & adv
        lne, cgx, cgy, px, py = (torch.where(adv, res.z[..., i], c0)
                                 for i, c0 in enumerate(comps0))
        t = torch.where(adv, res.t, s.t)
        dt = torch.where(adv, res.dt, s.dt)

        # guards: the re-light samples the wind's interpolant at each off
        # particle's own (lagged) end time
        off = ~s.on & active
        u_end, v_end = winds_at(self.wind.sample, g.x, g.y, s.t + DT,
                                self.dtype)
        relight = off & (u_end * u_end + v_end * v_end
                         >= sett.wind_min_squared)
        guardable = active & ~failed

        def isbad(f):
            return f(lne) | f(cgx) | f(cgy)

        nan_mask = guardable & isbad(torch.isnan)
        inf_mask = guardable & ~nan_mask & isbad(torch.isinf)
        bad = nan_mask | inf_mask
        reset = relight | bad
        lne_r, cgx_r, cgy_r = seed_planes(u_end, v_end, sett.DT)
        lne = torch.where(reset, lne_r, lne)
        cgx = torch.where(reset, cgx_r, cgx)
        cgy = torch.where(reset, cgy_r, cgy)
        px = torch.where(reset, 0.0, px)
        py = torch.where(reset, 0.0, py)
        on = s.on | relight
        emax = guardable & ~bad & (lne > sett.log_energy_maximum)
        lne = torch.where(emax, sett.log_energy_maximum, lne)

        # deposit
        scatter_on = on & active & ~failed
        e, mx, my = particle_to_node(lne, cgx, cgy)
        node, clamped = deposit(px, py, torch.stack([e, mx, my], dim=-1),
                                scatter_on, g.bx, g.by, sett.halo)
        e_n, mx_n, my_n = node[..., 0], node[..., 1], node[..., 2]

        # remesh: the winds at the pre-tick clock
        u, v = winds_at(sampler(None), g.x, g.y, s.time, self.dtype)
        wind2 = u * u + v * v
        m2_n = mx_n * mx_n + my_n * my_n
        part = active
        gather = part & ~self.boundary & (e_n >= self.min_e) & (
            m2_n >= self.min_m2)
        reseed = part & ~gather & (wind2 >= sett.wind_min_squared)
        go_off = part & ~gather & ~reseed
        lne_g, cgx_g, cgy_g = node_to_particle(e_n, mx_n, my_n)
        lne_s, cgx_s, cgy_s = seed_planes(u, v, sett.DT)
        moved = gather | reseed
        dt_r = torch.clamp(dt, sett.solver.dtmin, sett.DT)

        for k, m in (("n_active", adv), ("n_failed", failed),
                     ("n_nan_reset", nan_mask), ("n_inf_reset", inf_mask),
                     ("n_emax_clamp", emax), ("n_relight", relight),
                     ("n_gather", gather), ("n_reseed", reseed),
                     ("n_off", go_off & on)):
            counts[k] += int(m.sum())
        counts["tried"] += int((res.naccept + res.nreject)[adv].sum())
        counts["n_clamped"] += clamped
        counts["steps"] += 1

        return State(
            lne=torch.where(gather, lne_g, torch.where(reseed, lne_s, lne)),
            cgx=torch.where(gather, cgx_g, torch.where(reseed, cgx_s, cgx)),
            cgy=torch.where(gather, cgy_g, torch.where(reseed, cgy_s, cgy)),
            px=torch.where(moved, 0.0, px), py=torch.where(moved, 0.0, py),
            t=t, dt=dt_r, on=torch.where(part, moved, on), S=node,
            time=s.time + DT, iteration=s.iteration + 1)

    def run(self, s: State, n: int, state_round=None) -> Tuple[State, dict]:
        """``n`` steps from ``s``; returns (state, the counts summed over the
        steps).  ``state_round``: a dtype the particle and node state is
        rounded to after each step (the control)."""
        counts = dict.fromkeys(COUNTS, 0)
        for _ in range(n):
            s = self.step(s, counts)
            if state_round is not None:
                s = round_state(s, state_round)
        return s, counts


def round_state(s: State, dtype) -> State:
    """``s`` with its particle values (lne, cgx, cgy, px, py) and node
    state rounded to ``dtype`` and back; the clocks, dt and flags kept."""
    def r(x):
        return x.to(dtype).to(x.dtype)

    return dataclasses.replace(s, lne=r(s.lne), cgx=r(s.cgx), cgy=r(s.cgy),
                               px=r(s.px), py=r(s.py), S=r(s.S))
