"""Batched adaptive embedded-RK integrator (PyTorch port of
``picles_tpu/ops/tsit5.py``).

``integrate_to`` is the plain version of kernel K1 (``csrc/advance.cu``,
``advance_kernel``) and ``auto_dt`` that of kernel K3 (``auto_dt_kernel``).
Every lane carries its own clock ``t``, step ``dt`` and done/failed flags;
finished lanes are masked out.  The loop runs until every lane is done,
which this twin checks on the host each iteration (the CUDA kernel runs one
thread per lane and never leaves the device).

Kept from the JAX package: landing exactly on ``t_end``, ``dtmin`` /
``force_dtmin``, ``maxiters``, the spacing-aware floor
``max(dtmin, 4 eps max(|t|, |t_end|))`` (a forced step below ulp(t) could
not advance a float32 clock), fixed-substep mode (``adaptive=False``) and
the final snap of ``t`` onto ``t_end``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch


class RKMethod(NamedTuple):
    """Explicit embedded RK tableau with the FSAL property: ``c``/``a`` define
    stages 2..S, ``b`` the solution weights over stages 1..S and
    ``bt = b - bhat`` the error weights over stages 1..S plus the FSAL
    evaluation."""

    name: str
    c: Tuple[float, ...]
    a: Tuple[Tuple[float, ...], ...]
    b: Tuple[float, ...]
    bt: Tuple[float, ...]
    order: float


# Tsitouras 2011 (the Tsit5 tableau of OrdinaryDiffEq.jl)
TSIT5 = RKMethod(
    name="tsit5",
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
    order=5.0)

# Bogacki-Shampine 3(2): 3 fresh RHS evaluations per substep
BOSH3 = RKMethod(
    name="bosh3",
    c=(0.5, 0.75),
    a=((0.5,), (0.0, 0.75)),
    b=(2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0),
    bt=(2.0 / 9.0 - 7.0 / 24.0, 1.0 / 3.0 - 1.0 / 4.0,
        4.0 / 9.0 - 1.0 / 3.0, -1.0 / 8.0),
    order=3.0)

METHODS = {"tsit5": TSIT5, "bosh3": BOSH3}

_SAFETY = 0.9
_QMIN = 0.2
_QMAX = 10.0
_ORDER = 5.0


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver knobs.  ``adaptive=False``: fixed sub-steps of the
    carried dt (clipped to land on t_end), no error control."""

    abstol: float = 1e-4
    reltol: float = 1e-3
    dtmin: float = 1e-4
    force_dtmin: bool = True
    maxiters: int = 10_000
    method: str = "tsit5"
    adaptive: bool = True


class SolveResult(NamedTuple):
    z: torch.Tensor          # [..., D] final state
    t: torch.Tensor          # [...] final time (t_end where not failed)
    dt: torch.Tensor         # [...] next sub-step
    failed: torch.Tensor     # [...] bool
    naccept: torch.Tensor    # [...] int32 accepted substeps
    nreject: torch.Tensor    # [...] int32 rejected substeps


def _rms(x):
    # summed in order and divided by n, as the kernels do (torch.mean
    # multiplies by 1/n, which can differ in the last ulp)
    s = x[..., 0] * x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i] * x[..., i]
    return torch.sqrt(s / x.shape[-1])


def _error_norm(err, z0, z1, abstol, reltol):
    """The scaled RMS norm of an error estimate over the last axis, as
    the JAX package writes it (``torch.mean``; the integrator's loop sums
    in order, ``_rms``)."""
    sc = abstol + reltol * torch.maximum(torch.abs(z0), torch.abs(z1))
    return torch.sqrt(torch.mean((err / sc) ** 2, dim=-1))


def rk_step(method: RKMethod, rhs: Callable, t, z, dt, aux, k1=None):
    """One embedded-RK step for all lanes: (z_new, error_estimate, k_fsal)."""
    dt_ = dt[..., None]
    if k1 is None:
        k1 = rhs(t, z, aux)
    ks = [k1]
    for ci, row in zip(method.c, method.a):
        acc = z
        for aij, kj in zip(row, ks):
            if aij != 0.0:
                acc = acc + dt_ * aij * kj
        ks.append(rhs(t + ci * dt, acc, aux))
    z_new = z
    for bi, ki in zip(method.b, ks):
        if bi != 0.0:
            z_new = z_new + dt_ * bi * ki
    ks.append(rhs(t + dt, z_new, aux))  # FSAL
    err = torch.zeros_like(z)
    for bti, ki in zip(method.bt, ks):
        if bti != 0.0:
            err = err + bti * ki
    return z_new, dt_ * err, ks[-1]


def tsit5_step(rhs: Callable, t, z, dt, aux, k1=None):
    """One Tsit5 step (``rk_step`` with the Tsit5 tableau)."""
    return rk_step(TSIT5, rhs, t, z, dt, aux, k1=k1)


def auto_dt(rhs: Callable, t, z, aux, *, abstol: float = 1e-4,
            reltol: float = 1e-3, order: float = _ORDER,
            max_dt: float = 3600.0) -> torch.Tensor:
    """Hairer's automatic initial step size, per lane (plain version of K3)."""
    tiny = 1e-10
    sc = abstol + torch.abs(z) * reltol
    f0 = rhs(t, z, aux)
    d0 = _rms(z / sc)
    d1 = _rms(f0 / sc)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6,
                     0.01 * d0 / torch.clamp(d1, min=tiny))

    z1 = z + h0[..., None] * f0
    f1 = rhs(t + h0, z1, aux)
    d2 = _rms((f1 - f0) / sc) / torch.clamp(h0, min=tiny)

    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15,
                     torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / torch.clamp(dmax, min=tiny)) ** (1.0 / (order + 1.0)))
    return torch.clamp(torch.minimum(100.0 * h0, h1), max=max_dt)


def integrate_to(rhs: Callable, z0: torch.Tensor, t0: torch.Tensor,
                 t_end: torch.Tensor, dt0: torch.Tensor, aux,
                 active: torch.Tensor, config: SolverConfig) -> SolveResult:
    """Advance every active lane from ``t0`` to ``t_end`` (plain version of
    K1).  Inactive lanes pass through untouched."""
    dtype = z0.dtype
    method = METHODS[config.method]
    t0 = torch.as_tensor(t0, dtype=dtype)
    t_end = torch.broadcast_to(torch.as_tensor(t_end, dtype=dtype), t0.shape)
    dt = torch.clamp(torch.as_tensor(dt0, dtype=dtype), min=config.dtmin)
    eps4 = 4.0 * torch.finfo(dtype).eps

    z, t = z0, t0
    k1 = rhs(t0, z0, aux)
    done = (~active) | (t0 >= t_end)
    failed = torch.zeros_like(done)
    naccept = torch.zeros(t0.shape, dtype=torch.int32, device=t0.device)
    nreject = torch.zeros_like(naccept)
    iters = 0
    while iters < config.maxiters and not bool(done.all()):
        live = ~done
        remaining = t_end - t
        dtmin_eff = torch.clamp(
            eps4 * torch.maximum(torch.abs(t), torch.abs(t_end)),
            min=config.dtmin)
        dt_try = torch.minimum(torch.maximum(dt, dtmin_eff),
                               torch.maximum(remaining, dtmin_eff))
        # as the JAX package writes it (in float32 the product is dtmin_eff)
        at_dtmin = dt_try <= dtmin_eff * (1.0 + 1e-8)

        z_new, err, k_fsal = rk_step(method, rhs, t, z, dt_try, aux, k1=k1)
        if config.adaptive:
            sc = config.abstol + config.reltol * torch.maximum(
                torch.abs(z), torch.abs(z_new))
            enorm = _rms(err / sc)
            finite = torch.isfinite(z_new).all(dim=-1) & torch.isfinite(enorm)

            accept = (enorm <= 1.0) & finite
            if config.force_dtmin:
                accept = accept | at_dtmin
            newly_failed = live & at_dtmin & ~accept

            enorm_safe = torch.clamp(enorm, min=1e-10)
            q = _SAFETY * enorm_safe ** (-1.0 / method.order)
            q = torch.where(finite, q, _QMIN)
            factor = torch.clamp(q, _QMIN, _QMAX)
            dt_next = torch.where(
                accept, dt_try * factor,
                torch.maximum(dt_try * torch.clamp(q, _QMIN, 1.0), dtmin_eff))
        else:
            accept = torch.ones_like(done)
            newly_failed = torch.zeros_like(done)
            dt_next = dt

        upd = live & accept
        t = torch.where(upd, t + dt_try, t)
        z = torch.where(upd[..., None], z_new, z)
        dt = torch.where(live, dt_next, dt)
        k1 = torch.where(upd[..., None], k_fsal, k1)
        done = done | (live & (t >= t_end - 1e-9)) | newly_failed
        failed = failed | newly_failed
        naccept = naccept + upd.to(torch.int32)
        nreject = nreject + (live & ~accept).to(torch.int32)
        iters += 1

    failed = failed | (~done & active)
    t_final = torch.where(active & ~failed, t_end, t)
    return SolveResult(z=z, t=t_final, dt=dt, failed=failed,
                       naccept=naccept, nreject=nreject)
