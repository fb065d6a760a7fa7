"""Wrappers of kernels K1 (advance) and K3 (auto-dt), ``csrc/advance.cu``.

Counterpart of ``picles_tpu/ops/advance_pallas.py``.  ``advance_cuda`` runs
the whole adaptive embedded-RK loop of one model step per particle;
``auto_dt_cuda`` Hairer's initial-dt estimate.  Each takes the component
planes ``[nx, ny]`` (any shape, all alike, contiguous float32):

- tensors on a card launch the kernel, or raise (no fallback);
- tensors on the CPU run the plain versions, ``tsit5.integrate_to`` and
  ``tsit5.auto_dt``, on the same arguments.

The kernels compile the wind as a ``WindKernel`` descriptor (see
``forcing/winds.py``) and take the projection as the 5 uniform scalars
``(m00, m01, m10, m11, pc)`` of a regular Cartesian grid.  Per-node
projection planes (spherical and tripolar grids) are not ported yet.

``advance_cuda.launches`` and ``auto_dt_cuda.launches`` count kernel
launches (not plain-version calls).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..forcing.winds import WindKernel, Winds2D
from .rhs import RHSConsts, RHSParams, TermFlags, make_rhs
from .tsit5 import METHODS, SolverConfig, auto_dt, integrate_to


class AdvanceResult(NamedTuple):
    lne: torch.Tensor
    cgx: torch.Tensor
    cgy: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor
    failed: torch.Tensor   # bool
    naccept: torch.Tensor  # int32


def flag_bits(flags: TermFlags) -> int:
    """``TermFlags`` as the kernels' bit mask (``TERM_*`` in rhs.cuh)."""
    return (1 * flags.propagation + 2 * flags.input + 4 * flags.dissipation
            + 8 * flags.peak_shift + 16 * flags.direction)


def kernel_wind(winds: Winds2D) -> WindKernel:
    """The wind's kernel descriptor, or raise: any other sampler runs only
    on the plain PyTorch path."""
    if winds.kernel is None:
        raise NotImplementedError(
            "these winds carry no kernel descriptor: only constant_winds, "
            "half_domain_winds and time_cosine_winds run in the CUDA "
            "kernels (gridded winds are ROADMAP item 11); use "
            'advance_mode="torch"')
    return winds.kernel


def _rhs_wind_params(consts: RHSConsts, flags: TermFlags, wind: WindKernel,
                     proj: Sequence[float]) -> Tuple[list, list]:
    """Packed float/int parameters shared by K1 and K3 (the layout of
    ``unpack_rhs_wind`` in advance.cu)."""
    m00, m01, m10, m11, pc = proj
    f = [consts.r_g, consts.C_alpha, consts.C_e, consts.C_varphi, consts.g,
         consts.p, consts.n, consts.e_T, consts.r_g * consts.r_g,
         m00, m01, m10, m11, pc,
         wind.u0, wind.v0, wind.x_split, wind.background, 2.0 * math.pi,
         wind.period, 0.0 if wind.t_off is None else wind.t_off]
    i = [flag_bits(flags), int(wind.kind), int(wind.t_off is not None)]
    return f, i


def _tableau_params(method) -> list:
    c = list(method.c) + [0.0] * (5 - len(method.c))
    a = []
    for r in range(5):
        row = list(method.a[r]) if r < len(method.a) else []
        a += row + [0.0] * (5 - len(row))
    b = list(method.b) + [0.0] * (6 - len(method.b))
    bt = list(method.bt) + [0.0] * (7 - len(method.bt))
    return c + a + b + bt


def _uniform_aux(xn, yn, proj):
    m00, m01, m10, m11, pc = proj
    M = torch.tensor([[m00, m01], [m10, m11]], dtype=xn.dtype,
                     device=xn.device)
    return RHSParams(x=xn, y=yn, M=M,
                     pc=torch.tensor(pc, dtype=xn.dtype, device=xn.device))


def advance_cuda(winds: Winds2D, consts: RHSConsts, flags: TermFlags,
                 config: SolverConfig, DT: float,
                 comps: Tuple[torch.Tensor, ...], t: torch.Tensor,
                 dt: torch.Tensor, active: torch.Tensor, xn: torch.Tensor,
                 yn: torch.Tensor, proj: Tuple[float, ...]) -> AdvanceResult:
    """Advance every active particle over one model step ``DT`` (K1).

    ``comps`` = (lne, cgx, cgy, x, y); ``active`` bool; ``proj`` the 5
    uniform projection scalars.  Inactive lanes pass through with
    ``failed = False`` and ``naccept = 0``; a lane that finishes gets
    ``t = t + DT``."""
    if t.device.type == "cpu":
        res = integrate_to(make_rhs(winds.u, winds.v, consts, flags),
                           torch.stack(comps, dim=-1), t, t + DT, dt,
                           _uniform_aux(xn, yn, proj), active, config)
        return AdvanceResult(*(res.z[..., i] for i in range(5)), t=res.t,
                             dt=res.dt, failed=res.failed,
                             naccept=res.naccept)

    from .cuda_build import (check_planes, check_status, library,
                             pointer_array)

    wind = kernel_wind(winds)
    ins = [*comps, t, dt, active, xn]
    f32 = torch.float32
    dev = check_planes(ins, ["lne", "cgx", "cgy", "x", "y", "t", "dt",
                             "active", "xn"], [f32] * 7 + [torch.bool, f32])
    method = METHODS[config.method]
    f, i = _rhs_wind_params(consts, flags, wind, proj)
    f += [DT, config.abstol, config.reltol, config.dtmin, -1.0 / method.order]
    f += _tableau_params(method)
    i += [len(method.b), int(config.adaptive), int(config.force_dtmin),
          int(config.maxiters)]
    fp = np.asarray(f, dtype=np.float32)
    ip = np.asarray(i, dtype=np.int32)
    outs = [torch.empty_like(t) for _ in range(7)]
    failed = torch.empty(t.shape, dtype=torch.bool, device=dev)
    nacc = torch.empty(t.shape, dtype=torch.int32, device=dev)
    ptrs = pointer_array(ins + outs + [failed, nacc])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = library().picles_advance(fp.ctypes.data, ip.ctypes.data,
                                        ctypes.addressof(ptrs),
                                        t.numel(), stream)
    check_status(code, "advance")
    advance_cuda.launches += 1
    return AdvanceResult(*outs, failed=failed, naccept=nacc)


advance_cuda.launches = 0


def auto_dt_cuda(winds: Winds2D, consts: RHSConsts, flags: TermFlags,
                 t: torch.Tensor, comps: Tuple[torch.Tensor, ...],
                 xn: torch.Tensor, yn: torch.Tensor, proj: Tuple[float, ...],
                 *, abstol: float = 1e-4, reltol: float = 1e-3,
                 order: float = 5.0, max_dt: float = 3600.0) -> torch.Tensor:
    """Hairer's initial-dt estimate per particle (K3); semantics of
    ``tsit5.auto_dt``."""
    if t.device.type == "cpu":
        return auto_dt(make_rhs(winds.u, winds.v, consts, flags), t,
                       torch.stack(comps, dim=-1), _uniform_aux(xn, yn, proj),
                       abstol=abstol, reltol=reltol, order=order,
                       max_dt=max_dt)

    from .cuda_build import (check_planes, check_status, library,
                             pointer_array)

    wind = kernel_wind(winds)
    ins = [*comps, t, xn]
    dev = check_planes(ins, ["lne", "cgx", "cgy", "x", "y", "t", "xn"],
                       [torch.float32] * 7)
    f, i = _rhs_wind_params(consts, flags, wind, proj)
    f += [abstol, reltol, 1.0 / (order + 1.0), max_dt]
    fp = np.asarray(f, dtype=np.float32)
    ip = np.asarray(i, dtype=np.int32)
    out = torch.empty_like(t)
    ptrs = pointer_array(ins + [out])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = library().picles_auto_dt(fp.ctypes.data, ip.ctypes.data,
                                        ctypes.addressof(ptrs),
                                        t.numel(), stream)
    check_status(code, "auto-dt")
    auto_dt_cuda.launches += 1
    return out


auto_dt_cuda.launches = 0


def uniform_projection(proj: torch.Tensor, pc: torch.Tensor
                       ) -> Optional[Tuple[float, ...]]:
    """(m00, m01, m10, m11, pc) when projection and great-circle coefficient
    are the same at every node, else None.  Reads the planes on the host:
    call once at model construction, not per step."""
    pj = proj.reshape(-1, 4).cpu().numpy()
    pcn = pc.reshape(-1).cpu().numpy()
    if np.all(pj == pj[0]) and np.all(pcn == pcn[0]):
        return (float(pj[0, 0]), float(pj[0, 1]), float(pj[0, 2]),
                float(pj[0, 3]), float(pcn[0]))
    return None
