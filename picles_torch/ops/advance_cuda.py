"""Wrappers of kernels K1 (advance) and K3 (auto-dt), ``csrc/advance.cu``.

Counterpart of ``picles_tpu/ops/advance_pallas.py``.  ``advance_cuda`` runs
the whole adaptive embedded-RK loop of one model step per particle;
``auto_dt_cuda`` the step's dt reset to Hairer's initial-dt estimate, with
the reset's clamp and select in the same kernel.  Each takes the particle
planes (contiguous float32, all alike) and the node x (any shape: ``[nx,
ny]`` on a grid) on a card and launches its kernel, or raises: tensors on
the CPU are refused.  The particle planes are shaped like the node x, or
``[L, *xn.shape]`` for L layers (wave systems on one grid): one launch
then steps every layer, each lane reading the node x, the projection and
the wind planes of its node, which the layers share and which are never
copied per layer.  The plain
versions are ``tsit5.integrate_to`` and ``auto_dt_reset`` (here, over
``tsit5.auto_dt``); the model's resolved modes choose between kernel and
plain version.

The kernels compile the wind as a ``WindKernel`` descriptor (see
``forcing/winds.py``) and take the projection as the 5 uniform scalars
``(m00, m01, m10, m11, pc)`` of a regular Cartesian grid
(``uniform_projection``) or, on spherical and tripolar grids, as one
contiguous ``[5, *shape]`` float32 tensor of per-node planes in the same
order (``node_projection``); each lane reads its own node's values once.
A gridded wind's descriptor carries its breakpoint count B; its values over
the model step arrive as ``wind_fields``, the ``4 + 3B`` planes of
``GriddedWinds2D.pallas_pwl_fields``, and the plain versions then run over
``forcing.winds.pwl_winds`` of the same planes.

``advance_cuda.launches`` and ``auto_dt_cuda.launches`` count kernel
launches (not plain-version calls).

K1 runs the tableaux the build compiles into it from ``tsit5.METHODS``
(``cuda_build.tableaux_header``, the methods of ``cuda_build.K1_METHODS``);
a ``SolverConfig`` naming another method is refused.  ``simple=True``
launches the previous kernel instead (K1: the tableau a run-time parameter;
K3: the bare estimate, then PyTorch's clamp and select), the baseline the
card checks hold each kernel to bit for bit; no path of the package passes
it, and its launches are not counted.  Gridded winds and projection planes
have no baseline: ``simple=True`` with either raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..forcing.winds import WindKernel, WindKind, Winds2D
from .rhs import RHSConsts, TermFlags
from .tsit5 import METHODS, SolverConfig, auto_dt


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
            "half_domain_winds, time_cosine_winds and a GriddedWinds2D "
            'given to the model run in the CUDA kernels; use '
            'advance_mode="torch"')
    return winds.kernel


def n_wind_fields(wind: WindKernel) -> int:
    """The count of per-node planes the wind takes: ``4 + 3B`` for a
    gridded wind, none for an analytic one."""
    return 4 + 3 * wind.n_break if wind.kind == WindKind.GRIDDED else 0


def wind_params(wind: WindKernel) -> Tuple[list, list]:
    """The wind's packed float and int parameters (``WindParams`` in
    rhs.cuh, in the order ``unpack_wind`` reads them)."""
    f = [wind.u0, wind.v0, wind.x_split, wind.background, 2.0 * math.pi,
         wind.period, 0.0 if wind.t_off is None else wind.t_off]
    return f, [int(wind.kind), int(wind.t_off is not None),
               n_wind_fields(wind)]


def wind_planes(wind: WindKernel, fields: Sequence[torch.Tensor],
                like: torch.Tensor, simple: bool = False) -> list:
    """The wind's planes as the kernels read them (rhs.cuh
    ``attach_planes``): ``n_wind_fields(wind)`` float32 planes shaped like
    the node plane ``like`` on its device, one after the other in memory,
    as ``pallas_pwl_fields`` returns them; other planes are refused."""
    from .cuda_build import check_planes

    n = n_wind_fields(wind)
    if len(fields) != n:
        raise ValueError(f"the {wind.kind.name.lower()} wind takes {n} wind "
                         f"planes, got {len(fields)}")
    if not n:
        return []
    if simple:
        raise ValueError("gridded winds have no _simple baseline")
    names = ["xn"] + [f"wind plane {k}" for k in range(n)]
    check_planes([like, *fields], names, [torch.float32] * (n + 1))
    step = like.numel() * like.element_size()
    base = fields[0].data_ptr()
    if any(f.data_ptr() != base + k * step for k, f in enumerate(fields)):
        raise ValueError("the wind planes must be views of one contiguous "
                         "[4 + 3B, ...] tensor, as pallas_pwl_fields returns "
                         "them")
    return list(fields)


Projection = Union[Tuple[float, ...], torch.Tensor]


def projection_planes(proj: Projection, like: torch.Tensor,
                      simple: bool = False) -> Optional[torch.Tensor]:
    """None for the 5 uniform scalars, else ``proj`` checked as the kernels
    read it: one contiguous float32 ``[5, *like.shape]`` tensor on the
    device of the node plane ``like`` (``node_projection``)."""
    if not isinstance(proj, torch.Tensor):
        if len(proj) != 5:
            raise ValueError(f"the uniform projection is 5 scalars (m00, "
                             f"m01, m10, m11, pc), got {len(proj)}")
        return None
    if simple:
        raise ValueError("projection planes have no _simple baseline")
    want = (5,) + tuple(like.shape)
    if tuple(proj.shape) != want or proj.dtype != torch.float32 \
            or not proj.is_contiguous() or proj.device != like.device:
        raise ValueError(f"projection planes must be one contiguous float32 "
                         f"{want} tensor on {like.device} (node_projection), "
                         f"got {proj.dtype} {tuple(proj.shape)} on "
                         f"{proj.device}")
    return proj


def node_projection(proj: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """The kernels' per-node projection planes of a grid's ``proj [..., 2,
    2]`` and ``pc [...]``: (m00, m01, m10, m11, pc) stacked into one
    contiguous float32 ``[5, ...]`` tensor on their device."""
    return torch.stack([proj[..., 0, 0], proj[..., 0, 1], proj[..., 1, 0],
                        proj[..., 1, 1], pc]).to(torch.float32).contiguous()


def _rhs_wind_params(consts: RHSConsts, flags: TermFlags, wind: WindKernel,
                     planes: Optional[torch.Tensor],
                     proj: Projection) -> Tuple[list, list]:
    """Packed float/int parameters shared by K1 and K3 (the layout of
    ``unpack_rhs_wind`` in advance.cu); the scalars are zeros (not read)
    when the projection comes as planes."""
    m00, m01, m10, m11, pc = (0.0,) * 5 if planes is not None else proj
    wf, wi = wind_params(wind)
    f = [consts.r_g, consts.C_alpha, consts.C_e, consts.C_varphi, consts.g,
         consts.p, consts.n, consts.e_T, consts.r_g * consts.r_g,
         m00, m01, m10, m11, pc] + wf
    return f, [flag_bits(flags)] + wi


def _tableau_params(method) -> list:
    c = list(method.c) + [0.0] * (5 - len(method.c))
    a = []
    for r in range(5):
        row = list(method.a[r]) if r < len(method.a) else []
        a += row + [0.0] * (5 - len(row))
    b = list(method.b) + [0.0] * (6 - len(method.b))
    bt = list(method.bt) + [0.0] * (7 - len(method.bt))
    return c + a + b + bt


def advance_cuda(winds: Winds2D, consts: RHSConsts, flags: TermFlags,
                 config: SolverConfig, DT: float,
                 comps: Tuple[torch.Tensor, ...], t: torch.Tensor,
                 dt: torch.Tensor, active: torch.Tensor, xn: torch.Tensor,
                 yn: torch.Tensor, proj: Projection, *,
                 wind_fields: Sequence[torch.Tensor] = (),
                 simple: bool = False) -> AdvanceResult:
    """Advance every active particle over one model step ``DT`` (K1).

    ``comps`` = (lne, cgx, cgy, x, y), ``t``, ``dt`` and ``active`` (bool)
    the particle planes, shaped like ``xn`` or ``[L, *xn.shape]``; ``proj``
    the 5 uniform projection scalars or the per-node planes
    (``node_projection``); ``wind_fields`` a gridded wind's planes of this
    step.  Inactive lanes pass through with ``failed = False`` and
    ``naccept = 0``; a lane that finishes gets ``t = t + DT``."""
    from .cuda_build import (K1_METHODS, check_layered, check_status,
                             library, pointer_array)

    if config.method not in K1_METHODS:
        raise ValueError(f"the advance kernel compiles the tableaux of "
                         f"{sorted(K1_METHODS)}, not {config.method!r}")
    wind = kernel_wind(winds)
    method = METHODS[config.method]
    ins = [*comps, t, dt, active, xn]
    f32 = torch.float32
    dev, L = check_layered(ins[:8], ["lne", "cgx", "cgy", "x", "y", "t", "dt",
                                     "active"], [f32] * 7 + [torch.bool],
                           [xn], ["xn"], [f32], simple)
    planes = wind_planes(wind, wind_fields, xn, simple)
    pp = projection_planes(proj, xn, simple)
    f, i = _rhs_wind_params(consts, flags, wind, pp, proj)
    f += [DT, config.abstol, config.reltol, config.dtmin, -1.0 / method.order]
    f += _tableau_params(method)
    i += [len(method.b), int(config.adaptive), int(config.force_dtmin),
          int(config.maxiters)]
    fp = np.asarray(f, dtype=np.float32)
    ip = np.asarray(i, dtype=np.int32)
    outs = [torch.empty_like(t) for _ in range(7)]
    failed = torch.empty(t.shape, dtype=torch.bool, device=dev)
    nacc = torch.empty(t.shape, dtype=torch.int32, device=dev)
    ptrs = pointer_array(ins + outs + [failed, nacc, pp] + planes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if simple:
            code = library().picles_advance_simple(
                fp.ctypes.data, ip.ctypes.data, ctypes.addressof(ptrs),
                xn.numel(), stream)
        else:
            code = library().picles_advance(
                fp.ctypes.data, ip.ctypes.data, ctypes.addressof(ptrs),
                xn.numel(), L, stream)
    check_status(code, "advance")
    if not simple:
        advance_cuda.launches += 1
    return AdvanceResult(*outs, failed=failed, naccept=nacc)


advance_cuda.launches = 0


def auto_dt_cuda(winds: Winds2D, consts: RHSConsts, flags: TermFlags,
                 t: torch.Tensor, comps: Tuple[torch.Tensor, ...],
                 xn: torch.Tensor, yn: torch.Tensor, proj: Projection,
                 was_reset: torch.Tensor, dt: torch.Tensor, dtmin: float,
                 DT: float, *, abstol: float = 1e-4, reltol: float = 1e-3,
                 order: float = 5.0, max_dt: float = 3600.0,
                 wind_fields: Sequence[torch.Tensor] = (),
                 simple: bool = False) -> torch.Tensor:
    """The step's Hairer dt reset (K3): per lane ``was_reset ?
    clamp(estimate, dtmin, DT) : dt``, the semantics of ``auto_dt_reset``.

    ``was_reset`` bool; a lane that is not reset keeps its ``dt``, bit for
    bit; the particle planes (``t``, ``comps``, ``was_reset``, ``dt``) and
    ``proj`` as ``advance_cuda``'s; ``wind_fields`` a gridded wind's planes
    of this step.
    ``simple=True`` runs the previous kernel (the bare estimate of every
    lane) followed by PyTorch's clamp and select, the baseline the card
    checks hold K3 to."""
    from .cuda_build import (check_layered, check_status, library,
                             pointer_array)

    wind = kernel_wind(winds)
    ins = [*comps, t, xn, dt, was_reset]
    f32 = torch.float32
    dev, L = check_layered([*comps, t, dt, was_reset],
                           ["lne", "cgx", "cgy", "x", "y", "t", "dt",
                            "was_reset"], [f32] * 7 + [torch.bool],
                           [xn], ["xn"], [f32], simple)
    planes = wind_planes(wind, wind_fields, xn, simple)
    pp = projection_planes(proj, xn, simple)
    f, i = _rhs_wind_params(consts, flags, wind, pp, proj)
    f += [abstol, reltol, 1.0 / (order + 1.0), max_dt, dtmin, DT]
    fp = np.asarray(f, dtype=np.float32)
    ip = np.asarray(i, dtype=np.int32)
    out = torch.empty_like(t)
    ptrs = pointer_array(ins + [out, pp] + planes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if simple:
            code = library().picles_auto_dt_simple(
                fp.ctypes.data, ip.ctypes.data, ctypes.addressof(ptrs),
                xn.numel(), stream)
        else:
            code = library().picles_auto_dt(
                fp.ctypes.data, ip.ctypes.data, ctypes.addressof(ptrs),
                xn.numel(), L, stream)
    check_status(code, "auto-dt")
    if simple:
        return _clamp_select(out, was_reset, dt, dtmin, DT)
    auto_dt_cuda.launches += 1
    return out


auto_dt_cuda.launches = 0


def auto_dt_reset(rhs, t: torch.Tensor, z: torch.Tensor, aux,
                  was_reset: torch.Tensor, dt: torch.Tensor, dtmin: float,
                  DT: float, *, abstol: float = 1e-4, reltol: float = 1e-3,
                  order: float = 5.0, max_dt: float = 3600.0) -> torch.Tensor:
    """Plain version of ``auto_dt_cuda``: ``z`` the stacked components
    ``[..., 5]``, ``aux`` the RHS's grid input."""
    est = auto_dt(rhs, t, z, aux, abstol=abstol, reltol=reltol, order=order,
                  max_dt=max_dt)
    return _clamp_select(est, was_reset, dt, dtmin, DT)


def _clamp_select(est, was_reset, dt, dtmin: float, DT: float):
    """The reset applied to an estimate in PyTorch, as the JAX step applies
    it: clamped to [dtmin, DT] where reset, ``dt`` elsewhere."""
    return torch.where(was_reset, torch.clamp(est, dtmin, DT), dt)


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
