"""Wrappers of kernels K1 (advance) and K3 (auto-dt), ``csrc/advance.cu``,
and K7 (the 1D advance), ``csrc/advance_1d.cu``.

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
``forcing.winds.pwl_winds`` of the same planes.  A steady callable (kind
``NODE``) arrives as its two node planes (u, v; ``WaveGrowth2D.wind_fields``
forms them once per grid), and the plain versions run over
``forcing.winds.node_plane_winds`` of them.  A callable that reads its time
is traced (kind ``TRACED``, ``forcing/wind_trace.py``): the wrappers
launch the entry points of that wind's own library
(``cuda_build.traced_library``), pass the node y plane as its one wind
plane, and its plain versions run over ``TracedWind.winds``.

``advance_1d`` runs the 1D model's whole embedded-RK loop of one step per
particle (K7, the port's own kernel: the JAX package runs that loop as a
``lax.while_loop`` outside Pallas).  Its wind is a steady callable's node
plane ``[nx]``, a ``GriddedWinds1D`` record, or a 1D callable that reads
its time as its traced descriptor (``forcing.winds.traced_kernel_1d``: the
wrapper launches that wind's own library, ``cuda_build.traced_library_1d``,
and counts ``advance_1d.traced_launches``), read at the lane's node.  Its
plain version is ``tsit5.integrate_to`` with ``rhs.particle_equations_1d``
(for the traced kind over ``TracedWind.winds``), which the 1D model runs on
the CPU.

K1, K3 and K7 have a float32 and a float64 instance (the same templates,
``csrc/rhs.cuh``), chosen by the lanes' dtype: float64 lanes launch the
float64 library's entry points (``cuda_build.library_f64``), with the
particle planes, the node x, the projection planes, a steady callable's
node planes and the packed parameters in float64, and a gridded record's
planes float32, as the record gives them; a traced wind's own library is
of its traced dtype (``traced_kernel(..., dtype=)``: a float64 one holds
the double instances).  A plane of another dtype, or a traced wind of
another dtype than the lanes', raises, naming it: nothing is cast, and no
wrapper falls back to a plain version.

``advance_cuda(..., guards=)`` is K1 with its epilogue, the step's
PyTorch glue between the advance and the deposit in the kernel (the
model's fused path: the selects, re-light, NaN and Inf guards, log-energy
clamp, the deposit's mask and channels, and the step's counters added to
one int32 row a layer, ``N_COUNTERS``); ``advance_cuda.epilogue_launches``
counts its launches.

``advance_cuda.launches``, ``auto_dt_cuda.launches`` and
``advance_1d.launches`` count kernel launches (not plain-version calls) of
the float32 instances; ``..._cuda.traced_launches`` and
``advance_1d.traced_launches`` the launches of the float32 traced
instances; ``..._cuda.f64_launches`` and ``advance_1d.f64_launches`` those
of the float64 instances, ``..._cuda.traced_f64_launches`` and
``advance_1d.traced_f64_launches`` those of the float64 traced ones.

K1 runs the tableaux the build compiles into it from ``tsit5.METHODS``
(``cuda_build.tableaux_header``, the methods of ``cuda_build.K1_METHODS``);
a ``SolverConfig`` naming another method is refused.  ``simple=True``
launches the previous kernel instead (K1: the tableau a run-time parameter;
K3: the bare estimate, then PyTorch's clamp and select), the baseline the
card checks hold each kernel to bit for bit; no path of the package passes
it, and its launches are not counted.  Gridded and node winds and
projection planes have no baseline: ``simple=True`` with any raises, as
with a traced wind.  K7's baseline (``advance_1d(..., simple=True)``) is
the previous kernel, compiled beside it for every wind kind.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..forcing.winds import (GriddedWinds1D, WindKernel, WindKind, Winds2D,
                             traced_kernel)
from ..utils import diagnostics
from .remesh import RemeshParams
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


# the step's counters a layer (csrc/remesh.cuh N_COUNTERS): the ten counts
# of models/state.py StepMetrics, then substeps_max
N_COUNTERS = 11


def check_counters(counters: torch.Tensor, layered: bool, L: int,
                   dev) -> None:
    """Raise unless ``counters`` is the step's one contiguous int32 row of
    ``N_COUNTERS`` on ``dev`` (``[L, N_COUNTERS]`` for ``layered`` lanes),
    which the epilogues of K1 and K6 add to."""
    rows = (L, N_COUNTERS) if layered else (N_COUNTERS,)
    c = counters
    if tuple(c.shape) != rows or c.dtype != torch.int32 \
            or not c.is_contiguous() or c.device != dev:
        raise ValueError(f"the counters must be one contiguous int32 {rows} "
                         f"tensor on {dev}, got {c.dtype} {tuple(c.shape)} "
                         f"on {c.device}")


class Guards(NamedTuple):
    """The step's guards that K1's epilogue applies after the advance (the
    model's fused path, ``csrc/advance.cu`` ``guard_lane``).  ``on`` the
    lanes' flags before the step (a lane plane), ``active`` and
    ``boundary`` the node masks (shared by the layers); ``remesh`` gives the
    reseed (its ``defaults``, ``timestep``), ``wind_min_squared`` and
    ``boundary_source``; ``halo`` the deposit's declared halo, whose clamp
    the epilogue tests; ``counters`` int32 ``[N_COUNTERS]`` (``[L,
    N_COUNTERS]`` for layered lanes), zeroed, which K1 adds its counts
    to."""

    on: torch.Tensor
    active: torch.Tensor
    boundary: torch.Tensor
    remesh: RemeshParams
    log_energy_maximum: float
    halo: object
    counters: torch.Tensor


class GuardedAdvance(NamedTuple):
    """K1's results with its epilogue: the guarded particle planes, the
    flags after the re-light, the deposit's mask and its channels."""

    lne: torch.Tensor
    cgx: torch.Tensor
    cgy: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor
    on: torch.Tensor          # bool: on | relight
    scatter_on: torch.Tensor  # bool: the particles the deposit takes
    e: torch.Tensor           # transforms.particle_to_node of the state
    m_x: torch.Tensor
    m_y: torch.Tensor


def flag_bits(flags: TermFlags) -> int:
    """``TermFlags`` as the kernels' bit mask (``TERM_*`` in rhs.cuh)."""
    return (1 * flags.propagation + 2 * flags.input + 4 * flags.dissipation
            + 8 * flags.peak_shift + 16 * flags.direction)


def kernel_wind(winds: Winds2D, device="cpu",
                dtype: torch.dtype = torch.float32) -> WindKernel:
    """The wind's kernel descriptor: its own, or for a callable without one
    the traced kind's, traced on ``device`` in the lanes' ``dtype``
    (``forcing.winds.traced_kernel``; the model gives a steady callable the
    node kind's descriptor instead).  Raises ``NotImplementedError`` for a
    callable the tracer cannot lower."""
    if winds.kernel is None:
        return traced_kernel(winds, device, dtype)
    return winds.kernel


def n_wind_fields(wind: WindKernel) -> int:
    """The count of per-node planes the wind takes: ``4 + 3B`` for a
    gridded wind, 2 (u, v) for the node kind, 1 (the node y) for the
    traced kind, none for an analytic one."""
    if wind.kind == WindKind.GRIDDED:
        return 4 + 3 * wind.n_break
    return {WindKind.NODE: 2, WindKind.TRACED: 1}.get(wind.kind, 0)


def _traced_dtype(traced, dtype: Optional[torch.dtype]) -> None:
    """A traced wind's kernels compute in its traced dtype: lanes of
    another raise."""
    if dtype is not None and traced.dtype != dtype:
        raise TypeError(f"the traced wind was traced in {traced.dtype}: its "
                        f"kernels do not take {dtype} lanes (trace it with "
                        f"the model's dtype)")


def kernel_library(wind: WindKernel, dtype=torch.float32
                   ) -> Tuple[ctypes.CDLL, str]:
    """The loaded library whose entry points run ``wind`` on lanes of
    ``dtype`` and the suffix of their names: a traced wind's own
    (``cuda_build.traced_library``, built at its first launch; its traced
    dtype must be ``dtype``), the float64 library for float64 lanes, else
    the kernels' library."""
    from .cuda_build import library, library_f64, traced_library, \
        traced_suffix

    if wind.kind == WindKind.TRACED:
        _traced_dtype(wind.traced, dtype)
        return traced_library(wind.traced), traced_suffix(wind.traced)
    if dtype == torch.float64:
        return library_f64(), "_f64"
    return library(), ""


def _f32(x: float) -> float:
    return float(np.float32(x))


def wind_params(wind: WindKernel) -> Tuple[list, list]:
    """The wind's packed float and int parameters (``WindParams`` in
    rhs.cuh, in the order ``unpack_wind`` reads them).  The samplers' own
    values (U10, V10, the background, and the time-cosine's 2 pi and
    period, whose amplitude is float32 arithmetic) are float32 values in
    any instance, as the samplers give them; the switch position and the
    cut-off are compared with the node x and the clock in the lanes'
    dtype."""
    f = [_f32(wind.u0), _f32(wind.v0), wind.x_split, _f32(wind.background),
         _f32(2.0 * math.pi), _f32(wind.period),
         0.0 if wind.t_off is None else wind.t_off]
    return f, [int(wind.kind), int(wind.t_off is not None),
               n_wind_fields(wind)]


def wind_planes(wind: WindKernel, fields: Sequence[torch.Tensor],
                like: torch.Tensor, simple: bool = False,
                yn: Optional[torch.Tensor] = None) -> list:
    """The wind's planes as the kernels read them (rhs.cuh
    ``attach_planes``): ``n_wind_fields(wind)`` planes shaped like the node
    plane ``like`` on its device, one after the other in memory, as
    ``pallas_pwl_fields`` (and ``steady_node_planes``) return them, float32
    for a gridded record (in either instance) and of ``like``'s dtype (the
    lanes') for the node kind; other planes are refused.  A traced wind's
    one plane is the node y ``yn`` (``fields`` empty), of ``like``'s
    dtype."""
    from .cuda_build import check_planes

    if wind.kind == WindKind.TRACED:
        if fields:
            raise ValueError("a traced wind takes no wind planes: its "
                             "kernels read the node y")
        if simple:
            raise ValueError("traced winds have no _simple baseline")
        check_planes([like, yn], ["xn", "yn"], [like.dtype] * 2)
        return [yn]
    n = n_wind_fields(wind)
    if len(fields) != n:
        raise ValueError(f"the {wind.kind.name.lower()} wind takes {n} wind "
                         f"planes, got {len(fields)}")
    if not n:
        return []
    if simple:
        raise ValueError(f"{wind.kind.name.lower()} winds have no _simple "
                         "baseline")
    names = ["xn"] + [f"wind plane {k}" for k in range(n)]
    real = torch.float32 if wind.kind == WindKind.GRIDDED else like.dtype
    check_planes([like, *fields], names, [like.dtype] + [real] * n)
    step = like.numel() * fields[0].element_size()
    base = fields[0].data_ptr()
    if any(f.data_ptr() != base + k * step for k, f in enumerate(fields)):
        raise ValueError(f"the wind planes must be views of one contiguous "
                         f"[{n}, ...] tensor, as pallas_pwl_fields and "
                         f"steady_node_planes return them")
    return list(fields)


Projection = Union[Tuple[float, ...], torch.Tensor]


def projection_planes(proj: Projection, like: torch.Tensor,
                      simple: bool = False) -> Optional[torch.Tensor]:
    """None for the 5 uniform scalars, else ``proj`` checked as the kernels
    read it: one contiguous ``[5, *like.shape]`` tensor of the node plane
    ``like``'s dtype (the lanes') on its device (``node_projection``)."""
    if not isinstance(proj, torch.Tensor):
        if len(proj) != 5:
            raise ValueError(f"the uniform projection is 5 scalars (m00, "
                             f"m01, m10, m11, pc), got {len(proj)}")
        return None
    if simple:
        raise ValueError("projection planes have no _simple baseline")
    want = (5,) + tuple(like.shape)
    if tuple(proj.shape) != want or proj.dtype != like.dtype \
            or not proj.is_contiguous() or proj.device != like.device:
        real = str(like.dtype).replace("torch.", "")
        raise ValueError(f"projection planes must be one contiguous {real} "
                         f"{want} tensor on {like.device} (node_projection), "
                         f"got {proj.dtype} {tuple(proj.shape)} on "
                         f"{proj.device}")
    return proj


def node_projection(proj: torch.Tensor, pc: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernels' per-node projection planes of a grid's ``proj [..., 2,
    2]`` and ``pc [...]``: (m00, m01, m10, m11, pc) stacked into one
    contiguous ``[5, ...]`` tensor of the lanes' ``dtype`` on their device
    (float64 lanes: the grid's values, as JAX's float64 step multiplies
    them)."""
    return torch.stack([proj[..., 0, 0], proj[..., 0, 1], proj[..., 1, 0],
                        proj[..., 1, 1], pc]).to(dtype).contiguous()


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


def _guard_params(g: Optional[Guards]) -> Tuple[list, list]:
    """The epilogue's packed floats and ints (advance.cu
    ``unpack_advance``), zeros without it."""
    from .pic import halo_bounds, normalize_halo
    from .remesh_cuda import seed_params, windsea_params

    if g is None:
        return [0.0] * 24, [0, 0]
    kind, seed = seed_params(g.remesh.defaults)
    (xl, xh), (yl, yh) = normalize_halo(g.halo)
    f = (windsea_params(g.remesh.timestep) + seed
         + [g.remesh.wind_min_squared, g.log_energy_maximum,
            *halo_bounds(xl, xh), *halo_bounds(yl, yh)])
    return f, [kind, int(g.remesh.boundary_source)]


def _guard_planes(g: Guards, like: torch.Tensor, xn: torch.Tensor, L: int,
                  dev) -> Tuple[list, list]:
    """The epilogue's planes checked (the lanes' flags like the lanes, the
    masks like the node x, the counters one row a layer): its inputs and
    its new output planes (on, the deposit's mask, e, m_x, m_y)."""
    from .cuda_build import check_layered

    check_layered([like, g.on], ["lne", "on"], [like.dtype, torch.bool],
                  [xn, g.active, g.boundary], ["xn", "active", "boundary"],
                  [xn.dtype, torch.bool, torch.bool])
    check_counters(g.counters, like.dim() > xn.dim(), L, dev)
    flags = [torch.empty(like.shape, dtype=torch.bool, device=dev)
             for _ in range(2)]
    chans = [torch.empty_like(like) for _ in range(3)]
    return [g.on, g.active, g.boundary], flags + chans


def advance_cuda(winds: Winds2D, consts: RHSConsts, flags: TermFlags,
                 config: SolverConfig, DT: float,
                 comps: Tuple[torch.Tensor, ...], t: torch.Tensor,
                 dt: torch.Tensor, active: Optional[torch.Tensor],
                 xn: torch.Tensor, yn: torch.Tensor, proj: Projection, *,
                 wind_fields: Sequence[torch.Tensor] = (),
                 guards: Optional[Guards] = None,
                 simple: bool = False
                 ) -> Union[AdvanceResult, GuardedAdvance]:
    """Advance every active particle over one model step ``DT`` (K1).

    ``comps`` = (lne, cgx, cgy, x, y), ``t``, ``dt`` and ``active`` (bool)
    the particle planes, shaped like ``xn`` or ``[L, *xn.shape]``; ``proj``
    the 5 uniform projection scalars or the per-node planes
    (``node_projection``); ``wind_fields`` a gridded wind's planes of this
    step.  Inactive lanes pass through with ``failed = False`` and
    ``naccept = 0``; a lane that finishes gets ``t = t + DT``.

    With ``guards`` (a wind other than gridded; ``active`` None: K1 advances
    ``guards.on & guards.active``) K1's epilogue applies the step's guards
    and returns a ``GuardedAdvance``, and adds the step's counts to
    ``guards.counters``: ``advance_cuda.epilogue_launches`` counts those
    launches (of every instance)."""
    from .cuda_build import (K1_METHODS, check_layered, check_status,
                             library, packed, pointer_array)

    if config.method not in K1_METHODS:
        raise ValueError(f"the advance kernel compiles the tableaux of "
                         f"{sorted(K1_METHODS)}, not {config.method!r}")
    if (guards is None) == (active is None):
        raise ValueError("pass the advanced lanes `active`, or `guards` "
                         "with active=None (K1 then forms on & active)")
    method = METHODS[config.method]
    ins = [*comps, t, dt, active, xn]
    real = _lanes_dtype(comps[0], simple)
    wind = kernel_wind(winds, xn.device, real)
    lanes = ins[:7] + ([active] if guards is None else [guards.on])
    dev, L = check_layered(lanes, ["lne", "cgx", "cgy", "x", "y", "t", "dt",
                                   "active"], [real] * 7 + [torch.bool],
                           [xn], ["xn"], [real], simple)
    planes = wind_planes(wind, wind_fields, xn, simple, yn)
    pp = projection_planes(proj, xn, simple)
    if guards is not None and (simple or wind.kind == WindKind.GRIDDED):
        raise ValueError("K1's epilogue runs in the kernels' own instances "
                         "of a wind other than gridded")
    f, i = _rhs_wind_params(consts, flags, wind, pp, proj)
    f += [DT, config.abstol, config.reltol, config.dtmin, -1.0 / method.order]
    f += _tableau_params(method)
    i += [len(method.b), int(config.adaptive), int(config.force_dtmin),
          int(config.maxiters)]
    gf, gi = _guard_params(guards)
    fp = packed(f + gf, real)
    ip = np.asarray(i + gi, dtype=np.int32)
    outs = [torch.empty_like(t) for _ in range(7)]
    if guards is None:
        failed = torch.empty(t.shape, dtype=torch.bool, device=dev)
        nacc = torch.empty(t.shape, dtype=torch.int32, device=dev)
        epi = [None] * 9
    else:
        failed = nacc = None
        g_in, g_out = _guard_planes(guards, comps[0], xn, L, dev)
        epi = g_in + g_out + [guards.counters]
    ptrs = pointer_array(ins + outs + [failed, nacc, pp] + epi + planes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if simple:
            code = library().picles_advance_simple(
                fp.ctypes.data, ip.ctypes.data, ctypes.addressof(ptrs),
                xn.numel(), stream)
        else:
            lib, sfx = kernel_library(wind, real)
            code = getattr(lib, "picles_advance" + sfx)(
                fp.ctypes.data, ip.ctypes.data, ctypes.addressof(ptrs),
                xn.numel(), L, stream)
    check_status(code, "advance")
    if not simple:
        _count(advance_cuda, wind.kind == WindKind.TRACED, real)
    if guards is not None:
        advance_cuda.epilogue_launches += 1
        return GuardedAdvance(*outs, *g_out)
    return AdvanceResult(*outs, failed=failed, naccept=nacc)


diagnostics.launch_counters(advance_cuda, "launches", "traced_launches",
                            "f64_launches", "traced_f64_launches",
                            "epilogue_launches")


def _lanes_dtype(lanes: torch.Tensor, simple: bool) -> torch.dtype:
    """The instance a launch runs: its lanes' dtype (float32 or float64;
    the ``_simple`` baselines are float32 only)."""
    from .cuda_build import real_dtype

    real = real_dtype(lanes)
    if simple and real != torch.float32:
        raise ValueError(f"the _simple baselines compute in float32, not "
                         f"{real}")
    return real


def _count(wrapper, traced: bool, real: torch.dtype) -> None:
    """Add one to the wrapper's count of the instance that launched: a
    traced wind's or another, of the lanes' dtype ``real``."""
    if traced and real == torch.float64:
        wrapper.traced_f64_launches += 1
    elif traced:
        wrapper.traced_launches += 1
    elif real == torch.float64:
        wrapper.f64_launches += 1
    else:
        wrapper.launches += 1


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
    from .cuda_build import (check_layered, check_status, library, packed,
                             pointer_array)

    ins = [*comps, t, xn, dt, was_reset]
    real = _lanes_dtype(comps[0], simple)
    wind = kernel_wind(winds, xn.device, real)
    dev, L = check_layered([*comps, t, dt, was_reset],
                           ["lne", "cgx", "cgy", "x", "y", "t", "dt",
                            "was_reset"], [real] * 7 + [torch.bool],
                           [xn], ["xn"], [real], simple)
    planes = wind_planes(wind, wind_fields, xn, simple, yn)
    pp = projection_planes(proj, xn, simple)
    f, i = _rhs_wind_params(consts, flags, wind, pp, proj)
    f += [abstol, reltol, 1.0 / (order + 1.0), max_dt, dtmin, DT]
    fp = packed(f, real)
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
            lib, sfx = kernel_library(wind, real)
            code = getattr(lib, "picles_auto_dt" + sfx)(
                fp.ctypes.data, ip.ctypes.data, ctypes.addressof(ptrs),
                xn.numel(), L, stream)
    check_status(code, "auto-dt")
    if simple:
        return _clamp_select(out, was_reset, dt, dtmin, DT)
    _count(auto_dt_cuda, wind.kind == WindKind.TRACED, real)
    return out


diagnostics.launch_counters(auto_dt_cuda, "launches", "traced_launches",
                            "f64_launches", "traced_f64_launches")


class Advance1DResult(NamedTuple):
    z: torch.Tensor        # [nx, 3] (lne, cg_x, x)
    t: torch.Tensor
    dt: torch.Tensor
    failed: torch.Tensor   # bool
    naccept: torch.Tensor  # int32


Wind1D = Union[torch.Tensor, GriddedWinds1D, WindKernel]


def k7_reciprocals(consts: RHSConsts, dtype: torch.dtype = torch.float32
                   ) -> Tuple[float, float]:
    """1 / r_g and 1 / e_T as K7 takes them: quotients in the lanes'
    ``dtype`` of the constants rounded to it, the bits the card's IEEE
    division gives (ATen's reciprocal of a host scalar, in float64 for
    float64 lanes)."""
    from .cuda_build import REAL_DTYPES

    real = REAL_DTYPES[dtype]
    one = real(1.0)
    return (float(one / real(consts.r_g)), float(one / real(consts.e_T)))


def k7_params(consts: RHSConsts, flags: TermFlags, config: SolverConfig,
              DT: float, kind: WindKind, record: Optional[GriddedWinds1D],
              dtype: torch.dtype = torch.float32
              ) -> Tuple[np.ndarray, np.ndarray]:
    """K7's packed float and int32 parameters (the layout of
    ``advance_1d_entry`` in advance_1d.cu; the floats in the lanes'
    ``dtype``): the 1D RHS constants, the controller, the record's axes
    (zeros but for a gridded wind) and the host's reciprocals
    (``k7_reciprocals``); the flags, the wind kind, the record's shape and
    edge modes, the method's stage count and the controller's switches."""
    from .cuda_build import packed

    method = METHODS[config.method]
    if record is None:
        grid, gf = [1, 1, 0, 0], [0.0, 1.0, 0.0, 1.0]
    else:
        grid = [*record.u_data.shape, int(record.mode == "wrap"),
                int(record.mode_t == "wrap")]
        gf = [record.x0, record.dx, record.t0, record.dt]
    f = [consts.r_g, consts.C_alpha, consts.C_e, consts.g, consts.p,
         consts.n, consts.e_T, 2.0 * consts.n, DT, config.abstol,
         config.reltol, config.dtmin, -1.0 / method.order, *gf,
         *k7_reciprocals(consts, dtype)]
    i = [flag_bits(flags), int(kind), *grid, len(method.b),
         int(config.adaptive), int(config.force_dtmin), int(config.maxiters)]
    return packed(f, dtype), np.asarray(i, dtype=np.int32)


def kernel_library_1d(wind: Wind1D, dtype: Optional[torch.dtype] = None
                      ) -> Tuple[ctypes.CDLL, str]:
    """The loaded library whose ``picles_advance_1d`` entry points run
    ``wind`` on lanes of ``dtype`` and their names' suffix: a traced 1D
    wind's own (``cuda_build.traced_library_1d``, built at its first
    launch; of its traced dtype, which ``dtype`` must be if given), the
    float64 library for float64 lanes, else the kernels' library."""
    from .cuda_build import library, library_f64, traced_library_1d, \
        traced_suffix

    if isinstance(wind, WindKernel):
        _traced_dtype(wind.traced, dtype)
        return traced_library_1d(wind.traced), traced_suffix(wind.traced)
    if dtype == torch.float64:
        return library_f64(), "_f64"
    return library(), ""


def advance_1d(wind: Wind1D, consts: RHSConsts, flags: TermFlags,
               config: SolverConfig, DT: float, z: torch.Tensor,
               t: torch.Tensor, dt: torch.Tensor, active: torch.Tensor,
               xn: torch.Tensor, *, simple: bool = False) -> Advance1DResult:
    """Advance every active 1D particle over one model step ``DT`` (K7).

    ``z [nx, 3]`` (lne, cg_x, x), ``t``, ``dt`` (float32 or float64: the
    lanes' dtype picks the instance) and ``active`` (bool) ``[nx]``,
    contiguous on one card, ``xn`` the node x ``[nx]`` (the lanes' dtype);
    ``wind`` the node plane ``[nx]`` (the lanes' dtype), a
    ``GriddedWinds1D`` record on the same card (float32), or a traced 1D
    wind's descriptor (``traced_kernel_1d``: kind ``TRACED``, traced in the
    lanes' dtype; the lanes read the node x); ``consts`` those of
    ``particle_equations_1d`` (``make_rhs_consts``).  Inactive lanes pass
    through with ``failed = False`` and ``naccept = 0``; a lane that
    finishes gets ``t = t + DT``.  CPU tensors are refused: the plain
    version is ``tsit5.integrate_to`` over ``particle_equations_1d``.
    ``simple=True`` launches the previous kernel, the baseline (float32
    only, not counted)."""
    from .cuda_build import (K1_METHODS, check_planes, check_status,
                             pointer_array, real_dtype)

    if config.method not in K1_METHODS:
        raise ValueError(f"the 1D advance kernel compiles the tableaux of "
                         f"{sorted(K1_METHODS)}, not {config.method!r}")
    f32 = torch.float32
    real = real_dtype(t)
    if simple and real != f32:
        raise ValueError(f"the _simple baseline computes in float32, not "
                         f"{real}")
    traced = isinstance(wind, WindKernel)
    if traced and (wind.kind != WindKind.TRACED or wind.traced is None
                   or not wind.traced.one_d):
        raise ValueError("K7 takes a node plane, a GriddedWinds1D record or "
                         "a traced 1D wind (traced_kernel_1d), not a "
                         f"{wind.kind.name.lower()} descriptor")
    node = not traced and not isinstance(wind, GriddedWinds1D)
    dev = check_planes([t, dt, active, xn] + [wind] * node,
                       ["t", "dt", "active", "xn", "the node wind plane"],
                       [real, real, torch.bool, real, real])
    n = t.numel()
    if t.dim() != 1 or tuple(z.shape) != (n, 3) or z.dtype != real \
            or not z.is_contiguous() or z.device != dev:
        name = str(real).replace("torch.", "")
        raise ValueError(f"z must be one contiguous {name} [{n}, 3] tensor "
                         f"on {dev}, got {z.dtype} {tuple(z.shape)} on "
                         f"{z.device}")
    record = wind if isinstance(wind, GriddedWinds1D) else None
    if record is not None:
        data = record.u_data
        if data.dim() != 2 or data.dtype != f32 or not data.is_contiguous() \
                or data.device != dev or data.numel() == 0:
            raise ValueError(f"the record's u_data must be one contiguous "
                             f"float32 [nx_w, nt_w] tensor on {dev}")
    kind = (WindKind.TRACED if traced else WindKind.NODE if node
            else WindKind.GRIDDED)
    data = None if traced else wind if node else record.u_data
    fp, ip = k7_params(consts, flags, config, DT, kind, record, real)
    z_o = torch.empty_like(z)
    t_o, dt_o = torch.empty_like(t), torch.empty_like(dt)
    failed = torch.empty(t.shape, dtype=torch.bool, device=dev)
    nacc = torch.empty(t.shape, dtype=torch.int32, device=dev)
    ptrs = pointer_array([z, t, dt, active, xn, z_o, t_o, dt_o, failed, nacc,
                          data])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib, sfx = kernel_library_1d(wind, real)
        entry = "picles_advance_1d" + ("_simple" if simple else "") + sfx
        code = getattr(lib, entry)(fp.ctypes.data, ip.ctypes.data,
                                   ctypes.addressof(ptrs), n, stream)
    check_status(code, "1D advance")
    if not simple:
        _count(advance_1d, traced, real)
    return Advance1DResult(z_o, t_o, dt_o, failed, nacc)


diagnostics.launch_counters(advance_1d, "launches", "traced_launches",
                            "f64_launches", "traced_f64_launches")


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
