"""Wrapper of kernel K5, the remesh branch table (``csrc/remesh.cu``).

Counterpart of ``picles_tpu/ops/remesh_pallas.py`` ``remesh_pallas``: the
node planes after the deposit, the particle planes and the masks in; the
remeshed particle planes, the ``on`` flag and the branch bitfield out, in
one pass.  The deposit's and the particle planes may carry a leading layer
axis ``[L, nx, ny]`` over masks and node x ``[nx, ny]``, which every layer
shares: one launch remeshes every layer.  Tensors on a card launch the
kernel, or raise: tensors on the CPU are refused.  The plain version is
``remesh.remesh_core``; the model's device chooses between them.

The model clock enters as a 0-dim float32 tensor on the card, read by the
kernel, so a step never reads it back to the host.  The winds must carry a
kernel descriptor (``forcing/winds.py`` ``WindKernel``); a gridded wind's
planes of the step, or a steady callable's two node planes, arrive as
``wind_fields`` (``advance_cuda.wind_planes``), and the plain version then
samples ``forcing.winds.pwl_winds`` (``node_plane_winds``) of them.  A
traced wind (a callable that reads its time, kind ``TRACED``) runs the
entry point of its own library (``advance_cuda.kernel_library``), which
reads the node y plane as well, and its plain version samples
``TracedWind.winds``.  K5 has a float32 and a float64 instance (the same
template), chosen by the planes' dtype: float64 planes, clock and node x
launch the float64 library's ``picles_remesh_f64`` (a float64 traced
wind's library ``picles_remesh_traced_f64``), a gridded record's planes
float32 in either, a steady callable's node planes in the lanes' dtype.
``remesh_cuda.launches`` counts the float32 instance's launches,
``remesh_cuda.f64_launches`` the float64 one's,
``remesh_cuda.traced_launches`` and ``remesh_cuda.traced_f64_launches``
those of the float32 and float64 traced instances.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core import fetch_relations as FR
from ..core.constants import G_GRAVITY
from ..forcing.winds import WindKind
from ..utils import diagnostics
from .advance_cuda import (_count, kernel_library, kernel_wind, wind_params,
                           wind_planes)
from .remesh import RemeshParams, RemeshResult

SEED_WINDSEA, SEED_FIXED, SEED_SAME = 0, 1, 2
CORE_NAMES = ("lne", "cgx", "cgy", "px", "py", "dt", "on", "active",
              "boundary", "xn")


def _seed(d) -> Tuple[int, list]:
    if d is None:
        return SEED_WINDSEA, [0.0, 0.0, 0.0]
    return SEED_FIXED, [float(v) for v in d]


def remesh_params(p: RemeshParams, device="cpu",
                  dtype: torch.dtype = torch.float32) -> Tuple[list, list]:
    """The packed float and int parameters of the branch table (the layout
    of ``unpack_remesh`` in remesh.cuh).  The windsea constants are those of
    ``fetch_relations.get_initial_windsea``, in its order of use; a
    callable without a descriptor is traced on ``device`` in the lanes'
    ``dtype``."""
    wf, wi = wind_params(kernel_wind(p.winds, device, dtype))
    windsea = [G_GRAVITY, abs(p.timestep), 0.1,
               FR.DULOV_A * FR.DULOV_XI_0X, 1.0 / (1.0 - FR.DULOV_Q_X),
               3.5, -0.33, 0.033, 0.67, 0.31 * G_GRAVITY ** 2, 2.0, math.pi,
               -4.0, 0.9, 4.0 * math.pi]
    kind, seed = _seed(p.defaults)
    if p.bdefaults == "same":
        bkind, bseed = SEED_SAME, [0.0, 0.0, 0.0]
    else:
        bkind, bseed = _seed(p.bdefaults)
    f = wf + windsea + seed + bseed + [p.minimal_e, p.minimal_m2,
                                       p.wind_min_squared, p.dtmin,
                                       p.timestep]
    i = wi + [kind, bkind, int(p.boundary_source), int(p.clip_dt)]
    return f, i


def check_core(planes: Sequence[torch.Tensor], clock: torch.Tensor,
               shape, simple: bool = False) -> Tuple[torch.device, int]:
    """The particle planes (``CORE_NAMES[:7]``, shaped ``shape``: the node
    state's), the masks and the node x (``[nx, ny]``, shared by the layers)
    and the clock, as the kernels take them; returns (device, layers)."""
    from .advance_cuda import _lanes_dtype
    from .cuda_build import check_layered

    real, b = _lanes_dtype(planes[0], simple), torch.bool
    dev, L = check_layered(planes[:7], CORE_NAMES[:7], [real] * 6 + [b],
                           planes[7:], CORE_NAMES[7:], [b, b, real], simple)
    if tuple(planes[0].shape) != tuple(shape):
        raise ValueError(f"particle planes are {tuple(planes[0].shape)}, "
                         f"the node planes {tuple(shape)}")
    if clock.device != dev or clock.dtype != real or clock.numel() != 1:
        raise ValueError(f"the clock must be one {real} value on "
                         f"{dev}, got {clock.dtype} {tuple(clock.shape)} on "
                         f"{clock.device}")
    return dev, L


def remesh_outputs(like: torch.Tensor) -> list:
    """Empty output planes: lne, cgx, cgy, px, py, dt, on, branch."""
    outs = [torch.empty_like(like) for _ in range(6)]
    outs.append(torch.empty(like.shape, dtype=torch.bool, device=like.device))
    outs.append(torch.empty(like.shape, dtype=torch.int32,
                            device=like.device))
    return outs


def remesh_cuda(p: RemeshParams, node, lne, cgx, cgy, px, py, dt, on,
                active, boundary, xn, yn, clock, *,
                wind_fields: Sequence[torch.Tensor] = ()) -> RemeshResult:
    """The branch table on a card (K5), with the arguments and semantics of
    ``remesh.remesh_core``: ``node`` and the particle planes ``[nx, ny]`` or
    ``[L, nx, ny]``, the masks and ``xn`` ``[nx, ny]``; ``wind_fields`` a
    gridded wind's planes of this step or a steady callable's node
    planes.  ``yn`` is sent to the kernel for a traced wind only (no
    analytic wind it compiles varies in y)."""
    from .cuda_build import check_planes, check_status, packed, pointer_array

    node = tuple(node)
    check_planes(node, ("e", "m_x", "m_y"), [lne.dtype] * 3)
    core = [lne, cgx, cgy, px, py, dt, on, active, boundary, xn]
    dev, L = check_core(core, clock, node[0].shape)
    wind = kernel_wind(p.winds, dev, lne.dtype)
    planes = wind_planes(wind, wind_fields, xn, yn=yn)
    f, i = remesh_params(p, dev, lne.dtype)
    fp = packed(f, lne.dtype)
    ip = np.asarray(i, dtype=np.int32)
    outs = remesh_outputs(lne)
    ptrs = pointer_array([clock, *node, *core, *outs, *planes])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib, sfx = kernel_library(wind, lne.dtype)
        code = getattr(lib, "picles_remesh" + sfx)(
            fp.ctypes.data, ip.ctypes.data, ctypes.addressof(ptrs),
            xn.numel(), L, stream)
    check_status(code, "remesh")
    _count(remesh_cuda, wind.kind == WindKind.TRACED, lne.dtype)
    return RemeshResult(*outs)


diagnostics.launch_counters(remesh_cuda, "launches", "traced_launches",
                            "f64_launches", "traced_f64_launches")
