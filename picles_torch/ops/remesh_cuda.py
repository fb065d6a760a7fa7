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
planes of the step arrive as ``wind_fields`` (``advance_cuda.wind_planes``),
and the plain version then samples ``forcing.winds.pwl_winds`` of them.
``remesh_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core import fetch_relations as FR
from ..core.constants import G_GRAVITY
from .advance_cuda import kernel_wind, wind_params, wind_planes
from .remesh import RemeshParams, RemeshResult

SEED_WINDSEA, SEED_FIXED, SEED_SAME = 0, 1, 2
CORE_NAMES = ("lne", "cgx", "cgy", "px", "py", "dt", "on", "active",
              "boundary", "xn")


def _seed(d) -> Tuple[int, list]:
    if d is None:
        return SEED_WINDSEA, [0.0, 0.0, 0.0]
    return SEED_FIXED, [float(v) for v in d]


def remesh_params(p: RemeshParams) -> Tuple[list, list]:
    """The packed float and int parameters of the branch table (the layout
    of ``unpack_remesh`` in remesh.cuh).  The windsea constants are those of
    ``fetch_relations.get_initial_windsea``, in its order of use."""
    wf, wi = wind_params(kernel_wind(p.winds))
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
    from .cuda_build import check_layered

    f32, b = torch.float32, torch.bool
    dev, L = check_layered(planes[:7], CORE_NAMES[:7], [f32] * 6 + [b],
                           planes[7:], CORE_NAMES[7:], [b, b, f32], simple)
    if tuple(planes[0].shape) != tuple(shape):
        raise ValueError(f"particle planes are {tuple(planes[0].shape)}, "
                         f"the node planes {tuple(shape)}")
    if clock.device != dev or clock.dtype != f32 or clock.numel() != 1:
        raise ValueError("the clock must be one float32 value on "
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
    gridded wind's planes of this step.  ``yn`` is not sent to the kernel:
    no analytic wind it compiles varies in y."""
    from .cuda_build import check_planes, check_status, library, pointer_array

    node = tuple(node)
    check_planes(node, ("e", "m_x", "m_y"), [torch.float32] * 3)
    core = [lne, cgx, cgy, px, py, dt, on, active, boundary, xn]
    dev, L = check_core(core, clock, node[0].shape)
    planes = wind_planes(kernel_wind(p.winds), wind_fields, xn)
    f, i = remesh_params(p)
    fp = np.asarray(f, dtype=np.float32)
    ip = np.asarray(i, dtype=np.int32)
    outs = remesh_outputs(lne)
    ptrs = pointer_array([clock, *node, *core, *outs, *planes])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = library().picles_remesh(fp.ctypes.data, ip.ctypes.data,
                                       ctypes.addressof(ptrs), xn.numel(), L,
                                       stream)
    check_status(code, "remesh")
    remesh_cuda.launches += 1
    return RemeshResult(*outs)


remesh_cuda.launches = 0
