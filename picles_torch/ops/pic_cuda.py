"""Wrapper of kernel K2, the boundary-folded CIC deposit as a gather
(``csrc/pic_gather.cu``).

Counterpart of ``picles_tpu/ops/pic_pallas.py`` ``scatter_core_channels_pallas``:
three channel planes in, three node planes out, one pass, no atomics.

- tensors on a card launch the kernel, or raise (no fallback);
- tensors on the CPU run the plain version, ``pic.scatter_dense``.

The kernel wraps periodic axes and drops open ones by indexing; the
tripolar seam is not ported yet.  The count of clamped displacements stays
in PyTorch, with the JAX package's predicate.  ``pic_gather.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..grids.base import Boundary, GridStats
from .pic import ScatterStats, halo_bounds, normalize_halo, scatter_dense


def pic_gather(xrel: torch.Tensor, yrel: torch.Tensor,
               chans: Tuple[torch.Tensor, ...], active: torch.Tensor,
               stats: GridStats, halo
               ) -> Tuple[Tuple[torch.Tensor, ...], ScatterStats]:
    """Deposit (E, m_x, m_y) planes ``[nx, ny]`` of the ``active`` particles
    at relative positions (xrel, yrel) onto the nodes."""
    if xrel.device.type == "cpu":
        S, st = scatter_dense(xrel, yrel, torch.stack(chans, dim=-1), active,
                              stats, halo)
        return tuple(S[..., i] for i in range(len(chans))), st

    from .cuda_build import (check_planes, check_status, library,
                             pointer_array)

    if len(chans) != 3:
        raise ValueError(f"the gather kernel takes 3 channels, got {len(chans)}")
    if Boundary.TRIPOLAR_NORTH in (stats.bx, stats.by):
        raise NotImplementedError(
            "the tripolar seam fold is not in the CUDA deposit yet "
            '(ROADMAP item 12); use scatter_mode="dense"')
    f32 = torch.float32
    ins = [xrel, yrel, *chans, active]
    dev = check_planes(ins, ["xrel", "yrel", "c0", "c1", "c2", "active"],
                       [f32] * 5 + [torch.bool])
    nx, ny = xrel.shape
    if (stats.nx, stats.ny) != (nx, ny):
        raise ValueError(f"planes are {nx}x{ny}, the grid {stats.nx}x{stats.ny}")
    (xl, xh), (yl, yh) = normalize_halo(halo)
    px = stats.bx == Boundary.PERIODIC
    py = stats.by == Boundary.PERIODIC
    if min(xl, xh, yl, yh) < 0 or (px and max(xl, xh) > nx) \
            or (py and max(yl, yh) > ny):
        raise ValueError(f"halo {((xl, xh), (yl, yh))} does not fit a "
                         f"{nx}x{ny} grid")

    x_lo, x_hi = halo_bounds(xl, xh)
    y_lo, y_hi = halo_bounds(yl, yh)
    clamped = torch.sum(((xrel < x_lo) | (xrel > x_hi)
                         | (yrel < y_lo) | (yrel > y_hi)) & active
                        ).to(torch.int32)

    fp = np.asarray([x_lo, x_hi, y_lo, y_hi], dtype=np.float32)
    ip = np.asarray([nx, ny, xl, xh, yl, yh, int(px), int(py)], dtype=np.int32)
    outs = [torch.empty_like(xrel) for _ in range(3)]
    ptrs = pointer_array(ins + outs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = library().picles_pic_gather(fp.ctypes.data, ip.ctypes.data,
                                           ctypes.addressof(ptrs), stream)
    check_status(code, "CIC gather")
    pic_gather.launches += 1
    return tuple(outs), ScatterStats(clamped=clamped)


pic_gather.launches = 0
