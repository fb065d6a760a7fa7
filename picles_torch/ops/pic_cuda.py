"""Wrappers of kernels K2, K4 and K6 (``csrc/pic_gather.cu``).

- ``pic_gather`` (K2), counterpart of ``picles_tpu/ops/pic_pallas.py``
  ``scatter_core_channels_pallas``: the boundary-folded CIC deposit as a
  gather, three channel planes in, three node planes out, one pass, no
  atomics.  Plain version: ``pic.scatter_dense``.
- ``pic_gather_padded`` (K4), counterpart of
  ``scatter_padded_channels_pallas``: the same gather into the padded
  ``[nx+xl+xh, ny+yl+yh]`` accumulator with no fold, the local deposit of
  the sharded step (``parallel/sharded.py``).  Plain version:
  ``pic.scatter_accumulate_padded``.
- ``pic_gather_remesh`` (K6), counterpart of ``scatter_remesh_fused``: the
  same deposit with the remesh branch table (K5's) run on each node's sums
  in the same pass, a gridded wind read from its step planes, a steady
  callable from its two node planes (``wind_fields``), a traced one (a
  callable that reads its time) by its own library's entry point at the
  node's x and y.  Plain version: ``pic.scatter_dense``, then
  ``remesh.remesh_core``.

Tensors on a card launch the kernel, or raise: tensors on the CPU are
refused, and the model's device chooses between kernel and plain version.
The source planes may carry a leading layer axis ``[L, nx, ny]`` (wave
systems on one grid): one launch deposits every layer, each layer's sums
bit for bit its own single-layer deposit, and the clamped count is then one
a layer (``[L]``).  K6's masks and node x are ``[nx, ny]``, shared.
The kernels wrap periodic axes, drop open ones and fold the tripolar north
seam by indexing: a source past the top row is a mirrored ghost of a top
row, its offsets (clamped to the declared halo) negated, and on a tripolar
grid the window widens to the symmetric ``max(lo, hi)`` of each axis, as
the JAX package's ``_gather_setup`` widens it.  The TPU kernel clips the
ghosts' offsets to that window once more, which moves the deposit of a
particle clamped at the wider side's bound by 1e-5 of its weight; the
kernels here do not, and deposit as ``pic.scatter_dense`` folds
(``csrc/pic_gather.cu``).  The count of clamped displacements stays in PyTorch, with the JAX
package's predicate on the declared halo, but where K6 runs its epilogue
(``counters=``, the model's fused path: K1 then counts them, the same
predicate in its own epilogue).  ``pic_gather.launches``,
``pic_gather_padded.launches`` and ``pic_gather_remesh.launches`` count
kernel launches, ``pic_gather_remesh.traced_launches`` and
``pic_gather_remesh.traced_f64_launches`` those of K6's float32 and float64
traced instances (a traced wind's library of its traced dtype).

All three share one tiled window sum (``csrc/pic_gather.cu``, its tiling
compiled in), with a float32 and a float64 instance chosen by the planes'
dtype (float64: the float64 library's entry points,
``cuda_build.library_f64``; every plane but the masks and a gridded
record's float32 planes, and the packed parameters, in float64; a plane of
another dtype raises, naming it).  ``pic_gather.f64_launches``,
``pic_gather_padded.f64_launches`` and ``pic_gather_remesh.f64_launches``
count the float64 instances' launches, ``launches`` the float32 ones.  ``simple=True`` launches the previous one-thread-per-node kernel
instead, the baseline the card checks hold the tiled one to bit for bit; no
path of the package passes it, and its launches are not counted.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..grids.base import Boundary, GridStats
from ..utils import diagnostics
from .advance_cuda import _lanes_dtype
from .pic import ScatterStats, halo_bounds, normalize_halo
from .remesh import RemeshParams, RemeshResult


def _deposit_setup(xrel, yrel, chans, active, halo, px=False, py=False,
                   tripolar=False, simple=False):
    """Check the deposit's inputs (``px``/``py``: the axis wraps;
    ``tripolar``: the y axis folds at the north seam, and the window is
    widened); returns (device, packed float parameters: the halo's bounds,
    packed int parameters)."""
    from .cuda_build import check_layered

    if len(chans) != 3:
        raise ValueError(f"the gather kernel takes 3 channels, got {len(chans)}")
    real = _lanes_dtype(xrel, simple)
    dev, L = check_layered([xrel, yrel, *chans, active],
                           ["xrel", "yrel", "c0", "c1", "c2", "active"],
                           [real] * 5 + [torch.bool], (), (), (), simple)
    nx, ny = xrel.shape[-2:]
    (xl, xh), (yl, yh) = normalize_halo(halo)
    # the window: the declared halo, or its symmetric widening
    wx = (max(xl, xh),) * 2 if tripolar else (xl, xh)
    wy = (max(yl, yh),) * 2 if tripolar else (yl, yh)
    if min(xl, xh, yl, yh) < 0 or (px and max(wx) > nx) \
            or ((py or tripolar) and max(wy) > ny):
        raise ValueError(f"halo {((xl, xh), (yl, yh))} does not fit a "
                         f"{nx}x{ny} grid")

    x_lo, x_hi = halo_bounds(xl, xh)
    y_lo, y_hi = halo_bounds(yl, yh)
    return (dev, [x_lo, x_hi, y_lo, y_hi],
            [nx, ny, *wx, *wy, int(px), int(py), int(tripolar), L])


def _clamped(xrel, yrel, active, bounds) -> torch.Tensor:
    """The count of the ``active`` particles displaced past the declared
    halo's ``bounds`` (``_deposit_setup``'s floats), a 0-dim int32 tensor
    or one a layer: the JAX package's predicate."""
    x_lo, x_hi, y_lo, y_hi = bounds
    return torch.sum(((xrel < x_lo) | (xrel > x_hi)
                      | (yrel < y_lo) | (yrel > y_hi)) & active,
                     dim=(-2, -1)).to(torch.int32)


def _gather_setup(xrel, yrel, chans, active, stats: GridStats, halo,
                  simple: bool = False):
    """``_deposit_setup`` for the boundary-folded deposit over the grid of
    ``stats`` (the seam on a ``TRIPOLAR_NORTH`` y axis)."""
    if stats.bx == Boundary.TRIPOLAR_NORTH:
        raise ValueError("the tripolar seam folds the y axis only")
    tripolar = stats.by == Boundary.TRIPOLAR_NORTH
    if tripolar and simple:
        raise ValueError("the _simple baselines have no tripolar seam")
    if (stats.nx, stats.ny) != tuple(xrel.shape[-2:]):
        raise ValueError(f"planes are {tuple(xrel.shape)}, the grid "
                         f"{stats.nx}x{stats.ny}")
    return _deposit_setup(xrel, yrel, chans, active, halo,
                          stats.bx == Boundary.PERIODIC,
                          stats.by == Boundary.PERIODIC, tripolar, simple)


def pic_gather(xrel: torch.Tensor, yrel: torch.Tensor,
               chans: Tuple[torch.Tensor, ...], active: torch.Tensor,
               stats: GridStats, halo, *, simple: bool = False
               ) -> Tuple[Tuple[torch.Tensor, ...], ScatterStats]:
    """Deposit (E, m_x, m_y) planes ``[nx, ny]`` (or ``[L, nx, ny]``) of the
    ``active`` particles at relative positions (xrel, yrel) onto the nodes
    (K2)."""
    from .cuda_build import check_status, library, packed, pointer_array

    dev, f, i = _gather_setup(xrel, yrel, chans, active, stats, halo, simple)
    clamped = _clamped(xrel, yrel, active, f)
    fp = packed(f, xrel.dtype)
    ip = np.asarray(i, dtype=np.int32)
    outs = [torch.empty_like(xrel) for _ in range(3)]
    ptrs = pointer_array([xrel, yrel, *chans, active] + outs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn = (library().picles_pic_gather_simple if simple
              else _entry("picles_pic_gather", xrel.dtype))
        code = fn(fp.ctypes.data, ip.ctypes.data, ctypes.addressof(ptrs),
                  stream)
    check_status(code, "CIC gather")
    if not simple:
        _count(pic_gather, xrel.dtype)
    return tuple(outs), ScatterStats(clamped=clamped)


diagnostics.launch_counters(pic_gather, "launches", "f64_launches")


def pic_gather_padded(xrel: torch.Tensor, yrel: torch.Tensor,
                      chans: Tuple[torch.Tensor, ...], active: torch.Tensor,
                      halo, *, simple: bool = False
                      ) -> Tuple[torch.Tensor, ScatterStats]:
    """Deposit (E, m_x, m_y) planes ``[nx, ny]`` (or ``[L, nx, ny]``) of
    one block into its padded accumulator (K4): returns ``[3, nx+xl+xh,
    ny+yl+yh]`` (``[3, L, ...]``; channel first, each channel contiguous;
    padded node (i, j) is block node (i - xl, j - yl)) and the clamped
    count.  Takes no ``GridStats``: the planes are a block's and nothing
    wraps."""
    from .cuda_build import check_status, library, packed, pointer_array

    dev, f, i = _deposit_setup(xrel, yrel, chans, active, halo,
                               simple=simple)
    clamped = _clamped(xrel, yrel, active, f)
    nx, ny, xl, xh, yl, yh = i[:6]
    fp = packed(f, xrel.dtype)
    ip = np.asarray(i, dtype=np.int32)
    out = torch.empty((3, *xrel.shape[:-2], nx + xl + xh, ny + yl + yh),
                      dtype=xrel.dtype, device=dev)
    ptrs = pointer_array([xrel, yrel, *chans, active, *out])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn = (library().picles_pic_gather_padded_simple if simple
              else _entry("picles_pic_gather_padded", xrel.dtype))
        code = fn(fp.ctypes.data, ip.ctypes.data, ctypes.addressof(ptrs),
                  stream)
    check_status(code, "padded CIC gather")
    if not simple:
        _count(pic_gather_padded, xrel.dtype)
    return out, ScatterStats(clamped=clamped)


diagnostics.launch_counters(pic_gather_padded, "launches", "f64_launches")


def pic_gather_remesh(xrel: torch.Tensor, yrel: torch.Tensor,
                      chans: Tuple[torch.Tensor, ...],
                      scatter_active: torch.Tensor, stats: GridStats, halo,
                      p: RemeshParams, lne, cgx, cgy, px, py, dt, on, active,
                      boundary, xn, yn, clock, *,
                      wind_fields: Sequence[torch.Tensor] = (),
                      counters: Optional[torch.Tensor] = None,
                      simple: bool = False
                      ) -> Tuple[Tuple[torch.Tensor, ...], RemeshResult,
                                 ScatterStats]:
    """The deposit of ``pic_gather`` and the branch table of
    ``remesh.remesh_core`` on its node planes, in one pass (K6).  Returns
    ((e, m_x, m_y), RemeshResult, ScatterStats); the deposit's and the
    particle planes ``[nx, ny]`` or ``[L, nx, ny]``, ``active``,
    ``boundary`` and ``xn`` ``[nx, ny]``; ``wind_fields`` a gridded wind's
    planes of this step or a steady callable's node planes; ``yn`` is sent
    to the kernel for a traced wind only (no analytic wind it compiles
    varies in y).

    With ``counters`` (the step's, after K1's epilogue: ``advance_cuda``
    ``Guards``) K6's epilogue adds n_gather, n_reseed and n_off to them and
    the call returns (the node state ``[..., nx, ny, 3]``, RemeshResult
    without its ``branch``, None): the clamped displacements are K1's
    count.  ``pic_gather_remesh.epilogue_launches`` counts those
    launches."""
    from ..forcing.winds import WindKind
    from .advance_cuda import (check_counters, kernel_library, kernel_wind,
                               wind_planes)
    from .cuda_build import check_status, library, packed, pointer_array
    from .remesh_cuda import check_core, remesh_outputs, remesh_params

    epilogue = counters is not None
    dev, f, i = _gather_setup(xrel, yrel, chans, scatter_active, stats, halo,
                              simple)
    clamped = None if epilogue else _clamped(xrel, yrel, scatter_active, f)
    core = [lne, cgx, cgy, px, py, dt, on, active, boundary, xn]
    dev_, L = check_core(core, clock, xrel.shape, simple)
    if dev_ != dev:
        raise ValueError(f"the particle planes are on {lne.device}, the "
                         f"deposit's on {dev}")
    wind = kernel_wind(p.winds, dev, xrel.dtype)
    planes = wind_planes(wind, wind_fields, xn, simple, yn)
    rf, ri = remesh_params(p, dev, xrel.dtype)
    fp = packed(f + rf, xrel.dtype)
    ip = np.asarray(i + ri, dtype=np.int32)
    outs = remesh_outputs(lne)
    if epilogue:
        if simple:
            raise ValueError("K6's epilogue has no _simple baseline")
        check_counters(counters, xrel.dim() > 2, L, dev)
        state = torch.empty((*xrel.shape, 3), dtype=xrel.dtype, device=dev)
        node, outs[-1] = [None] * 3, None
        epi = [state, counters]
    else:
        node = [torch.empty_like(xrel) for _ in range(3)]
        epi = [None, None]
    ptrs = pointer_array([xrel, yrel, *chans, scatter_active, clock, *core,
                          *node, *outs, *epi, *planes])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if simple:
            fn = library().picles_pic_gather_remesh_simple
        else:
            lib, sfx = kernel_library(wind, xrel.dtype)
            fn = getattr(lib, "picles_pic_gather_remesh" + sfx)
        code = fn(fp.ctypes.data, ip.ctypes.data, ctypes.addressof(ptrs),
                  stream)
    check_status(code, "CIC gather + remesh")
    if not simple:
        if wind.kind == WindKind.TRACED and xrel.dtype == torch.float64:
            pic_gather_remesh.traced_f64_launches += 1
        elif wind.kind == WindKind.TRACED:
            pic_gather_remesh.traced_launches += 1
        else:
            _count(pic_gather_remesh, xrel.dtype)
    if epilogue:
        pic_gather_remesh.epilogue_launches += 1
        return state, RemeshResult(*outs), None
    return tuple(node), RemeshResult(*outs), ScatterStats(clamped=clamped)


diagnostics.launch_counters(pic_gather_remesh, "launches", "traced_launches",
                            "f64_launches", "traced_f64_launches",
                            "epilogue_launches")


def _entry(name: str, dtype: torch.dtype):
    """The deposit entry point ``name`` of the instance of ``dtype``."""
    from .cuda_build import library, library_f64

    if dtype == torch.float64:
        return getattr(library_f64(), name + "_f64")
    return getattr(library(), name)


def _count(wrapper, dtype: torch.dtype) -> None:
    if dtype == torch.float64:
        wrapper.f64_launches += 1
    else:
        wrapper.launches += 1
