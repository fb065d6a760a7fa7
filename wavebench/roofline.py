"""The least time the card could take for a kernel's work, and for the
whole step's: a frozen copy of the port's roofline counts (its
``chip_smoke.py`` ``bound``, ``k1_substep_ops``, ``gridded_wind_ops``,
``k1_bound``, ``deposit_bound``, ``remesh_bound`` and the peaks), with the
work of a run given as totals (live lanes, substeps tried) where the port's
takes tensors; and ``step_work``, the step's necessary work, for
``mfu.step``.

Peaks: NVIDIA H100 SXM at its 700 W limit, dense rates: 3.35 TB/s of HBM,
67 TFLOP/s in float32 outside the tensor cores (a transcendental or a
division counted as one operation)."""

from __future__ import annotations

from .reference import TABLEAUX, normalize_halo

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12
# float operations of one RHS evaluation, every term on: 12 divisions, 6
# transcendentals and square roots, about 84 products, sums, selects and
# clamps
RHS_OPS = 102


def bound(nbytes: float, ops: float, real: int = 4) -> dict:
    """``bound_ms`` (the larger of bytes over the bandwidth and operations
    over the float rate of the lanes' type) and ``bound_by``."""
    rate = FP64_OPS_PER_S if real == 8 else FP32_OPS_PER_S
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations")


def k1_substep_ops(method: str, adaptive: bool, comps: int = 5) -> int:
    """Float operations of one substep of the embedded-RK loop outside the
    RHS: the stage and solution sums, the stage times, and for the adaptive
    controller the error sums, the scaled norm, the square root and the
    step-size update."""
    m = TABLEAUX[method]
    nz_a = sum(1 for row in m.a for x in row if x != 0.0)
    nz_b = sum(1 for x in m.b if x != 0.0)
    per = 1 + 2 * comps
    ops = per * nz_a + 2 * len(m.c) + per * nz_b + 13
    if adaptive:
        ops += (2 * comps * sum(1 for x in m.bt if x != 0.0) + comps
                + 8 * comps + 2 + 15)
    return ops


def gridded_wind_ops(B: int) -> int:
    """Float operations of one evaluation of a window's gridded samplers."""
    return 4 + 6 * B


def k1_bound(n: int, method: str, adaptive: bool, live: float,
             tried: float, n_wf: int = 0, proj: bool = False,
             layers: int = 1, traced_ops: int = 0, real: int = 4) -> dict:
    """K1's bound on one launch over ``n`` particles of which ``live``
    advance, with ``tried`` substeps (accepted or rejected) over the live
    lanes: 33 bytes in and 33 out a particle, the node x or a wind's
    ``n_wf`` planes, per-node projection planes (``proj``); one RHS a live
    particle to start, then S a substep tried, with the substep's own
    operations."""
    S = len(TABLEAUX[method].b)
    rhs = RHS_OPS + traced_ops + (gridded_wind_ops((n_wf - 4) // 3)
                                  if n_wf > 2 else 0)
    ops = (float(live) + S * float(tried)) * rhs \
        + float(tried) * k1_substep_ops(method, adaptive)
    node = real * (n_wf == 0) + 4.0 * n_wf + 5.0 * real * proj + real * (
        traced_ops > 0)
    return bound((14.0 * real + 6.0 + node / layers) * n, ops, real)


def deposit_bound(n_src: int, n_out: int, halo, remesh: bool = False,
                  n_wf: int = 0, layers: int = 1, traced_ops: int = 0,
                  real: int = 4) -> dict:
    """K2/K4/K6 on one launch: per source 5 float planes and the mask and
    about 13 operations; per output node 3 floats and 11 operations a
    window cell; K6 adds the remesh's bytes a node in and out and about 60
    operations, a wind's planes in place of the node x, and a gridded
    wind's samplers' operations."""
    (xl, xh), (yl, yh) = normalize_halo(halo)
    cells = (xl + xh + 1) * (yl + yh + 1)
    plane = real if traced_ops else 4.0
    wind = (plane * n_wf - real) if n_wf else 0.0
    wind += real * (traced_ops > 0)
    node = 2.0 + real + wind
    nbytes = (5.0 * real + 1.0) * n_src + 3.0 * real * n_out + (
        (12.0 * real + 6.0 + node / layers) * n_out if remesh else 0.0)
    ops = 13.0 * n_src + 11.0 * cells * n_out + (60.0 * n_out if remesh
                                                 else 0.0)
    if remesh and n_wf > 2:
        ops += gridded_wind_ops((n_wf - 4) // 3) * n_out
    if remesh:
        ops += traced_ops * n_out
    return bound(nbytes, ops, real)


def remesh_bound(n: int, n_wf: int = 0, layers: int = 1,
                 traced_ops: int = 0, real: int = 4) -> dict:
    """K5: 72 bytes a node (43 in, 29 out) and about 60 operations; a
    wind's planes in place of the node x, and a gridded wind's samplers'
    operations."""
    plane = real if traced_ops else 4.0
    wind = (plane * n_wf - real) if n_wf else 0.0
    wind += real * (traced_ops > 0)
    ops = 60.0 + traced_ops + (gridded_wind_ops((n_wf - 4) // 3)
                               if n_wf > 2 else 0)
    node = 2.0 + real + wind
    return bound((15.0 * real + 6.0 + node / layers) * n, ops * n, real)


def step_work(n: int, method: str, live: float, tried: float,
              wind_values: float = 0.0, B: int = 0, proj: bool = False
              ) -> dict:
    """The necessary work of one step over ``n`` nodes (one particle a
    node), whatever kernels do it, as (bytes, operations, bound_ms):

    - bytes: each particle's values once in and once out (lne, cgx, cgy,
      px, py, t, dt: 7 floats, and its flag: 58 bytes), the node state once
      out (12 bytes; the step reads no node state), the masks (2 bytes),
      the projection and the great-circle coefficient where they vary from
      node to node (``proj``: 20 bytes), and ``wind_values`` record values
      of 4 bytes (the frames the step's window reads, at the record points
      the nodes need);
    - operations: one RHS a live particle to start, S a substep tried
      (with the gridded samplers' operations where ``B`` > 0), each substep's
      own operations (the adaptive controller's included), the CIC deposit
      (13 a particle for its weights, 24 for its 4 corners' 3 channels) and
      the remesh's 60 a node.
    """
    S = len(TABLEAUX[method].b)
    rhs = RHS_OPS + (gridded_wind_ops(B) if B else 0)
    ops = (float(live) + S * float(tried)) * rhs \
        + float(tried) * k1_substep_ops(method, True) \
        + (13.0 + 24.0 + 60.0) * n
    nbytes = (58.0 + 12.0 + 2.0 + 20.0 * proj) * n + 4.0 * wind_values
    out = bound(nbytes, ops)
    out.update(bytes=nbytes, ops=ops)
    return out
