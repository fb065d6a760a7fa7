"""Particle-in-Cell deposit (PyTorch port of ``picles_tpu/ops/pic.py``, 2D).

``scatter_dense`` is the plain version of kernel K2 (``csrc/pic_gather.cu``):
every particle lives at its home node and deposits CIC weights on the 4
nodes around its relative position, clamped into a static halo.  The
deposit is a sum of (xl+xh+1)(yl+yh+1) statically shifted dense adds into a
padded accumulator, followed by the boundary fold: periodic wrap,
non-periodic drop, tripolar north-seam flip.  No scatter, deterministic.

``scatter_xla`` is the index-arithmetic oracle (no halo bound), kept under
the JAX package's mode name.

Every function takes a leading layer axis (``[L, nx, ny]`` planes, ``[L,
nx, ny, C]`` charges, several wave systems on one grid) and deposits each
layer as it deposits one: the elementwise sums broadcast over it, the
oracle loops over it, and the clamped count is one a layer.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..grids.base import Boundary, GridStats


class ScatterStats(NamedTuple):
    clamped: torch.Tensor  # int32: particles whose displacement hit the halo


def normalize_halo(halo) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Normalize a halo spec to ``((x_lo, x_hi), (y_lo, y_hi))``; an int H is
    the symmetric ``((H, H), (H, H))``.  Displacements are clamped into
    ``[-lo, hi)`` per axis and counted in ``ScatterStats.clamped``."""
    if isinstance(halo, int):
        return ((halo, halo), (halo, halo))
    hx, hy = halo
    if isinstance(hx, int):
        return ((hx, hx), (hy, hy))
    return ((int(hx[0]), int(hx[1])), (int(hy[0]), int(hy[1])))


def halo_max(halo) -> int:
    """The widest of a halo's four bounds."""
    (xl, xh), (yl, yh) = normalize_halo(halo)
    return max(xl, xh, yl, yh)


def halo_bounds(lo: int, hi: int) -> Tuple[float, float]:
    """The clamp range ``[-lo, hi - 1e-5]`` of one axis, as the JAX package
    forms it (in float64, then rounded to float32 where it meets a plane)."""
    return -float(lo), float(hi) - 1e-5


def cic_weights(pos: torch.Tensor, halo):
    """Floor offset, (floor, ceil) weights and clamp flag of a relative
    position clamped into the halo range."""
    lo, hi = (halo, halo) if isinstance(halo, int) else halo
    lim_lo, lim_hi = halo_bounds(lo, hi)
    clamped = (pos < lim_lo) | (pos > lim_hi)
    p = torch.clamp(pos, lim_lo, lim_hi)
    f = torch.floor(p)
    frac = p - f
    return f.to(torch.int32), 1.0 - frac, frac, clamped


def _weight_planes(fi, w_floor, w_ceil, lo: int, hi: int):
    """W[o] = w_floor [fi == o] + w_ceil [fi == o - 1] for o in [-lo, hi]."""
    return [torch.where(fi == o, w_floor, 0.0)
            + torch.where(fi == o - 1, w_ceil, 0.0)
            for o in range(-lo, hi + 1)]


def scatter_accumulate_padded(xrel, yrel, charge, active, halo):
    """Accumulate CIC contributions into ``[..., nx+xl+xh, ny+yl+yh, C]``;
    ``active`` zeroes particles that do not deposit."""
    *lead, nx, ny, C = charge.shape
    (xl, xh), (yl, yh) = normalize_halo(halo)
    fx, wxf, wxc, cx_cl = cic_weights(xrel, (xl, xh))
    fy, wyf, wyc, cy_cl = cic_weights(yrel, (yl, yh))
    ch = charge * active.to(charge.dtype)[..., None]

    Wx = _weight_planes(fx, wxf, wxc, xl, xh)
    Wy = _weight_planes(fy, wyf, wyc, yl, yh)

    P = torch.zeros((*lead, nx + xl + xh, ny + yl + yh, C),
                    dtype=charge.dtype, device=charge.device)
    for ix, ox in enumerate(range(-xl, xh + 1)):
        for iy, oy in enumerate(range(-yl, yh + 1)):
            w = Wx[ix] * Wy[iy]
            P[..., xl + ox:xl + ox + nx, yl + oy:yl + oy + ny, :] += (
                w[..., None] * ch)
    clamped = torch.sum((cx_cl | cy_cl) & active, dim=(-2, -1)
                        ).to(torch.int32)
    return P, ScatterStats(clamped=clamped)


def fold_padded_x(P, bx: Boundary, halo):
    """Fold the x halo slabs of a padded array: periodic wrap or drop."""
    (xl, xh), _ = normalize_halo(halo)
    nx = P.shape[-3] - xl - xh
    core = P[..., xl:xl + nx, :, :].clone()
    if bx == Boundary.PERIODIC:
        if xl:
            core[..., nx - xl:, :, :] += P[..., :xl, :, :]
        if xh:
            core[..., :xh, :, :] += P[..., xl + nx:, :, :]
    elif bx != Boundary.NONPERIODIC:
        raise ValueError("tripolar fold applies to the y axis only")
    return core


def _tripolar_flip_x(row):
    """x' = (nx - 2 - x) mod nx of a ``[..., nx, C]`` row: reverse, then
    roll by -1."""
    return torch.roll(torch.flip(row, dims=(-2,)), -1, dims=-2)


def fold_padded_y(Q, by: Boundary, halo):
    """Fold the y halo slabs: periodic wrap, drop, or tripolar north fold."""
    _, (yl, yh) = normalize_halo(halo)
    ny = Q.shape[-2] - yl - yh
    core = Q[..., yl:yl + ny, :].clone()
    if by == Boundary.PERIODIC:
        if yl:
            core[..., ny - yl:, :] += Q[..., :yl, :]
        if yh:
            core[..., :yh, :] += Q[..., yl + ny:, :]
    elif by == Boundary.TRIPOLAR_NORTH:
        # south halo dropped; north halo row ny + k folds onto ny - 1 - k
        # with x flipped
        for k in range(yh):
            core[..., ny - 1 - k, :] += _tripolar_flip_x(
                Q[..., yl + ny + k, :])
    return core


def scatter_dense(xrel, yrel, charge, active, stats: GridStats, halo):
    """Full dense scatter (plain version of K2): accumulate padded, fold x
    then y.  ``charge`` is ``[nx, ny, C]`` or ``[L, nx, ny, C]``."""
    P, st = scatter_accumulate_padded(xrel, yrel, charge, active, halo)
    Q = fold_padded_x(P, stats.bx, halo)
    return fold_padded_y(Q, stats.by, halo), st


def scatter_xla(xrel, yrel, charge, active, stats: GridStats, halo=0):
    """Index-arithmetic scatter-add oracle, no halo bound (``halo`` is
    accepted for signature parity).  On a card ``index_add_`` sums in no
    fixed order, so this oracle is not bitwise reproducible there."""
    if charge.dim() == 4:   # layers, one after the other
        outs = [scatter_xla(*a, stats, halo)
                for a in zip(xrel, yrel, charge, active)]
        return (torch.stack([o[0] for o in outs]),
                ScatterStats(clamped=torch.stack([o[1].clamped
                                                  for o in outs])))
    nx, ny, C = charge.shape
    dev = charge.device
    ii = torch.arange(nx, device=dev, dtype=torch.int64)[:, None]
    jj = torch.arange(ny, device=dev, dtype=torch.int64)[None, :]

    fx = torch.floor(xrel).to(torch.int64)
    fy = torch.floor(yrel).to(torch.int64)
    wxc = xrel - torch.floor(xrel)
    wyc = yrel - torch.floor(yrel)
    act = active.to(charge.dtype)

    S = torch.zeros((nx * ny, C), dtype=charge.dtype, device=dev)
    for cx in (0, 1):
        for cy in (0, 1):
            gx = ii + fx + cx
            gy = jj + fy + cy
            w = ((1.0 - wxc if cx == 0 else wxc)
                 * (1.0 - wyc if cy == 0 else wyc)) * act
            keep = torch.ones_like(w, dtype=torch.bool)
            if stats.bx == Boundary.PERIODIC:
                gx = torch.remainder(gx, nx)
            else:
                keep &= (gx >= 0) & (gx < nx)
            if stats.by == Boundary.PERIODIC:
                gy = torch.remainder(gy, ny)
            elif stats.by == Boundary.NONPERIODIC:
                keep &= (gy >= 0) & (gy < ny)
            else:  # TRIPOLAR_NORTH (x periodic, already wrapped)
                keep &= gy >= 0
                over = gy > ny - 1
                gx = torch.where(over, torch.remainder(nx - 2 - gx, nx), gx)
                gy = torch.where(over, 2 * ny - 1 - gy, gy)
            w = torch.where(keep, w, 0.0)
            gx = torch.clamp(gx, 0, nx - 1)
            gy = torch.clamp(gy, 0, ny - 1)
            flat = (gx * ny + gy).reshape(-1)
            S.index_add_(0, flat, (w[..., None] * charge).reshape(-1, C))
    return (S.reshape(nx, ny, C),
            ScatterStats(clamped=torch.zeros((), dtype=torch.int32,
                                             device=dev)))


def scatter(xrel, yrel, charge, active, stats: GridStats, halo,
            mode: str = "dense"):
    """Deposit a stacked charge ``[nx, ny, C]`` (``[L, nx, ny, C]``);
    returns (node state ``[..., C]``, stats).

    ``mode``: "dense" (the plain pad-and-fold version), "dense_cuda"
    (kernel K2, ``pic_cuda.pic_gather``: three channels, CUDA tensors; it
    raises on the CPU) or "xla" (the oracle); the JAX package's
    "dense_pallas" names K2 too."""
    from ..convert import _MODES

    if mode == "dense_pallas":
        mode = _MODES[mode]
    if mode == "dense_cuda":
        from .pic_cuda import pic_gather

        # the kernel reads contiguous channel planes
        planes, st = pic_gather(xrel, yrel,
                                tuple(c.contiguous() for c in charge.unbind(-1)),
                                active, stats, halo)
        return torch.stack(planes, dim=-1), st
    if mode == "dense":
        return scatter_dense(xrel, yrel, charge, active, stats, halo)
    if mode == "xla":
        return scatter_xla(xrel, yrel, charge, active, stats, halo)
    raise ValueError(f"unknown scatter mode {mode!r}")


def scatter_channels(xrel, yrel, chans: Tuple[torch.Tensor, ...], active,
                     stats: GridStats, halo, mode: str = "dense"):
    """Deposit per-channel ``[nx, ny]`` planes; returns (planes, stats).

    ``mode``: "dense" (the plain pad-and-fold version), "dense_cuda" (kernel
    K2 through ``pic_cuda.pic_gather``) or "xla" (the oracle)."""
    if mode == "dense_cuda":
        from .pic_cuda import pic_gather

        return pic_gather(xrel, yrel, chans, active, stats, halo)
    if mode == "dense":
        S, st = scatter_dense(xrel, yrel, torch.stack(chans, dim=-1), active,
                              stats, halo)
    elif mode == "xla":
        S, st = scatter_xla(xrel, yrel, torch.stack(chans, dim=-1), active,
                            stats, halo)
    else:
        raise ValueError(f"unknown scatter mode {mode!r}")
    return tuple(S[..., i] for i in range(len(chans))), st


# ---------------------------------------------------------------------------
# 1D deposit from absolute positions
# ---------------------------------------------------------------------------

def segment_sum(keys: torch.Tensor, vals: torch.Tensor, n: int
                ) -> torch.Tensor:
    """``S[k] = sum(vals[i] for keys[i] == k)`` for k in [0, n), ``vals
    [M, C]``, with no atomics: the rows are sorted by key (stably), each
    run of one key is summed by a segmented inclusive scan (Hillis-Steele,
    ceil(log2 M) rounds of shifted adds, each within its run), and each
    run's last row is its sum.  So the order of every sum is fixed by the
    keys' order alone, and two runs on any device agree bit for bit.
    Every key lies in [0, n)."""
    M, C = vals.shape
    order = torch.argsort(keys, stable=True)
    k = keys[order]
    x = vals[order]
    s = 1
    while s < M:
        same = (k[s:] == k[:-s])[:, None]
        x[s:] += torch.where(same, x[:-s], 0.0)
        s *= 2
    last = torch.ones_like(k, dtype=torch.bool)
    last[:-1] = k[1:] != k[:-1]
    # every row but its run's last lands in a spill row n, cut off
    idx = torch.where(last, k, n)
    S = torch.zeros((n + 1, C), dtype=vals.dtype, device=vals.device)
    S.scatter_(0, idx[:, None].expand(M, C), x)
    return S[:n]


def scatter_1d_add(xabs: torch.Tensor, charge: torch.Tensor,
                   active: torch.Tensor, xmin: float, dx: float, nx: int,
                   periodic: bool) -> torch.Tensor:
    """Additive 1D CIC deposit of ``charge [..., C]`` from absolute
    positions ``xabs [...]`` onto ``[nx, C]`` nodes at ``xmin + i dx``:
    each particle puts (1 - w, w) of its charge on nodes (floor, floor +
    1) of ``(x - xmin) / dx``, wrapped when ``periodic``, dropped past an
    open edge; inactive particles deposit 0 times their charge.  The sums
    are ``segment_sum``'s: deterministic on the card (the JAX package's
    ``S.at[g].add`` sums in lane order; an ``index_add_`` on the card would
    sum in no fixed order)."""
    C = charge.shape[-1]
    xn = (xabs - xmin) / torch.full((), dx, dtype=xabs.dtype,
                                    device=xabs.device)
    fl = torch.floor(xn)
    f = fl.to(torch.int64)
    wc = xn - fl
    act = active.to(charge.dtype)
    keys, vals = [], []
    for c in (0, 1):
        g = f + c
        w = (1.0 - wc if c == 0 else wc) * act
        if periodic:
            g = torch.remainder(g, nx)
        else:
            w = torch.where((g >= 0) & (g < nx), w, 0.0)
            g = torch.clamp(g, 0, nx - 1)
        keys.append(g.reshape(-1))
        vals.append((w[..., None] * charge).reshape(-1, C))
    return segment_sum(torch.cat(keys), torch.cat(vals), nx)


def merge_2d_angle(grid_point: torch.Tensor,
                   charge: torch.Tensor) -> torch.Tensor:
    """The angle-based 2D merge rule, elementwise over ``[..., 3]`` (e,
    m_x, m_y): add where the momenta are within 60 degrees of each other
    (or either is 0), else keep the side with more energy.  No deposit
    uses it (the 2D deposit adds), as in the JAX package, which corrects
    the Julia source's cos-angle numerator and its dead replace branch."""
    gE, gx, gy = grid_point[..., 0], grid_point[..., 1], grid_point[..., 2]
    cE, cx, cy = charge[..., 0], charge[..., 1], charge[..., 2]
    gn = torch.sqrt(gx ** 2 + gy ** 2)
    cn = torch.sqrt(cx ** 2 + cy ** 2)
    denom = gn * cn
    cos_t = torch.where(denom == 0, 1.0,
                        (gx * cx + gy * cy)
                        / torch.where(denom == 0, 1.0, denom))
    add = cos_t >= 0.5
    keep_grid = ~add & (gE - cE > 0)
    return torch.where(add[..., None], grid_point + charge,
                       torch.where(keep_grid[..., None], grid_point, charge))


def scatter_1d_merge(xabs: torch.Tensor, charge: torch.Tensor,
                     active: torch.Tensor, xmin: float, dx: float, nx: int,
                     periodic: bool) -> torch.Tensor:
    """1D CIC deposit with the sign-merge rule: the contributions of each
    momentum sign (``charge[..., 1] >= 0`` or not) are summed apart, and at
    each node the group with the larger |momentum| wins (the JAX package's
    deterministic form of the reference's sequential merge; for a field of
    one sign it is the additive deposit)."""
    pos = charge[..., 1] >= 0
    S_pos = scatter_1d_add(xabs, charge, active & pos, xmin, dx, nx, periodic)
    S_neg = scatter_1d_add(xabs, charge, active & ~pos, xmin, dx, nx,
                           periodic)
    take_pos = torch.abs(S_pos[..., 1]) >= torch.abs(S_neg[..., 1])
    return torch.where(take_pos[..., None], S_pos, S_neg)
