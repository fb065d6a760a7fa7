"""The design of the redesigned kernels, checked on the CPU.

- K1's compiled tableaux (the header ``ops/cuda_build.py`` writes into the
  build directory) against ``ops/tsit5.py``'s ``METHODS``, float32 bit for
  bit; a changed tableau changes the header and the build's hash, and the
  wrapper refuses a method it does not compile.
- The tiled window sum of K2/K4/K6 (``csrc/pic_gather.cu``: tiles of output
  nodes, sources staged once per strip of dy and chunk of rows, R nodes a
  thread, rows walked from high to low) emulated in numpy float32 against
  the one-thread-per-node loop (``gather_node``) it replaces: equal bit for
  bit, for periodic, open and asymmetric halos, a halo wider than a tile,
  ragged grids and K4's padded output.  numpy float32 rounds each operation
  once, as the kernels do (no FMA contraction).  The emulation forms the CIC
  weights by selects, as the tiled kernels do, and the per-node loop by the
  sum of two selects, as the TPU kernel and ``gather_node`` do.
- The tripolar north seam in the same emulation: a source past the top row
  is a ghost of the mirrored top row (``stage_chunk``), its offsets
  clamped to the declared halo and negated, summed over the widened
  window; tiled and per-node sums equal bit for bit, and both within 1e-5
  of the plain pad-and-fold deposit ``pic.scatter_dense``, displacements
  past the halo included.
- K7's launch constants (``csrc/advance_1d.cu``): the reciprocals of r_g
  and e_T, which the kernel takes from the host in place of an IEEE
  division at every RHS evaluation, are bit for bit ``np.float32(1) /
  np.float32(c)`` of ``make_rhs_consts``' parameters (for several gamma
  and q), and the parameter vector ``advance_1d`` passes carries them,
  float32, at the places the kernel's entry point reads (17 and 18),
  beside the constants it still reads.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from picles_torch import Boundary, GridStats, constant_winds
from picles_torch.ops import advance_cuda as AC
from picles_torch.ops import cuda_build as CB
from picles_torch.forcing.winds import WindKind
from picles_torch.ops.pic import halo_bounds, normalize_halo, scatter_dense
from picles_torch.ops.rhs import TermFlags, make_rhs_consts
from picles_torch.ops.tsit5 import METHODS, SolverConfig

F32 = np.float32
TY = 32  # tile columns, csrc/pic_gather.cu TY


def _f32(v):
    return np.asarray(v, dtype=F32)


def _header_tableaux(text):
    """struct name -> {"c", "a" (rows), "b", "bt"} of a generated header,
    each value the exact float of its literal."""
    out = {}
    for st, body in re.findall(r"struct (\w+) \{(.*?)\n\};", text, re.S):
        for fn, val in re.findall(
                r"float (c|a|b|bt)\(.*?constexpr float v[^=]*= (\{.*?\});",
                body, re.S):
            def nums(x):
                return tuple(float.fromhex(t[:-1]) for t in
                             re.findall(r"-?0x[0-9a-f.]+p[+-]\d+f", x))
            out.setdefault(st, {})[fn] = (
                tuple(nums(r) for r in re.findall(r"\{([^{}]*)\}", val[1:-1]))
                if fn == "a" else nums(val))
    return out


@pytest.mark.parametrize("name", sorted(METHODS))
def test_compiled_tableau_equals_methods_bitwise(name):
    m = METHODS[name]
    comp = _header_tableaux(CB.tableaux_header())[CB.K1_METHODS[name]]
    for k in ("c", "b", "bt"):
        assert np.array_equal(_f32(comp[k]).view(np.uint32),
                              _f32(getattr(m, k)).view(np.uint32)), k
        # the header's literals are float32 values, not wider ones
        assert all(float(F32(v)) == v for v in comp[k]), k
    assert len(comp["a"]) == len(m.a)
    for r, q in zip(comp["a"], m.a):
        assert np.array_equal(_f32(r).view(np.uint32), _f32(q).view(np.uint32))
    assert len(m.b) == len(m.a) + 1 and len(m.bt) == len(m.b) + 1


def test_advance_wrapper_refuses_another_tableau(monkeypatch):
    """A tableau that differs from METHODS' (here in the last bit of one
    coefficient) changes the generated header and the build's hash, so the
    kernel is rebuilt with it; a method the kernel does not compile is
    refused before anything reaches the device."""
    header, h = CB.tableaux_header(), CB.source_hash()
    t5 = METHODS["tsit5"]
    a = list(map(list, t5.a))
    a[2][1] = float(np.nextafter(F32(a[2][1]), F32(0)))
    monkeypatch.setitem(CB.METHODS, "tsit5",
                        t5._replace(a=tuple(map(tuple, a))))
    assert CB.tableaux_header() != header and CB.source_hash() != h
    assert _header_tableaux(CB.tableaux_header())["Tsit5"]["a"][2][1] == a[2][1]
    monkeypatch.setitem(AC.METHODS, "dopri5", t5._replace(name="dopri5"))
    z = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="dopri5"):
        AC.advance_cuda(constant_winds(10.0, 10.0), None, None,
                        SolverConfig(method="dopri5"), 600.0,
                        (z,) * 5, z, z, torch.ones((4, 4), dtype=bool), z, z,
                        (0.0,) * 5)


# ---------------------------------------------------------------------------
# the window sum
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Case:
    nx: int
    ny: int
    halo: object
    periodic: bool
    R: int = 4
    warps: int = 8
    budget: int = 64 * 1024   # bytes of shared memory a block may take
    padded: bool = False      # K4: both axes open, the padded output
    tripolar: bool = False    # x periodic, y folding at the north seam


def _sources(c: Case, seed: int):
    (xl, xh), (yl, yh) = normalize_halo(c.halo)
    rng = np.random.default_rng(seed)
    xr = rng.uniform(-xl - 0.3, xh + 0.3, (c.nx, c.ny)).astype(F32)
    yr = rng.uniform(-yl - 0.3, yh + 0.3, (c.nx, c.ny)).astype(F32)
    ch = rng.normal(0.0, 1.0, (3, c.nx, c.ny)).astype(F32)
    # a non-finite source reaches its whole window through zero weights
    ch[0, c.nx // 2, c.ny // 3] = np.inf
    ch[2, 1, c.ny - 2] = np.nan
    act = rng.uniform(size=(c.nx, c.ny)) < 0.8
    return xr, yr, ch, act


def _weights(p):
    """Floor offset and (floor, ceil) weights of clamped offsets."""
    f = np.floor(p).astype(F32)
    wc = (p - f).astype(F32)
    return f.astype(np.int64), (F32(1.0) - wc).astype(F32), wc


def _geometry(c: Case):
    """The window (widened to the symmetric max(lo, hi) on a tripolar
    grid), the wrapping axes, the output extent and offset."""
    (xl, xh), (yl, yh) = normalize_halo(c.halo)
    if c.tripolar:
        xl = xh = max(xl, xh)
        yl = yh = max(yl, yh)
        return xl, xh, yl, yh, True, False, c.nx, c.ny, 0, 0
    px = py = c.periodic and not c.padded
    if c.padded:
        return (xl, xh, yl, yh, px, py, c.nx + xl + xh, c.ny + yl + yh, xl,
                yl)
    return xl, xh, yl, yh, px, py, c.nx, c.ny, 0, 0


def _index(c, s, px, py):
    """Grid rows/columns (si, sj) wrapped on a periodic axis and, past the
    top row of a tripolar grid, mirrored through the seam (x after its
    wrap); returns (si, sj, valid, ghost)."""
    si, sj = s
    if px:
        si = np.where(si < 0, si + c.nx, np.where(si >= c.nx, si - c.nx, si))
    if py:
        sj = np.where(sj < 0, sj + c.ny, np.where(sj >= c.ny, sj - c.ny, sj))
    ghost = np.zeros(np.shape(sj), bool) | (c.tripolar & (sj >= c.ny))
    sj = np.where(ghost, 2 * c.ny - 1 - sj, sj)
    si = np.where(ghost & (si >= 0) & (si < c.nx), (c.nx - 2 - si) % c.nx, si)
    ok = (si >= 0) & (si < c.nx) & (sj >= 0) & (sj < c.ny)
    return si, sj, ok, ghost


def _source(c, s, v, px, py):
    """Index a source plane at grid rows/columns (si, sj) (``_index``);
    returns (values, valid)."""
    si, sj, ok, _ = _index(c, s, px, py)
    return v[np.clip(si, 0, c.nx - 1), np.clip(sj, 0, c.ny - 1)], ok


def _offsets(c, s, x, y, px, py):
    """A source's offsets as the kernel sums them: clamped to the declared
    halo, a ghost's then negated (no clip to the window after that)."""
    (xl, xh), (yl, yh) = normalize_halo(c.halo)

    def clip(v, lo, hi):
        return np.where(np.isnan(v), v,
                        np.minimum(np.maximum(v, F32(lo)), F32(hi)))

    x, y = clip(x, *halo_bounds(xl, xh)), clip(y, *halo_bounds(yl, yh))
    g = _index(c, s, px, py)[3]
    return np.where(g, -x, x), np.where(g, -y, y)


def per_node_sum(c: Case, xr, yr, ch, act):
    """``gather_node``: per output node, dy ascending outermost, dx
    ascending, a source off an open axis left out."""
    xl, xh, yl, yh, px, py, ox, oy, offx, offy = _geometry(c)
    i = np.arange(ox)[:, None] - offx + np.zeros((1, oy), np.int64)
    j = np.arange(oy)[None, :] - offy + np.zeros((ox, 1), np.int64)
    acc = np.zeros((3, ox, oy), F32)
    for dy in range(-yl, yh + 1):
        a = np.zeros((3, ox, oy), F32)
        for dx in range(-xl, xh + 1):
            s = (i - dx, j - dy)
            x, ok = _source(c, s, xr, px, py)
            y, _ = _source(c, s, yr, px, py)
            x, y = _offsets(c, s, x, y, px, py)
            m = np.where(_source(c, s, act, px, py)[0], F32(1), F32(0))
            fx, wxf, wxc = _weights(x)
            fy, wyf, wyc = _weights(y)
            wx = (np.where(fx == dx, wxf, F32(0))
                  + np.where(fx == dx - 1, wxc, F32(0))).astype(F32)
            wy = (np.where(fy == dy, wyf, F32(0))
                  + np.where(fy == dy - 1, wyc, F32(0))).astype(F32)
            for k in range(3):
                t = wx * (wy * (_source(c, s, ch[k], px, py)[0] * m))
                a[k] = np.where(ok, a[k] + t, a[k])
        acc = acc + a
    return acc


def plan(c: Case, xl, xh, yl, yh):
    """``plan_sum``: rows a tile, dy a strip, rows a chunk, row stride."""
    cap = c.budget // 32
    tx = c.R * c.warps
    rows, dys = tx + xl + xh, yl + yh + 1
    if rows * (TY + dys - 1) <= cap:
        d, ux = dys, rows
    elif rows * TY <= cap:
        d, ux = cap // rows - TY + 1, rows
    else:
        d, ux = 1, cap // TY
    return tx, d, ux


def tiled_sum(c: Case, xr, yr, ch, act):
    """The tiled window sum, block by block, with the block's threads as
    arrays [warps (threadIdx.y), 32 (threadIdx.x)]."""
    xl, xh, yl, yh, px, py, ox, oy, offx, offy = _geometry(c)
    R, W = c.R, xl + xh + 1
    tx, d, ux = plan(c, xl, xh, yl, yh)
    rows = tx + xl + xh
    ty = np.arange(c.warps)[:, None]
    lx = np.arange(TY)[None, :]
    out = np.zeros((3, ox, oy), F32)
    pieces = set()
    for p0 in range(0, ox, tx):
        for q0 in range(0, oy, TY):
            i0, j0 = p0 - offx, q0 - offy
            acc = np.zeros((R, 3, c.warps, TY), F32)
            a = np.zeros_like(acc)
            for dy0 in range(-yl, yh + 1, d):
                dy1 = min(dy0 + d - 1, yh)
                hi = rows
                while hi > 0:
                    lo = max(hi - ux, 0)
                    pieces.add((lo, hi, dy0))
                    # stage_chunk: copy (zero fill off an open axis), then
                    # each source's weights and c_k * m once
                    w = TY + dy1 - dy0
                    u = np.arange(lo, hi)[:, None]
                    s = (i0 - xh + u + 0 * np.arange(w)[None, :],
                         j0 - dy1 + np.arange(w)[None, :] + 0 * u)
                    x, ok = _source(c, s, xr, px, py)
                    y = np.where(ok, _source(c, s, yr, px, py)[0], F32(0))
                    x = np.where(ok, x, F32(0))
                    x, y = _offsets(c, s, x, y, px, py)
                    m = np.where(ok & _source(c, s, act, px, py)[0], F32(1),
                                 F32(0))
                    fx, _, wxc = _weights(x)
                    fy, _, wyc = _weights(y)
                    cm = [np.where(ok, _source(c, s, ch[k], px, py)[0],
                                   F32(0)) * m for k in range(3)]
                    # sum_chunk
                    base = R * ty
                    top = base + R + xl + xh - 1
                    for dy in range(dy0, dy1 + 1):
                        if hi == rows:
                            a[:] = 0
                        col = lx - dy + dy1
                        for st in range(R + xl + xh):
                            uu = top - st
                            live = (uu >= max(lo, 0)) & (uu < hi) & (uu >= base)
                            e = (np.clip(uu - lo, 0, hi - lo - 1), col)
                            wxc_, wyc_ = wxc[e], wyc[e]
                            wxf_, wyf_ = F32(1) - wxc_, F32(1) - wyc_
                            fy_ = fy[e]
                            # selects, as the kernel forms the weights
                            wy = np.where(fy_ == dy, wyf_,
                                          np.where(fy_ == dy - 1, wyc_,
                                                   F32(0)))
                            q = [wy * cm[k][e] for k in range(3)]
                            ex = fx[e] - (st + 1 - R - xl)
                            for r in range(R):
                                holds = live & (st >= R - 1 - r) & \
                                    (st <= R - 2 - r + W)
                                wx = np.where(ex == r, wxf_,
                                              np.where(ex == r - 1, wxc_,
                                                       F32(0)))
                                for k in range(3):
                                    a[r, k] = np.where(holds,
                                                       a[r, k] + wx * q[k],
                                                       a[r, k])
                        if lo == 0:
                            acc = acc + a
                    hi -= ux
            for r in range(R):
                pi = p0 + R * ty + r + 0 * lx
                qj = q0 + lx + 0 * ty
                keep = (pi < ox) & (qj < oy)
                out[:, pi[keep], qj[keep]] = acc[r][:, keep]
    return out, tx, d, ux, len(pieces)


CASES = {
    # the flagship's halo, a ragged grid (not a multiple of TX or TY)
    "flagship_halo_periodic": Case(40, 45, ((0, 3), (0, 3)), True, R=4,
                                   warps=2),
    "halo3_periodic_R2": Case(37, 70, 3, True, R=2, warps=4),
    "asymmetric_open_R8": Case(33, 50, ((1, 2), (2, 1)), False, R=8,
                               warps=2),
    # the budget holds the tile's rows for 3 of the 7 dy: strips of dy
    "halo3_open_y_strips": Case(21, 35, 3, False, R=4, warps=2,
                                budget=14 * 32 * 34),
    # a halo wider than a tile, and one dy's rows do not fit: row chunks
    "wide_halo_row_chunks": Case(19, 23, 9, False, R=2, warps=2,
                                 budget=9 * 32 * 32),
    # the halo equals the grid on a periodic axis
    "halo_equals_grid_periodic": Case(6, 5, 5, True, R=4, warps=2),
    # K4: the padded accumulator, both axes open
    "padded_flagship_halo": Case(26, 40, ((0, 3), (0, 3)), False, R=4,
                                 warps=2, padded=True),
    "padded_asymmetric_chunks": Case(17, 20, ((1, 3), (0, 2)), False, R=2,
                                     warps=2, budget=4 * 32 * 32,
                                     padded=True),
    # the tripolar seam: the flagship's halo (a 7-wide window), halo 3 and
    # the sharded tests' seam halo, on ragged grids; strips of dy
    "tripolar_flagship_halo": Case(40, 45, ((0, 3), (0, 3)), True, R=4,
                                   warps=2, tripolar=True),
    "tripolar_halo3": Case(26, 37, 3, True, R=2, warps=4, tripolar=True),
    "tripolar_seam_halo_strips": Case(22, 35, ((2, 3), (1, 3)), True, R=4,
                                      warps=2, budget=14 * 32 * 34,
                                      tripolar=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiled_window_sum_equals_per_node_loop_bitwise(name):
    c = CASES[name]
    xr, yr, ch, act = _sources(c, seed=len(name))
    with np.errstate(invalid="ignore"):   # inf * 0 is NaN, as on the card
        want = per_node_sum(c, xr, yr, ch, act)
        got, tx, d, ux, n_pieces = tiled_sum(c, xr, yr, ch, act)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
        int((got.view(np.uint32) != want.view(np.uint32)).sum())
    xl, xh, yl, yh = _geometry(c)[:4]
    # the case cuts the window the way its name says
    if "strips" in name:
        assert 1 < d < yl + yh + 1 and ux == tx + xl + xh
    if "chunks" in name:
        assert d == 1 and ux < tx + xl + xh
    if "wide" in name:
        assert xl + xh > tx
    if not ("strips" in name or "chunks" in name):
        assert n_pieces == 1
    assert (c.nx + (xl + xh if c.padded else 0)) % tx != 0 or \
        (c.ny + (yl + yh if c.padded else 0)) % TY != 0
    assert not np.isfinite(want).all()


@pytest.mark.parametrize("name", sorted(k for k in CASES if "tripolar" in k))
def test_tripolar_seam_gather_matches_pad_and_fold(name):
    """The emulated seam gather against ``pic.scatter_dense``'s fold (the
    north halo rows added onto the top rows with x mirrored) on finite
    sources: within rtol 1e-5 and 1e-6 of each channel's scale, as the
    kernels are held on the card; the mirrored rows do receive deposits."""
    c = CASES[name]
    xr, yr, ch, act = _sources(c, seed=len(name))
    ch = np.nan_to_num(ch, nan=0.5, posinf=2.0)
    got = per_node_sum(c, xr, yr, ch, act)
    stats = GridStats(nx=c.nx, ny=c.ny, bx=Boundary.PERIODIC,
                      by=Boundary.TRIPOLAR_NORTH)
    S, _ = scatter_dense(torch.as_tensor(xr), torch.as_tensor(yr),
                         torch.as_tensor(np.moveaxis(ch, 0, -1)),
                         torch.as_tensor(act), stats, c.halo)
    want = np.moveaxis(S.numpy(), -1, 0)
    for k in range(3):
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=1e-6 * scale)
    # without the ghosts the top rows would miss what crosses the seam
    c0 = dataclasses.replace(c, tripolar=False, periodic=False)
    (xl, xh), (yl, yh) = normalize_halo(c.halo)
    assert not np.allclose(per_node_sum(c0, xr, yr, ch, act)[0][:, -yh:],
                           want[0][:, -yh:], rtol=1e-3)


@pytest.mark.parametrize("gamma,q", [(0.88, -0.25), (0.85, -0.25),
                                     (0.88, -0.3)])
def test_k7_host_reciprocals_equal_the_card_division_bitwise(gamma, q):
    """K7 takes 1 / r_g and 1 / e_T from the host: float32 quotients of the
    float32 constants, as the card's IEEE division rounds them, at the
    float32 parameters 17 and 18 the entry point reads; the constants
    themselves stay at 0 and 6."""
    c = make_rhs_consts(gamma=gamma, q=q)
    inv_rg, inv_eT = AC.k7_reciprocals(c)
    for got, v in ((inv_rg, c.r_g), (inv_eT, c.e_T)):
        want = np.float32(1.0) / np.float32(v)
        assert np.float32(got).view(np.int32) == want.view(np.int32)
    for kind in (WindKind.NODE, WindKind.TRACED):
        for method in ("bosh3", "tsit5"):
            fp, ip = AC.k7_params(c, TermFlags(), SolverConfig(method=method),
                                  600.0, kind, None)
            assert fp.dtype == np.float32 and fp.size == 19
            assert fp[17].view(np.int32) == (np.float32(1.0) / np.float32(
                c.r_g)).view(np.int32)
            assert fp[18].view(np.int32) == (np.float32(1.0) / np.float32(
                c.e_T)).view(np.int32)
            assert (fp[0], fp[6]) == (np.float32(c.r_g), np.float32(c.e_T))
            assert ip[1] == int(kind) and ip[6] == len(METHODS[method].b)
            # the default flags select K7's compiled instance (every term
            # the 1D RHS reads: bits 1, 2, 4, 8)
            assert ip[0] & 15 == 15
